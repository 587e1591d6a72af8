"""CLI training entry point of the port, the flag surface of the reference
``train.py``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.train \\
        --synthetic_data --degradation_embedding_method all_DC \\
        --de_type 4tasks --epochs 4 --epochs_encoder 2 --steps_per_epoch 50 \\
        --output_path out/

Trains on CUDA device ``--cuda`` in ``--dtype`` (bfloat16 by default;
parameters and Adam's state float32): phase A (contrastive, encoder only)
for ``--epochs_encoder`` epochs, then the joint phase, writing
``train.log`` / ``options.log`` / ``results.log`` under ``--output_path`` in
the reference's formats and the checkpoints ``ckpt/epoch_<N>.pt`` (the final
epoch, every ``--ckpt_every`` epochs) and ``ckpt/best.pt``, each with the
whole train state. ``--remat`` is accepted and changes nothing: the block
kernels' backward recomputes by construction.

Every model family of the flags trains: ``--encoder_type ResNet
--decoder_type ResNet`` and ``--encoder_type ViT --decoder_type ResNet``
as well as the Uformer pair with any ``--degradation_embedding_method``.

``--mesh_data D --mesh_task T`` trains on ``D * T`` ranks, one a card
(``parallel/distributed.py``), on a global batch of ``D`` loader batches:
one process starts them all, or with ``--coordinator_address host:port
--num_processes P --process_id p`` each of ``P`` processes (one a host)
starts its share. The step on the ranks equals the one-device step on the
global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import config as config_lib
from .parallel import distributed
from .training import checkpoint as ckpt_lib
from .training.loop import run_training
from .training.state import TrainState


def main(cfg: config_lib.Config, device=None, startpoint: int = 0,
         progress: Optional[Callable[[int, Dict], None]] = None,
         state: Optional[TrainState] = None) -> TrainState:
    """Run the training; returns the final state. ``device=None`` is
    ``cuda:<cfg.cuda>``, and there is no quiet CPU run: without a card it
    raises. Pass ``device="cpu"`` to run the kernels' plain twins (and,
    with a mesh, gloo ranks on the CPU). With a mesh of more than one rank
    and no process group yet, it starts the ranks (``state`` goes to them
    as its tree; ``progress``, called on rank 0, must then be picklable)
    and returns rank 0's final state, read back from its last checkpoint
    onto ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's training runs on an NVIDIA GPU; "
                "pass device='cpu' to main() to run the plain PyTorch path")
        device = torch.device("cuda", cfg.cuda)
    device = torch.device(device)
    if not distributed.needs_spawn(cfg):
        return run_training(cfg, startpoint=startpoint, progress=progress,
                            device=device, state=state)
    config_lib.check_ported(cfg)
    tree = None if state is None else ckpt_lib.state_tree(state)
    distributed.spawn(_train_rank, cfg, device, startpoint, progress, tree)
    # rank 0's final state is its last checkpoint
    if state is None:
        state = _state_of(cfg, device, None)
    return ckpt_lib.restore(cfg.ckpt_path, max(cfg.epochs, startpoint), state)


def _state_of(cfg: config_lib.Config, device, tree) -> TrainState:
    """A train state of ``cfg`` on ``device``, from the seed or holding
    ``tree``'s values."""
    from .models.airnet import build_models
    from .training.state import create_train_state

    state = create_train_state(cfg, build_models(cfg, device, eval_mode=False))
    if tree is not None:
        ckpt_lib.load_state_tree(state, tree)
    return state


def _train_rank(cfg: config_lib.Config, device, startpoint: int, progress,
                tree) -> None:
    """One rank's training."""
    run_training(cfg, startpoint=startpoint, progress=progress, device=device,
                 state=None if tree is None else _state_of(cfg, device, tree))


if __name__ == "__main__":
    main(config_lib.parse_args())
