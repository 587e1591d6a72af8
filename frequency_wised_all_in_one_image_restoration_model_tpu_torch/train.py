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

The CLI default ``--degradation_embedding_method residual`` is not ported
yet: the flagship needs ``--degradation_embedding_method all_DC``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import config as config_lib
from .training.loop import run_training
from .training.state import TrainState


def main(cfg: config_lib.Config, device=None, startpoint: int = 0,
         progress: Optional[Callable[[int, Dict], None]] = None,
         state: Optional[TrainState] = None) -> TrainState:
    """Run the training; returns the final state. ``device=None`` is
    ``cuda:<cfg.cuda>``, and there is no quiet CPU run: without a card it
    raises. Pass ``device="cpu"`` to run the kernels' plain twins."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's training runs on an NVIDIA GPU; "
                "pass device='cpu' to main() to run the plain PyTorch path")
        device = torch.device("cuda", cfg.cuda)
    return run_training(cfg, startpoint=startpoint, progress=progress,
                        device=torch.device(device), state=state)


if __name__ == "__main__":
    main(config_lib.parse_args())
