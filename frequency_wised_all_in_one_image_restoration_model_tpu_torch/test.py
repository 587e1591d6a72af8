"""CLI eval entry point of the port, the flag surface of the reference
``test.py``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.test \\
        --synthetic_data --degradation_embedding_method all_DC \\
        --test_de_type denoising_bsd68_25 deraining --output_path out/

Evaluates every ``--test_de_type`` task with tiled inference on CUDA device
``--cuda`` and writes ``<output_path>/epoch_<N>_results.log`` in the
reference's format. Loads ``<output_path>/ckpt/epoch_<N>.pt`` for
``--epochs N`` if it exists, else the newest ``epoch_*.pt`` there
(``training/checkpoint.py`` has the format), else runs on weights drawn
from ``--seed``, as the JAX package's CLI does.

With ``--mesh_data`` / ``--mesh_task`` above 1 the eval runs on that many
ranks, one a card (``parallel/distributed.py``: this process starts them,
or with ``--coordinator_address`` / ``--num_processes`` / ``--process_id``
one process a host starts its share): the pooled tiles are split over the
ranks and rank 0 scores and writes the log.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import config as config_lib
from .evaluation import runner as eval_runner
from .models.airnet import build_models
from .parallel import distributed, mesh as mesh_lib
from .training import checkpoint as ckpt_lib
from .utils.logging import write_epoch_results_log


def main(cfg: config_lib.Config, device=None) -> List[Tuple[str, str]]:
    """Run the evaluation; returns the ``(task, result line)`` rows it
    logged. ``device=None`` is ``cuda:<cfg.cuda>``, and there is no quiet
    CPU run: without a card it raises. Pass ``device="cpu"`` to run the
    kernels' plain twins (and, with a mesh, gloo ranks on the CPU). With a
    mesh of more than one rank and no process group yet, it starts the
    ranks and returns rank 0's rows; a rank other than 0 returns none."""
    # weights are made at patch_size and applied to crop_test_imgs_size
    # tiles: fail fast if the Uformer window clamps differ (config.py)
    config_lib.check_uformer_window_compat(cfg)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's eval runs on an NVIDIA GPU; pass "
                "device='cpu' to main() to run the plain PyTorch path")
        device = torch.device("cuda", cfg.cuda)
    if distributed.needs_spawn(cfg):
        config_lib.check_ported(cfg)
        return distributed.spawn(_eval_rank, cfg, device)[0]
    return _eval_rank(cfg, device)


def _eval_rank(cfg: config_lib.Config, device) -> List[Tuple[str, str]]:
    """The evaluation in this process (a rank, or the one process)."""
    # the layout of the ranks; raises when a group holds another number
    mesh_lib.make_mesh(cfg.mesh_data, cfg.mesh_task,
                       device_type=torch.device(device).type)
    main_rank = distributed.is_main()
    bundle = build_models(cfg, device)
    epoch = ckpt_lib.select_eval_epoch(cfg.ckpt_path, cfg.epochs)
    if epoch is not None:
        if epoch != cfg.epochs and main_rank:
            print(f"checkpoint epoch_{cfg.epochs} not found; "
                  f"falling back to latest epoch_{epoch}")
        ckpt_lib.restore_eval(cfg.ckpt_path, epoch, bundle)
        if main_rank:
            print(f"loaded checkpoint epoch_{epoch}")

    rows = []
    for task in cfg.test_de_type:
        if main_rank:
            print("starting testing %s..." % task)
        result = eval_runner.test_by_task(cfg, bundle, task, epochs=cfg.epochs)
        if result is not None:
            print(result)
            rows.append((task, result))
    if main_rank:
        path = write_epoch_results_log(cfg, cfg.epochs, rows)
        print("wrote", path)
    return rows


if __name__ == "__main__":
    main(config_lib.parse_args())
