"""The two-phase training loop (the port of the JAX ``training/loop.py``;
reference train.py:21-164).

Phase A (epoch < epochs_encoder) trains the contrastive encoder only; phase
B trains the joint objective; per-epoch loss lines go to ``train.log``; from
phase B on, every epoch runs the full per-task eval and appends to
``results.log`` (train.py:131-140); the LR staircase is applied at epoch
boundaries (train.py:142-149); a checkpoint lands at the final epoch
(train.py:120-129), plus optional periodic checkpoints and the best-PSNR
one, all with the full state for a real resume.

Under a process group of ``mesh_data * mesh_task`` ranks (``train.main``
starts them, ``parallel/distributed.py``) every rank draws the global batch
of ``mesh_data`` loader batches and steps on its rows; the state starts
equal on every rank (rank 0's, broadcast) and the steps keep it so. Rank 0
writes the logs, prints and the checkpoints (the others wait at a barrier);
the loss lines read the metrics averaged over the ranks; the eval splits
its tiles over the ranks and rank 0's mean PSNR, broadcast, decides the
best checkpoint on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import check_uformer_window_compat
from ..evaluation import runner as eval_runner
from ..models.airnet import ModelBundle, build_models
from ..parallel import distributed, mesh as mesh_lib
from ..utils.logging import RunLogs
from ..utils.profiling import StepMeter
from . import checkpoint as ckpt_lib
from .state import TrainState, create_train_state, lr_for_epoch, with_learning_rate
from .steps import array_batch, train_steps


def build_train_loader(cfg, seed: int = 0, prefetch: bool = False):
    if cfg.synthetic_data:
        from ..data.synthetic import SyntheticTrainLoader
        loader = SyntheticTrainLoader(cfg, seed=seed)
    else:
        from ..data.datasets import FileTrainLoader
        loader = FileTrainLoader(cfg, seed=seed)
    if prefetch:
        from ..data.prefetch import Prefetcher
        loader = Prefetcher(loader)
    return loader


def evaluate(cfg, bundle: ModelBundle, logs: Optional[RunLogs],
             epoch: int) -> Optional[float]:
    """The per-task eval of the models as they stand (query encoder, running
    BatchNorm statistics; reference eval uses encoder_q, moco.py:167-170)
    into ``results.log``; returns the mean PSNR. The models are put in eval
    mode for it and back in train mode after. Under a process group every
    rank runs its share of the tiles, rank 0 (``logs``) scores and logs,
    and every rank returns rank 0's mean."""
    if logs is not None:
        logs.log_results_header(epoch)
    bundle.encoder.eval()
    bundle.decoder.eval()
    try:
        psnrs = []
        for task in cfg.test_de_type:
            result = eval_runner.test_by_task(cfg, bundle, task, epochs=epoch)
            if result is not None:
                logs.log_result(task, result)
                psnrs.append(float(result.split(": ")[1].split("/")[0]))
    finally:
        bundle.encoder.train()
        bundle.decoder.train()
    return distributed.broadcast_value(
        sum(psnrs) / len(psnrs) if psnrs else None)


def run_training(cfg, startpoint: int = 0,
                 progress: Optional[Callable[[int, Dict], None]] = None,
                 device=None, state: Optional[TrainState] = None) -> TrainState:
    """Full training run on ``device``; returns the final state. ``state``
    (built around a train-mode bundle on ``device``) starts the run from
    other weights than the seed's; ``startpoint > 0`` resumes from
    ``<ckpt_path>/epoch_<startpoint>.pt``. Under a process group this
    process is one rank of ``mesh_data * mesh_task`` (the group's size);
    ``progress`` is called on rank 0."""
    check_uformer_window_compat(cfg)  # fail fast, not at first eval
    if device is None:
        raise ValueError("run_training needs a device (train.main picks it)")
    # the layout of the ranks; raises when the group holds another number
    mesh_lib.make_mesh(cfg.mesh_data, cfg.mesh_task, distributed.model_axis(),
                       device_type=torch.device(device).type)
    main = distributed.is_main()
    global_batch = cfg.mesh_data * cfg.batch_size
    logs = RunLogs(cfg) if main else None
    if state is None:
        bundle = build_models(cfg, device, eval_mode=False)
        state = create_train_state(cfg, bundle)
    else:
        bundle = ModelBundle(cfg=cfg, encoder=state.encoder,
                             decoder=state.decoder)
    loader = build_train_loader(cfg, seed=cfg.seed, prefetch=True)

    def next_batch():
        """This rank's rows of the global batch: ``mesh_data`` loader
        batches joined, as every rank draws them."""
        return distributed.shard_global_batch(mesh_lib.concat_batches(
            [loader.next_batch() for _ in range(cfg.mesh_data)]))

    try:
        # the JAX loop draws its first global batch to initialise the
        # models; the draw is kept so that both loops train on the same
        # batches
        next_batch()
        if startpoint > 0:
            state = ckpt_lib.restore(cfg.ckpt_path, startpoint, state)
        mesh_lib.replicate_state(state)
        enc_step, joint_step = train_steps(cfg, bundle)

        steps_per_epoch = (cfg.steps_per_epoch if cfg.steps_per_epoch is not None
                           else getattr(loader, "steps_per_epoch", lambda: 400)())
        if main:
            print("loading %s data pairs in total." % str(
                getattr(loader, "total_pairs",
                        lambda: steps_per_epoch * len(cfg.de_type))()))
            print("Start training...")

        meter = StepMeter(batch=global_batch, patch=cfg.patch_size, every=100,
                          device=device)
        retention = ckpt_lib.RetentionPolicy(cfg.ckpt_path, every=cfg.ckpt_every)

        for epoch in range(cfg.epochs):
            if epoch < startpoint:
                continue
            state = with_learning_rate(state, lr_for_epoch(cfg, epoch))
            step_fn = enc_step if epoch < cfg.epochs_encoder else joint_step
            m = {}
            for _ in range(steps_per_epoch):
                state, m = step_fn(state, array_batch(next_batch(), device))
                stats = meter.step()
                if stats and main:
                    print("  throughput: %.2f steps/s, %.1f samples/s" % (
                        stats["steps_per_sec"], stats["samples_per_sec"]))

            # numerics tripwire at the epoch boundary, where the values cross
            # to the host anyway (averaged over the ranks): fail loudly
            # instead of training on NaNs
            m = distributed.mean_over_ranks(m)
            for k in ("loss", "l1_loss", "contrast_loss"):
                if k in m and not np.isfinite(m[k]):
                    raise FloatingPointError(
                        f"non-finite {k}={m[k]} at epoch {epoch}; restart from "
                        "the last checkpoint")

            if logs is not None:
                if epoch < cfg.epochs_encoder:
                    logs.log_epoch_encoder(epoch, m["contrast_loss"])
                else:
                    logs.log_epoch_joint(epoch, m["l1_loss"], m["contrast_loss"])
            if progress is not None and main:
                progress(epoch, m)

            if epoch + 1 == cfg.epochs and main:
                ckpt_lib.save(cfg.ckpt_path, epoch + 1, state)

            mean_psnr = None
            if epoch >= cfg.epochs_encoder:
                mean_psnr = evaluate(cfg, bundle, logs, epoch + 1)
            if main:
                retention.maybe_save(epoch, state, mean_psnr)
            distributed.barrier()  # every checkpoint written before any rank goes on
    finally:
        loader.close()
        if logs is not None:
            logs.close()
    return state
