"""Per-task evaluation runner (the port of the JAX ``evaluation/runner.py``;
``test_by_task`` of the reference, test.py:17-84).

Per task: build the test set, tile each image, run the tiles of up to
``pool_tiles`` same-shaped images through the eval forward, overlap-average
stitch, PSNR / SSIM on the bundle's device into AverageMeters (only the two
floats of an image cross to the host), optional restored-image dump, and
the reference's exact result string ``"PSNR/SSIM: %.2f/%.4f"``.

The pooled tiles go through the forward in chunks of ``chunk`` (32, as
``tiling.restore_image``), the ragged last chunk as it is: eval has no
state across a batch (the all_DC gain is per image), so the result does not
depend on the chunk, and PyTorch compiles nothing per shape.

Under a process group (``parallel/distributed.py``) rank 0 reads the test
set and hands each pool of tiles to every rank; the pool is wrap-padded to a
multiple of the ranks, each rank runs its block of it in its chunks, the
results are gathered in rank order and the pad dropped, and rank 0
stitches, scores and logs (the JAX package's tile-sharded eval,
``runner.py:80-108``). The other ranks return no result.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.airnet import ModelBundle, eval_forward
from ..ops import metrics
from ..parallel import distributed, mesh as mesh_lib
from . import tiling


def forward_tiles(bundle: ModelBundle, tiles: Optional[np.ndarray],
                  chunk: int = 32) -> Optional[torch.Tensor]:
    """The eval forward of a pool of tiles ``[n, P, P, 3]`` in chunks of
    ``chunk``. Under a process group every rank calls it, rank 0 with the
    tiles and the others with ``None`` (their share comes from rank 0; a
    ``None`` from rank 0 ends the eval and gives ``None``): the pool
    wrap-padded to a multiple of the batch groups (the ranks, without a
    ``model`` axis), the block of this rank's batch index forwarded, the
    blocks gathered in that order and the pad dropped."""
    if distributed.active():
        tiles = distributed.broadcast_value(tiles)
        if tiles is None:
            return None
    n = tiles.shape[0]
    groups = distributed.batch_groups()
    pad = (-n) % groups
    if pad:  # wrap-pad (the pad may exceed n with many ranks)
        tiles = np.concatenate([tiles, np.take(tiles, np.arange(pad) % n,
                                               axis=0)])
    x = torch.from_numpy(tiles[mesh_lib.rows_of(
        n + pad, distributed.batch_index(), groups)]).to(bundle.device)
    restored = torch.cat([eval_forward(bundle, x[o:o + chunk])
                          for o in range(0, x.shape[0], chunk)])
    return distributed.all_gather_rows(restored)[:n]


def restored_images(cfg: Config, bundle: ModelBundle, dataset: Iterable,
                    pool_tiles: int = 4, chunk: int = 32
                    ) -> Iterator[Tuple[str, torch.Tensor, np.ndarray]]:
    """``(name, restored [H, W, 3] float32 on the bundle's device, clean)``
    for every ``(name, degraded, clean)`` float01 HWC item of ``dataset``,
    in order. Tiles of up to ``pool_tiles`` images with the same tile grid
    are pooled into one batch (mixed-size datasets flush per image). Under
    a process group rank 0 passes the dataset and yields; another rank
    passes ``None``, runs its share of every pool and yields nothing."""
    patch = cfg.crop_test_imgs_size
    assert patch % 8 == 0, "patch size should be a multiple of window_size"  # test.py:44
    if dataset is None:
        while forward_tiles(bundle, None, chunk) is not None:
            pass
        return

    def flush(group):
        tiles = np.concatenate([t[:n] for _, t, _, n, _ in group])
        restored = forward_tiles(bundle, tiles, chunk)
        off = 0
        for name, _, offs, n, clean in group:
            yield name, tiling.stitch_tiles(restored[off:off + n], offs, n,
                                            clean.shape[0],
                                            clean.shape[1]), clean
            off += n

    try:
        group, group_shape = [], None
        for name, degraded, clean in dataset:
            tiles, offs, n = tiling.extract_tiles(
                np.asarray(degraded, np.float32), patch)
            if group and (len(group) >= pool_tiles
                          or group_shape != tiles.shape):
                yield from flush(group)
                group = []
            group_shape = tiles.shape
            group.append((name, tiles, offs, n, clean))
        if group:
            yield from flush(group)
    finally:
        if distributed.active():
            distributed.broadcast_value(None)  # the other ranks stop


def psnr_ssim(restored: torch.Tensor, clean: np.ndarray) -> Tuple[float, float]:
    """One image's PSNR and SSIM, computed where ``restored`` lies."""
    ref = torch.from_numpy(np.asarray(clean, np.float32)).to(restored.device)
    return (float(metrics.psnr(restored[None], ref[None])[0]),
            float(metrics.ssim(restored[None], ref[None])[0]))


def test_by_task(cfg: Config, bundle: ModelBundle, task: str, epochs: int,
                 dataset: Optional[Iterable] = None, pool_tiles: int = 4,
                 chunk: int = 32) -> Optional[str]:
    """Evaluate one task; returns the reference's result line
    (test.py:80-84). ``dataset`` yields ``(name, degraded, clean)`` float01
    HWC numpy arrays (default: the task's synthetic or file-backed set).
    Under a process group every rank calls it; rank 0 reads the set,
    scores and returns the line, the others return ``None``."""
    if not distributed.is_main():
        for _ in restored_images(cfg, bundle, None, pool_tiles, chunk):
            pass
        return None
    if dataset is None:
        dataset = build_test_dataset(cfg, task)
    psnr_meter = metrics.AverageMeter()
    ssim_meter = metrics.AverageMeter()

    save_dir = None
    if cfg.save_imgs:
        save_dir = os.path.join(cfg.output_path, f"epoch_{epochs}_imgs",
                                f"test_{task}")
        os.makedirs(save_dir, exist_ok=True)

    for name, restored, clean in restored_images(cfg, bundle, dataset,
                                                 pool_tiles, chunk):
        p, s = psnr_ssim(restored, clean)
        psnr_meter.update(p, 1)
        ssim_meter.update(s, 1)
        if save_dir is not None:
            from ..utils.image_io import save_image_float01
            save_image_float01(restored.cpu().numpy(),
                               os.path.join(save_dir, name + ".png"))

    return "PSNR/SSIM: %.2f/%.4f" % (psnr_meter.avg, ssim_meter.avg)


test_by_task.__test__ = False  # a runner, not a pytest case


def build_test_dataset(cfg: Config, task: str):
    """Synthetic or file-backed test set for one task."""
    if cfg.synthetic_data:
        from ..data.synthetic import SyntheticTestSet
        return SyntheticTestSet(cfg, task, seed=cfg.seed)
    from ..data.datasets import FileTestDataset
    return FileTestDataset(cfg, task)
