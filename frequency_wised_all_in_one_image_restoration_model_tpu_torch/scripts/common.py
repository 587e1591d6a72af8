"""The setup the CLIs share: the device, the bundle with the newest
checkpoint, the train loader."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.airnet import ModelBundle, build_models
from ..models.encoder_uformer import DegradationContext
from ..training import checkpoint as ckpt_lib
from ..training.loop import build_train_loader


def device_of(device=None, index: int = 0) -> torch.device:
    """``device``, or CUDA device ``index`` for None; without a card that
    raises, as the eval CLI does (there is no quiet CPU run)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's analysis runs on an NVIDIA GPU; "
                "pass device='cpu' to main() to run the plain PyTorch path")
        return torch.device("cuda", index)
    return torch.device(device)


def setup(cfg, device: torch.device, restore: bool = True
          ) -> Tuple[ModelBundle, object]:
    """The eval bundle (``cfg.eval_dtype``, weights from ``cfg.seed``, then
    the newest ``<ckpt_path>/epoch_<N>.pt`` where ``restore`` and one
    exists) and the train loader, its first batch drawn as the JAX scripts
    draw it to initialise their train state."""
    bundle = build_models(cfg, device)
    loader = build_train_loader(cfg, seed=cfg.seed)
    loader.next_batch()
    epoch = ckpt_lib.latest_epoch(cfg.ckpt_path) if restore else None
    if epoch is not None:
        ckpt_lib.restore_eval(cfg.ckpt_path, epoch, bundle)
    return bundle, loader


def images(x, device: torch.device) -> torch.Tensor:
    """Images ``[B, H, W, 3]`` (host arrays or tensors) as a float32 tensor
    on ``device``."""
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def features(bundle: ModelBundle, x) -> object:
    """The encoder's conditioning of images ``x``."""
    with torch.inference_mode():
        return bundle.encoder.features(images(x, bundle.device))


def spatial_inter(bundle: ModelBundle, x, ctx: Optional[object] = None
                  ) -> np.ndarray:
    """The encoder's spatial degradation map of images ``x`` as host
    ``[B, H, W, C]`` float32: band 0 of the Uformer encoder's bottleneck
    as a square grid, or the other encoders' map
    (plot_frequency_distribution_3.py)."""
    ctx = features(bundle, x) if ctx is None else ctx
    t = ctx.band_inter[0] if isinstance(ctx, DegradationContext) else ctx
    t = t.float().cpu().numpy()
    if t.ndim == 3:
        side = math.isqrt(t.shape[1])
        t = t.reshape(-1, side, side, t.shape[-1])
    return t
