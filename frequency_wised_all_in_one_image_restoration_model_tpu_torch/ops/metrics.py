"""Image quality metrics on the bundle's device (PSNR / SSIM), the
Gaussian-window SSIM loss ``ssim_gaussian`` and ``AverageMeter`` (the port
of the JAX ``ops/metrics.py``).

The reference ships every restored image to the CPU and calls skimage
(utils/val_utils.py:50-66). Here both metrics are tensor code that runs
where the restored image lies; the numerics replicate skimage's defaults so
scores are directly comparable:

* PSNR: ``10*log10(data_range^2 / mse)`` over the whole image
  (skimage.metrics.peak_signal_noise_ratio with data_range=1).
* SSIM: skimage.metrics.structural_similarity defaults: uniform 7x7 window,
  K1=0.01, K2=0.03, sample covariance (N/(N-1)), per channel then averaged,
  scores averaged over the valid interior (skimage crops ``(win-1)//2``
  borders, so VALID-mode windows are computed directly).

Metrics must be exact: they run in float32, and the window filter runs with
TF32 off (a float32 convolution on the card goes through TF32 by default,
which keeps three decimal digits). The caller's TF32 flags are put back
after the call.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions inside the block; the flags
    the caller had are restored on the way out."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _clipped(img: torch.Tensor, data_range: float) -> torch.Tensor:
    return img.float().clamp(0.0, data_range)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR. ``pred/target: [B, H, W, C]`` -> ``[B]``.

    Inputs are clipped to [0, data_range] first, exactly as the reference
    does before calling skimage (val_utils.py:52-53).
    """
    diff = _clipped(pred, data_range) - _clipped(target, data_range)
    mse = (diff * diff).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10((data_range * data_range) / mse.clamp_min(1e-12))


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """VALID-mode uniform ``win x win`` mean filter, per channel:
    ``x [B, C, H, W] -> [B, C, H-win+1, W-win+1]``, as two separable 1-D
    depthwise convolutions (the order and the weights of the JAX filter)."""
    c = x.shape[1]
    kh = torch.full((c, 1, win, 1), 1.0 / win, dtype=x.dtype, device=x.device)
    kw = torch.full((c, 1, 1, win), 1.0 / win, dtype=x.dtype, device=x.device)
    return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03
         ) -> torch.Tensor:
    """Per-image SSIM matching skimage defaults. ``[B, H, W, C] -> [B]``."""
    x = _clipped(pred, data_range).permute(0, 3, 1, 2)
    y = _clipped(target, data_range).permute(0, 3, 1, 2)

    npix = win_size * win_size
    cov_norm = npix / (npix - 1.0)  # sample covariance (skimage default)

    with full_float32():
        ux = _uniform_filter_valid(x, win_size)
        uy = _uniform_filter_valid(y, win_size)
        uxx = _uniform_filter_valid(x * x, win_size)
        uyy = _uniform_filter_valid(y * y, win_size)
        uxy = _uniform_filter_valid(x * y, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = (((2 * ux * uy + c1) * (2 * vxy + c2))
         / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
    return s.mean(dim=(1, 2, 3))


def compute_psnr_ssim(pred: torch.Tensor, target: torch.Tensor) -> tuple:
    """Batch-mean PSNR, SSIM, N: the reference's return contract
    (val_utils.py:50-66) with ``[B, H, W, C]`` tensors."""
    return psnr(pred, target).mean(), ssim(pred, target).mean(), pred.shape[0]


def _gaussian_kernel(win: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(win) - win // 2) ** 2) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_gaussian(pred: torch.Tensor, target: torch.Tensor,
                  win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Differentiable Gaussian-window SSIM, the scalar mean over the batch
    and the map (JAX ``ssim_gaussian``; reference
    utils/pytorch_ssim/__init__.py:19-43): an 11 x 11 Gaussian of sigma
    1.5 per channel with zero padding to the input's size, C1 = 0.01^2,
    C2 = 0.03^2, no crop. ``[B, H, W, C]``, in float32 with TF32 off."""
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    kern = torch.from_numpy(_gaussian_kernel(win_size, sigma)).to(x.device)
    kern = kern.expand(c, 1, win_size, win_size)

    def filt(z):
        return F.conv2d(z, kern, padding=win_size // 2, groups=c)

    with full_float32():
        mu1, mu2 = filt(x), filt(y)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = filt(x * x) - mu1_sq
        s2 = filt(y * y) - mu2_sq
        s12 = filt(x * y) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = (((2 * mu1_mu2 + c1) * (2 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return smap.mean()


class AverageMeter:
    """Weighted running average, the semantics of reference
    val_utils.py:8-26."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
