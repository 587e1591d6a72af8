"""NIQE — Natural Image Quality Evaluator (no-reference metric): the port's
own copy of the JAX package's ``ops/niqe.py`` and its pristine model
``niqe_pristine.npz`` (numpy / scipy only).

The reference exposes ``compute_niqe`` through skvideo (val_utils.py:69-74,
unused in its main path). skvideo is unavailable here, so this is a
self-contained implementation of the NIQE pipeline (Mittal, Soundararajan,
Bovik 2013):

  MSCN coefficients -> per-patch GGD fit of MSCN + AGGD fits of the four
  pairwise-product neighborhoods, at two scales (36 features) -> Mahalanobis
  distance between the test MVG and a pristine-image MVG.

The pristine model (mu, cov) is a *fit parameter*: use
:func:`fit_pristine_model` on a corpus of clean images. Without skvideo's
shipped model file, absolute scores differ from published NIQE numbers —
relative comparisons (lower = more natural) hold. Documented in PARITY.md.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np
from scipy.special import gamma as _gamma


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = size // 2
    g = np.exp(-0.5 * (np.arange(-half, half + 1) / sigma) ** 2)
    w = np.outer(g, g)
    return w / w.sum()


def _filter2(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    from scipy.signal import convolve2d
    return convolve2d(img, kern, mode="same", boundary="symm")


def mscn(img: np.ndarray) -> np.ndarray:
    """Mean-subtracted contrast-normalized coefficients."""
    img = img.astype(np.float64)
    w = _gaussian_window()
    mu = _filter2(img, w)
    sigma = np.sqrt(np.abs(_filter2(img * img, w) - mu * mu))
    return (img - mu) / (sigma + 1.0)


def fit_ggd(x: np.ndarray) -> Tuple[float, float]:
    """Generalized Gaussian fit via moment matching. Returns (alpha, sigma)."""
    gam = np.arange(0.2, 10.001, 0.001)
    r_gam = (_gamma(1.0 / gam) * _gamma(3.0 / gam)) / (_gamma(2.0 / gam) ** 2)
    sigma_sq = np.mean(x ** 2)
    e_abs = np.mean(np.abs(x))
    rho = sigma_sq / (e_abs ** 2 + 1e-12)
    alpha = gam[np.argmin(np.abs(rho - r_gam))]
    return float(alpha), float(math.sqrt(sigma_sq))


def fit_aggd(x: np.ndarray) -> Tuple[float, float, float, float]:
    """Asymmetric GGD fit. Returns (alpha, mean, left_std, right_std)."""
    gam = np.arange(0.2, 10.001, 0.001)
    r_gam = ((_gamma(2.0 / gam)) ** 2) / (_gamma(1.0 / gam) * _gamma(3.0 / gam))
    left = x[x < 0]
    right = x[x >= 0]
    lsq = math.sqrt(np.mean(left ** 2)) if left.size else 1e-6
    rsq = math.sqrt(np.mean(right ** 2)) if right.size else 1e-6
    gamma_hat = lsq / (rsq + 1e-12)
    rhat = (np.mean(np.abs(x)) ** 2) / (np.mean(x ** 2) + 1e-12)
    rhat_norm = (rhat * (gamma_hat ** 3 + 1) * (gamma_hat + 1)
                 / ((gamma_hat ** 2 + 1) ** 2))
    alpha = gam[np.argmin((r_gam - rhat_norm) ** 2)]
    const = math.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    mean = (rsq - lsq) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha)) * const
    return float(alpha), float(mean), float(lsq), float(rsq)


def _patch_features(coeffs: np.ndarray) -> np.ndarray:
    feats = []
    alpha, sigma = fit_ggd(coeffs.ravel())
    feats += [alpha, sigma ** 2]
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        shifted = np.roll(np.roll(coeffs, dy, axis=0), dx, axis=1)
        a, m, l, r = fit_aggd((coeffs * shifted).ravel())
        feats += [a, m, l ** 2, r ** 2]
    return np.asarray(feats)  # 18


def niqe_features(gray: np.ndarray, patch: int = 96,
                  sharpness_fraction: float = 0.75) -> np.ndarray:
    """[N_patches, 36] features at two scales for selected sharp patches."""
    from .resize import imresize

    h, w = gray.shape
    h, w = (h // patch) * patch, (w // patch) * patch
    gray = gray[:h, :w].astype(np.float64)
    if h < patch or w < patch:
        raise ValueError("image smaller than the NIQE patch size")

    # sharpness (local sigma mean per patch at scale 1) for patch selection
    wk = _gaussian_window()
    mu = _filter2(gray, wk)
    sigma = np.sqrt(np.abs(_filter2(gray * gray, wk) - mu * mu))

    feats_scales = []
    for scale in (1, 2):
        img = gray if scale == 1 else imresize(gray, scale=0.5)
        coeffs = mscn(img)
        p = patch // scale
        rows = []
        for i in range(0, coeffs.shape[0] - p + 1, p):
            for j in range(0, coeffs.shape[1] - p + 1, p):
                rows.append(_patch_features(coeffs[i:i + p, j:j + p]))
        feats_scales.append(np.asarray(rows))
    n = min(len(feats_scales[0]), len(feats_scales[1]))
    feats = np.concatenate([feats_scales[0][:n], feats_scales[1][:n]], axis=1)

    # select the sharpest patches (threshold at a fraction of peak sharpness)
    sharp = []
    idx = 0
    for i in range(0, h - patch + 1, patch):
        for j in range(0, w - patch + 1, patch):
            sharp.append(sigma[i:i + patch, j:j + patch].mean())
            idx += 1
    sharp = np.asarray(sharp[:n])
    keep = sharp > sharpness_fraction * sharp.max()
    return feats[keep] if keep.any() else feats


class NiqeModel:
    def __init__(self, mu: np.ndarray, cov: np.ndarray):
        self.mu = mu
        self.cov = cov


def fit_pristine_model(images: Iterable[np.ndarray], patch: int = 96) -> NiqeModel:
    """Fit the pristine MVG from grayscale [0,255] images."""
    all_feats = [niqe_features(np.asarray(img, np.float64), patch)
                 for img in images]
    feats = np.concatenate(all_feats, axis=0)
    mu = feats.mean(0)
    cov = np.cov(feats.T)
    return NiqeModel(mu, cov)


_DEFAULT_MODEL: Optional[NiqeModel] = None


def _default_model() -> NiqeModel:
    """Load the checked-in pristine model (fit by tools/fit_niqe_model.py on
    the offline corpus: one real photograph at three scales + deterministic
    synthetic cleans). Falls back to a lazily-fit synthetic model if the
    parameter file is absent."""
    global _DEFAULT_MODEL
    if _DEFAULT_MODEL is None:
        import os
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "niqe_pristine.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                _DEFAULT_MODEL = NiqeModel(z["mu"], z["cov"])
        else:
            from ..data.synthetic import smooth_image
            from ..utils.visualization import rgb2gray
            rng = np.random.default_rng(0)
            imgs = [rgb2gray(smooth_image(rng, 288, 288).astype(np.float64))
                    for _ in range(12)]
            _DEFAULT_MODEL = fit_pristine_model(imgs)
    return _DEFAULT_MODEL


def compute_niqe(image: np.ndarray, model: Optional[NiqeModel] = None,
                 patch: int = 96) -> float:
    """NIQE score of a grayscale or RGB [0,1]/[0,255] image (lower=better)."""
    img = np.asarray(image, np.float64)
    if img.ndim == 3:
        from ..utils.visualization import rgb2gray
        img = rgb2gray(img if img.max() > 2 else img * 255.0)
    elif img.max() <= 2:
        img = img * 255.0
    model = model or _default_model()
    feats = niqe_features(img, patch)
    mu_t = feats.mean(0)
    cov_t = np.cov(feats.T) if feats.shape[0] > 1 else np.zeros_like(model.cov)
    cov = (model.cov + cov_t) / 2.0
    diff = model.mu - mu_t
    inv = np.linalg.pinv(cov)
    return float(math.sqrt(max(diff @ inv @ diff, 0.0)))
