"""The port's PSNR / SSIM (``ops/metrics.py``) against the JAX package's, on
the same numpy images: PSNR within 1e-3 dB, SSIM within 1e-5 (both sides
compute in float32; the window sums differ in order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    metrics as jmetrics)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    metrics as tmetrics)

PSNR_TOL = 1e-3   # dB
SSIM_TOL = 1e-5


def _pair(rng, shape, kind):
    clean = rng.random(shape, dtype=np.float32)
    if kind == "random":
        pred = rng.random(shape, dtype=np.float32)
    elif kind == "near":
        pred = clean + rng.standard_normal(shape).astype(np.float32) * 1e-3
    else:  # values outside [0, 1]: both sides clip first
        pred = clean + rng.standard_normal(shape).astype(np.float32) * 0.5
        clean = clean * 1.2 - 0.1
    return pred, clean


@pytest.mark.parametrize("kind", ["random", "near", "out_of_range"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 40, 56, 3),
                                   (3, 17, 9, 1)])
def test_psnr_ssim_match_jax(rng, shape, kind):
    pred, clean = _pair(rng, shape, kind)
    tp, tc = torch.from_numpy(pred), torch.from_numpy(clean)
    np.testing.assert_allclose(
        tmetrics.psnr(tp, tc).numpy(),
        np.asarray(jmetrics.psnr(jnp.asarray(pred), jnp.asarray(clean))),
        rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(
        tmetrics.ssim(tp, tc).numpy(),
        np.asarray(jmetrics.ssim(jnp.asarray(pred), jnp.asarray(clean))),
        rtol=0, atol=SSIM_TOL)


def test_compute_psnr_ssim_matches_jax(rng):
    pred, clean = _pair(rng, (3, 24, 40, 3), "random")
    p, s, n = tmetrics.compute_psnr_ssim(torch.from_numpy(pred),
                                         torch.from_numpy(clean))
    jp, js, jn = jmetrics.compute_psnr_ssim(jnp.asarray(pred),
                                            jnp.asarray(clean))
    assert n == jn == 3
    assert abs(float(p) - float(jp)) <= PSNR_TOL
    assert abs(float(s) - float(js)) <= SSIM_TOL


def test_psnr_floor_and_identical_images(rng):
    """mse is floored at 1e-12: identical images give 120 dB, not inf; SSIM
    of an image with itself is 1."""
    img = torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32))
    assert float(tmetrics.psnr(img, img)[0]) == pytest.approx(120.0, abs=1e-4)
    assert float(jmetrics.psnr(jnp.asarray(img.numpy()),
                               jnp.asarray(img.numpy()))[0]) == pytest.approx(
                                   120.0, abs=1e-4)
    assert float(tmetrics.ssim(img, img)[0]) == pytest.approx(1.0, abs=1e-6)


def test_metrics_take_bf16_and_compute_in_float32(rng):
    pred, clean = _pair(rng, (1, 16, 24, 3), "random")
    tp = torch.from_numpy(pred).bfloat16()
    got = tmetrics.psnr(tp, torch.from_numpy(clean))
    assert got.dtype == torch.float32
    want = tmetrics.psnr(tp.float(), torch.from_numpy(clean))
    assert float(got[0]) == float(want[0])


@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False)])
def test_metrics_leave_the_tf32_flags_alone(rng, flags):
    """The SSIM filter runs with TF32 off and puts the caller's flags back,
    also when the call raises."""
    pred, clean = _pair(rng, (1, 16, 16, 3), "random")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        with tmetrics.full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        tmetrics.ssim(torch.from_numpy(pred), torch.from_numpy(clean))
        with pytest.raises(RuntimeError):
            tmetrics.ssim(torch.from_numpy(pred[:, :3]),   # under one window
                          torch.from_numpy(clean[:, :3]))
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_average_meter_matches_jax():
    a, b = tmetrics.AverageMeter(), jmetrics.AverageMeter()
    for val, n in ((30.5, 1), (28.25, 3), (np.float32(31.0), 2)):
        a.update(val, n)
        b.update(val, n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)
    a.reset()
    assert (a.val, a.avg, a.sum, a.count) == (0.0, 0.0, 0.0, 0)
