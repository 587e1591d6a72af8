"""The port's numpy/torch ops (ops/frequency.py, ops/windows.py) against
the JAX package's, on the same inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    frequency as jfreq, windows as jwin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    frequency as tfreq, windows as twin)


@pytest.mark.parametrize("variant", ["open", "dc"])
@pytest.mark.parametrize("h,w,bands", [(32, 32, 2), (128, 128, 2),
                                       (31, 48, 3), (64, 40, 5)])
def test_ring_masks_match(h, w, bands, variant):
    np.testing.assert_array_equal(tfreq.ring_masks(h, w, bands, variant),
                                  jfreq.ring_masks(h, w, bands, variant))


@pytest.mark.parametrize("shape,rings", [((2, 3, 32, 32), 2),
                                         ((1, 3, 16, 24), 1),
                                         ((2, 64, 64), 3)])
def test_frequency_decompose_1_matches(rng, shape, rings):
    x = rng.standard_normal(shape).astype(np.float32)
    got = tfreq.frequency_decompose_1(torch.from_numpy(x), rings)
    want = jfreq.frequency_decompose_1(jnp.asarray(x), rings)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_frequency_decompose_1_bands_sum_to_input(rng):
    # the DC-variant rings cover the whole disk; the spectrum corners
    # beyond it are the only loss, so low-pass content survives exactly
    x = rng.standard_normal((1, 32, 32)).astype(np.float32)
    bands = tfreq.frequency_decompose_1(torch.from_numpy(x), 2)
    masks = tfreq.ring_masks(32, 32, 2, "dc").sum(0)
    spec = np.fft.fftshift(np.fft.fft2(x))
    want = np.fft.ifft2(np.fft.ifftshift(spec * masks)).real
    np.testing.assert_allclose(bands.sum(0).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("b,h,w,win", [(2, 16, 16, 8), (1, 32, 24, 8),
                                       (3, 8, 8, 8)])
def test_window_partition_reverse_match(rng, b, h, w, win):
    x = rng.standard_normal((b, h, w, 5)).astype(np.float32)
    got = twin.window_partition(torch.from_numpy(x), win)
    want = jwin.window_partition(jnp.asarray(x), win)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = twin.window_reverse(got, win, h, w)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("res,win,shift", [(16, 8, 4), (32, 8, 4),
                                           (64, 8, 4)])
def test_shift_attn_mask_match(res, win, shift):
    got = twin.shift_attn_mask(res, res, win, shift)
    np.testing.assert_array_equal(got, jwin.shift_attn_mask(res, res, win, shift))
    assert set(np.unique(got)) <= {0.0, -100.0}


@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("kind", ["intra", "inter"])
def test_band_mask_match(L, kind):
    np.testing.assert_array_equal(twin.band_mask(L, 64, kind),
                                  jwin.band_mask(L, 64, kind))


@pytest.mark.parametrize("win", [4, 8])
def test_relative_bias_match(rng, win):
    np.testing.assert_array_equal(twin.relative_position_index(win, win),
                                  jwin.relative_position_index(win, win))
    table = rng.standard_normal(((2 * win - 1) ** 2, 3)).astype(np.float32)
    idx = torch.from_numpy(twin.relative_position_index(win, win))
    got = twin.gather_relative_bias(torch.from_numpy(table), idx)
    want = jwin.gather_relative_bias(jnp.asarray(table), win, win)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
