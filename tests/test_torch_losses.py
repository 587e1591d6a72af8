"""The port's training losses against the JAX package's (1e-6), inputs from
a numpy seed: L1, the frequency-band L1 on masked spectra, the joint
objective, and the ``inverse=False`` form of ``frequency_decompose``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    frequency as jfrequency)
from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
    losses as jlosses)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    frequency as tfrequency)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    losses as tlosses)

TOL = 1e-6


@pytest.fixture
def pair():
    rng = np.random.default_rng(2)
    return (rng.random((2, 32, 32, 3)).astype(np.float32),
            rng.random((2, 32, 32, 3)).astype(np.float32))


def test_l1_loss_matches(pair):
    p, t = pair
    got = tlosses.l1_loss(torch.from_numpy(p).bfloat16(), torch.from_numpy(t))
    want = jlosses.l1_loss(jnp.asarray(p).astype(jnp.bfloat16), jnp.asarray(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bands", [1, 2, 4])
def test_frequency_l1_loss_matches(pair, bands):
    p, t = pair
    got = tlosses.frequency_l1_loss(torch.from_numpy(p), torch.from_numpy(t),
                                    bands)
    want = jlosses.frequency_l1_loss(jnp.asarray(p), jnp.asarray(t), bands)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("inverse", [True, False])
def test_frequency_decompose_matches(pair, inverse):
    x = pair[0].transpose(0, 3, 1, 2)
    got = tfrequency.frequency_decompose(torch.from_numpy(x), 3, inverse)
    want = np.asarray(jfrequency.frequency_decompose(jnp.asarray(x), 3, inverse))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):   # 'visual' is the magnitude mode
        tfrequency.frequency_decompose(torch.from_numpy(x), 3, "magnitude")


@pytest.mark.parametrize("bands_l1", [-1, 2])
def test_restoration_loss_matches(pair, bands_l1):
    p, t = pair
    cfg = config.make_config(num_frequency_bands_l1=bands_l1)
    tcfg = tconfig.from_fields(cfg)
    total, l1 = tlosses.restoration_loss(tcfg, torch.from_numpy(p),
                                         torch.from_numpy(t), torch.tensor(0.7))
    jtotal, jl1 = jlosses.restoration_loss(cfg, jnp.asarray(p), jnp.asarray(t),
                                           jnp.asarray(0.7))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=1e-5, atol=1e-5)
    assert float(total) == pytest.approx(
        float(l1) + tcfg.contrast_loss_weight * 0.7, abs=1e-6)


def test_frequency_l1_takes_a_gradient(pair):
    p = torch.from_numpy(pair[0]).requires_grad_()
    tlosses.frequency_l1_loss(p, torch.from_numpy(pair[1]), 2).backward()
    assert p.grad is not None and torch.isfinite(p.grad).all()
    assert float(p.grad.abs().max()) > 0.0
