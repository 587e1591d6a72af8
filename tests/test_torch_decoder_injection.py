"""The port's decoder injection methods against the JAX package, part 2:
the whole tiny encoder + decoder eval forward (P=32, widths 4,
``uformer_depth_cap=1``) for ``modulator``, ``attention_residual``,
``attention_kv`` and ``deform_conv``, within 1e-4, with the DCN offset
heads drawn at random (setup in ``tests/test_torch_injection_setup.py``);
and the encoder's degradation context (pyramid, K / V) against JAX's."""

import numpy as np
import pytest
import torch

from test_torch_injection_setup import check_config, run_config


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["modulator", "attention_residual",
                                        "attention_kv", "deform_conv"])
def run(request):
    return run_config(request.param)


def test_eval_forward_matches_jax(run):
    check_config(run)


def test_degradation_context_matches_jax(run):
    """The per-scale pyramid (band-0 slices), and for attention_kv each
    stage's last-block K / V, regrouped with the bands major within a
    window, passed whole."""
    with torch.no_grad():
        ctx = run["bundle"].encoder.features(torch.from_numpy(run["x"]))
    want = run["ctx"]
    assert len(ctx.pyramid) == 5
    for got, ref in zip(ctx.pyramid, want.pyramid):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    if run["name"] != "attention_kv":
        assert ctx.kv is None and want.kv is None
        return
    for s, ((gk, gv), (wk, wv)) in enumerate(zip(ctx.kv, want.kv)):
        n = min(8, 32 >> s) ** 2
        assert gk.shape[2] == 3 * n, s          # L * n keys per window
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-5)
