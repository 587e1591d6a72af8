"""The port's standalone window attention (K9 / K10 plain functions and
their autograd Function) and the unfused attention modules against the JAX
package, on the CPU.

* ``window_attention_plain`` against ``_xla_reference`` and against
  ``fused_window_attention`` run in interpret mode (the Pallas ``_kernel``),
  at each (n, nk, d) of the port's main path: (64, 64, 56) the decoder's
  windows, (64, 192, 56) the decoder's windows against the encoder's
  band-grouped keys (``attention_kv``), (192, 192, 28) the encoder's
  band-grouped windows; masked and unmasked; fp32 within 1e-5, bf16 within
  2e-2 of the largest output;
* ``window_attention_bwd_plain`` against ``jax.vjp`` of
  ``fused_window_attention`` in interpret mode (the Pallas ``_bwd_kernel``):
  dq, dk, dv, dbias within 2e-4 of each one's largest value;
  ``WindowAttentionFn`` against autograd of the plain forward;
* ``WindowAttention`` with each ``kv_source``, ``FrequencyWindowAttention``
  with ``need_kv``, ``SelfModulatedLayerNorm`` and ``Downsample(1, s)``
  against their Flax counterparts on transplanted weights, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    uformer_blocks as jblocks)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    windows as jwindows)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops.pallas.window_attention import (
    _xla_reference, fused_window_attention)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_blocks as tblocks)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    frequency as tfrequency)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    window_attention as wa)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

CASES = [(64, 64, 56), (64, 192, 56), (192, 192, 28)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = 2e-4
TOL_MODULE = 1e-5
NW = 2          # windows per image of the masked cases
W = 4           # windows: two images
H = 2


def _inputs(n, nk, d, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((W, H, n, d)).astype(np.float32)
    k = rng.standard_normal((W, H, nk, d)).astype(np.float32)
    v = rng.standard_normal((W, H, nk, d)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((H, n, nk))).astype(np.float32)
    mask = None
    if masked:  # the reference's additive -100 shift mask
        mask = np.where(rng.random((NW, n, nk)) < 0.3, -100.0, 0.0).astype(
            np.float32)
        mask[:, :, 0] = 0.0
    g = rng.standard_normal((W, H, n, d)).astype(np.float32)
    return q, k, v, bias, mask, g


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,nk,d", CASES)
def test_forward_plain_matches_pallas_and_xla(n, nk, d, masked, dtype):
    q, k, v, bias, mask, _ = _inputs(n, nk, d, masked)
    scale = d ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = _j(q, jdt), _j(k, jdt), _j(v, jdt)
    pallas = fused_window_attention(jq, jk, jv, _j(bias), _j(mask), scale,
                                    NW, True)
    xla, _ = _xla_reference(jq, jk, jv, _j(bias), _j(mask), scale, NW)
    got = wa.window_attention_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                    _t(bias), _t(mask), scale, NW)
    assert got.dtype == tdt and tuple(got.shape) == (W, H, n, d)
    got = got.float().numpy()
    assert _rel(got, pallas) <= TOL[dtype]
    assert _rel(got, xla) <= TOL[dtype]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,nk,d", CASES)
def test_backward_plain_matches_pallas_vjp(n, nk, d, masked):
    q, k, v, bias, mask, g = _inputs(n, nk, d, masked, seed=1)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q_, k_, v_, b_: fused_window_attention(
        q_, k_, v_, b_, _j(mask), scale, NW, True), _j(q), _j(k), _j(v),
        _j(bias))
    want = vjp(_j(g))
    got = wa.window_attention_bwd_plain(_t(q), _t(k), _t(v), _t(bias),
                                        _t(mask), _t(g), scale, NW)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert tuple(a.shape) == b.shape, name
        assert _rel(a.numpy(), b) <= BWD_TOL, name


@pytest.mark.parametrize("n,nk,d", CASES)
def test_function_gradients_match_autograd(n, nk, d):
    q, k, v, bias, mask, g = _inputs(n, nk, d, True, seed=2)
    scale = d ** -0.5

    def grads(fn):
        ins = [_t(a).requires_grad_() for a in (q, k, v, bias)]
        out = fn(*ins, _t(mask), scale, NW)
        return [out] + list(torch.autograd.grad(out, ins, _t(g)))

    want = grads(wa.window_attention_plain)
    got = grads(wa.WindowAttentionFn.apply)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_launchers_reject_cpu_tensors():
    q, k, v, bias, mask, g = (_t(a) for a in _inputs(64, 64, 8, True))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_kernel(q, k, v, bias, mask, 0.3, NW)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_bwd_kernel(q, k, v, bias, mask, g, 0.3, NW)


@pytest.mark.parametrize("shape", [(3, 2, 8, 8), (4, 16, 48)])
def test_frequency_decompose_dc_matches_jax(shape):
    from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
        frequency as jfrequency)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(
        tfrequency.frequency_decompose_dc(torch.from_numpy(x)).numpy(),
        np.asarray(jfrequency.frequency_decompose_dc(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn,arg", [("frequency_decompose", 3),
                                    ("frequency_decompose_1", 2)])
def test_decompositions_take_attention_maps(fn, arg):
    """``[B', h, n, nk]`` maps, rectangular too, decompose over their last
    two axes as in JAX."""
    from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
        frequency as jfrequency)
    x = np.random.default_rng(4).random((3, 2, 16, 48)).astype(np.float32)
    got = getattr(tfrequency, fn)(torch.from_numpy(x), arg)
    want = getattr(jfrequency, fn)(jnp.asarray(x), arg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# modules against their Flax counterparts
# ---------------------------------------------------------------------------


def _randomize(variables, seed):
    """Every parameter drawn anew (zero-initialised ones included), so that
    a leaf the port ignored would show."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(variables))


def _load(module, variables):
    module.load_state_dict(from_jax(variables), strict=True)
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL_MODULE, atol=TOL_MODULE)


@pytest.mark.parametrize("kv_source", [None, "attention_residual",
                                       "attention_kv"])
def test_window_attention_kv_sources_match_jax(kv_source):
    """The unfused WindowAttention (shift mask, need_kv) with each key /
    value source; ``attention_kv`` reads 3x longer band-grouped K / V, so
    the bias and the mask are tiled along the keys."""
    rng = np.random.default_rng(5)
    dim, win, heads, nw, b, dkv = 16, 4, 2, 4, 2, 12
    n = win * win
    x = rng.standard_normal((b * nw, n, dim)).astype(np.float32)
    mask = jnp.asarray(jwindows.shift_attn_mask(8, 8, win, 2))
    attn_kv = None
    if kv_source == "attention_residual":
        attn_kv = rng.standard_normal((b * nw, n, dkv)).astype(np.float32)
    elif kv_source == "attention_kv":
        attn_kv = tuple(rng.standard_normal((b * nw, 3, 3 * n, dkv // 3))
                        .astype(np.float32) for _ in range(2))
    jm = jblocks.WindowAttention(dim, win, heads, num_win=nw, need_kv=True,
                                 kv_source=kv_source, dim_kv=dkv)
    jkv = None if attn_kv is None else jax.tree_util.tree_map(jnp.asarray,
                                                              attn_kv)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jkv,
                           mask=mask), 6)
    want, (wk, wv), _ = jm.apply(v, jnp.asarray(x), jkv, mask=mask)
    tm = _load(tblocks.WindowAttention(dim, win, heads, num_win=nw,
                                       kv_source=kv_source, dim_kv=dkv), v)
    tkv = None if attn_kv is None else (
        torch.from_numpy(attn_kv) if kv_source == "attention_residual"
        else tuple(torch.from_numpy(a) for a in attn_kv))
    with torch.no_grad():
        got, (gk, gv) = tm.attend(torch.from_numpy(x), tkv, None,
                                  torch.from_numpy(np.array(mask)))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("kind", ["intra", "inter"])
def test_frequency_window_attention_need_kv_matches_jax(kind):
    rng = np.random.default_rng(7)
    dim, win, heads, L, nw, b = 16, 4, 2, 3, 4, 2
    n = win * win
    x = rng.standard_normal((L * b * nw, n, dim)).astype(np.float32)
    mask = jnp.asarray(jwindows.shift_attn_mask(8, 8, win, 2))
    jm = jblocks.FrequencyWindowAttention(dim, win, heads, L=L, kind=kind,
                                          need_kv=True)
    v = _randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), mask=mask), 8)
    want, (wk, wv) = jm.apply(v, jnp.asarray(x), mask=mask)
    tm = _load(tblocks.FrequencyWindowAttention(dim, win, heads, L, kind), v)
    with torch.no_grad():
        got, (gk, gv) = tm.attend(torch.from_numpy(x),
                                  torch.from_numpy(np.array(mask)))
    assert tuple(gk.shape) == (b * nw, heads, L * n, dim // heads)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_self_modulated_layer_norm_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    inter = rng.standard_normal((2, 16, 12)).astype(np.float32)
    jm = jblocks.SelfModulatedLayerNorm(8)
    v = _randomize(jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                           jnp.asarray(inter)), 10)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(inter))
    tm = _load(tblocks.SelfModulatedLayerNorm(8, 12), v)
    _close(tm(torch.from_numpy(x), torch.from_numpy(inter), torch.float32),
           want)


@pytest.mark.parametrize("stride", [2, 4])
def test_downsample_1x1_strided_matches_jax(stride):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16 * 16, 12)).astype(np.float32)
    jm = jblocks.Downsample(8, kernel=1, stride=stride)
    v = _randomize(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 12)
    want = jm.apply(v, jnp.asarray(x))
    tm = _load(tblocks.Downsample(12, 8, kernel=1, stride=stride), v)
    _close(tm(torch.from_numpy(x), torch.float32), want)
