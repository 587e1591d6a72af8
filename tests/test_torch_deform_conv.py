"""The port's modulated deformable convolution (K11's plain function and
its autograd Function) and the ``deform_conv`` LeFF against the JAX
package, on the CPU.

Offsets are drawn at random up to +-3.5, so that samples reach past every
edge of the image: the JAX offset head is zero at init, which would make
every offset 0 and hide a swapped dy / dx layout or a wrong rim rule.

* ``dcn_plain`` against ``_exact_dcn`` within 1e-5 (fp32), and in bf16
  within 2e-2 of the largest output;
* ``dcn_plain(clamp=R)`` against ``dcn_shift_kernel(interpret=True)`` for
  R = 1, 2 within 1e-4;
* ``DCNFn``'s gradients against ``jax.vjp`` of ``_exact_dcn`` within 1e-4
  of each one's largest value;
* ``LeFF(deform=True)`` against the Flax ``LeFF`` on transplanted weights,
  with a random offset head, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    uformer_blocks as jblocks)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops.deform_conv import (
    _exact_dcn)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops.pallas.dcn import (
    dcn_shift_kernel)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_blocks as tblocks)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as tdcn)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CLAMP_TOL = 1e-4
GRAD_TOL = 1e-4


def _inputs(seed=0, B=2, H=12, W=16, C=8, Cout=6, bias=True):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, H, W, C))).astype(np.float32)
    off = rng.uniform(-3.5, 3.5, (B, H, W, 18)).astype(np.float32)
    mask = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, W, 9))))).astype(
        np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, Cout))).astype(np.float32)
    b = (0.1 * rng.standard_normal((Cout,))).astype(np.float32) if bias else None
    return x, off, mask, w, b


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_dcn_plain_matches_exact_dcn(dtype, bias):
    x, off, mask, w, b = _inputs(bias=bias)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = _exact_dcn(_j(x, jdt), _j(off, jdt), _j(mask, jdt), _j(w, jdt),
                      _j(b, jdt))
    got = tdcn.dcn_plain(_t(x, tdt), _t(off, tdt), _t(mask, tdt),
                         _t(w, tdt), _t(b, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, 12, 16, 6)
    assert _rel(got.float().numpy(), want) <= TOL[dtype]


def test_rim_rule_reads_zero_outside_the_image():
    """Every offset pushes its sample past the image: the output is the
    bias alone."""
    x, off, mask, w, b = _inputs(seed=1)
    far = np.full_like(off, 40.0)
    got = tdcn.dcn_plain(_t(x), _t(far), _t(mask), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(b, got.shape),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("R", [1, 2])
def test_dcn_plain_clamped_matches_shift_kernel(R):
    x, off, mask, w, b = _inputs(seed=2, H=16)
    want = dcn_shift_kernel(_j(x), _j(off), _j(mask), _j(w), _j(b), R=R,
                            interpret=True)
    got = tdcn.dcn_plain(_t(x), _t(off), _t(mask), _t(w), _t(b), clamp=R)
    assert _rel(got.numpy(), want) <= CLAMP_TOL


def test_dcn_function_gradients_match_jax_vjp():
    x, off, mask, w, b = _inputs(seed=3)
    g = np.random.default_rng(4).standard_normal((2, 12, 16, 6)).astype(
        np.float32)
    _, vjp = jax.vjp(_exact_dcn, _j(x), _j(off), _j(mask), _j(w), _j(b))
    want = vjp(_j(g))
    ins = [_t(a).requires_grad_() for a in (x, off, mask, w, b)]
    out = tdcn.DCNFn.apply(*ins, 1, 1)
    got = torch.autograd.grad(out, ins, _t(g))
    for name, a, ref in zip(("dx", "doffset", "dmask", "dweight", "dbias"),
                            got, want):
        assert _rel(a.numpy(), ref) <= GRAD_TOL, name


def test_dcn_function_without_bias():
    x, off, mask, w, _ = _inputs(seed=5, bias=False)
    ins = [_t(a).requires_grad_() for a in (x, off, mask, w)]
    out = tdcn.DCNFn.apply(*ins, None, 1, 1)
    want = tdcn.dcn_plain(*ins, None)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    got = torch.autograd.grad(out.sum(), ins)
    ref = torch.autograd.grad(want.sum(), ins)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cin,cout,dtype,want", [
    (64, 64, torch.bfloat16, "implicit"),   # DGRN's DCNs
    (3, 3, torch.bfloat16, "implicit"),
    (48, 64, torch.bfloat16, "implicit"),
    (64, 112, torch.bfloat16, "columns"),   # Cout above the limit
    (112, 112, torch.bfloat16, "columns"),  # the deformable LeFF at res 128
    (896, 896, torch.bfloat16, "columns"),  # ... and at res 8 / 16
    (64, 64, torch.float32, "columns"),     # fp32 has the column route only
])
def test_dcn_path_chooser(cin, cout, dtype, want):
    """dcn_path: K11 in bf16 as the implicit GEMM where both widths are at
    most DCN_IMPLICIT_MAX_C (where it measured ahead), the column route
    elsewhere."""
    assert tdcn.DCN_IMPLICIT_MAX_C == 64
    assert tdcn.dcn_path(cin, cout, dtype) == want


def test_dcn_launcher_rejects_cpu_tensors():
    x, off, mask, w, b = (_t(a) for a in _inputs())
    with pytest.raises(ValueError, match="CUDA"):
        tdcn.dcn_kernel(x, off, mask, w, b)


def _leff_variables(jm, x, inter):
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(inter)))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(np.array, v["params"])
    # a live offset head: offsets of a few pixels, past the image edge
    om = params["dcn"]["conv_offset_mask"]
    om["kernel"] = (0.5 * rng.standard_normal(om["kernel"].shape)).astype(
        np.float32)
    om["bias"] = rng.uniform(-3.5, 3.5, om["bias"].shape).astype(np.float32)
    return {"params": params}


def test_deform_leff_matches_jax():
    rng = np.random.default_rng(7)
    dim, deg, side = 8, 12, 8
    x = rng.standard_normal((2, side * side, dim)).astype(np.float32)
    inter = rng.standard_normal((2, side * side, deg)).astype(np.float32)
    jm = jblocks.LeFF(dim, deform=True, degradation_dim=deg)
    v = _leff_variables(jm, x, inter)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(inter))
    tm = tblocks.LeFF(dim, dim, deform=True, degradation_dim=deg)
    tm.load_state_dict(from_jax(v), strict=True)
    assert tuple(tm.dcn.weight.shape) == (3, 3, dim, dim)  # HWIO, raw
    for plain in (True, False):
        with torch.no_grad():
            got = tm.composite(torch.from_numpy(x), torch.from_numpy(inter),
                               plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_dcn_layer_init_matches_jax_initialisers():
    """Zero offset head (offsets 0, modulation 0.5) and the raw weight in
    [0, 2 stdv), used as weight - stdv."""
    layer = tblocks.DCNLayerLeFF(8, 8).requires_grad_(False)
    layer.init_weights(torch.Generator().manual_seed(0))
    assert float(layer.conv_offset_mask.weight.abs().max()) == 0.0
    assert float(layer.conv_offset_mask.bias.abs().max()) == 0.0
    stdv = 1.0 / np.sqrt(8 * 9)
    assert 0.0 <= float(layer.weight.min()) and float(layer.weight.max()) < 2 * stdv
