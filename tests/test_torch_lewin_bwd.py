"""The port's LeWin-block backward against the JAX package, on the CPU.

Each backward twin (``attn_block_bwd_plain``, ``ffn_block_bwd_plain``,
``freq_inter_bwd_plain``) is held against the Pallas backward kernel it
mirrors, run in interpret mode as ``tests/test_pallas_lewin_block_bwd.py``
runs it, and against ``jax.vjp`` of the unfused composite, in float32 at
2e-4 (that file's tolerance). Each autograd Function is held against
``torch.autograd.grad`` of the forward twin (DropPath, mask and lam on and
off), and the merged Functions against the chain of the half Functions
(equal bits). Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    windows as jwindows)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops.pallas import (
    lewin_block as jlb)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops.pallas import (
    lewin_block_bwd as jlbb)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as lb)

B, RES, C, H, L, WIN = 2, 16, 8, 2, 2, 8
N = WIN * WIN
NW = (RES // WIN) ** 2
TOL = 2e-4


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _a(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_np(rng, batch, groups=1):
    d = C // H
    qkv = [_a(rng, H, C, d, scale=0.2) if i % 2 == 0 else
           _a(rng, H, d, scale=0.1) for i in range(6)]
    bias = (_a(rng, groups, H, N, N, scale=0.05) if groups > 1 else
            _a(rng, H, N, N, scale=0.05))
    return ([_a(rng, batch, RES, RES, C, scale=0.5),
             1.0 + _a(rng, C, scale=0.1), _a(rng, C, scale=0.1)] + qkv
            + [_a(rng, H, d, C, scale=0.2), _a(rng, C, scale=0.1), bias])


def _ffn_np(rng):
    hd = 4 * C
    return [1.0 + _a(rng, C, scale=0.1), _a(rng, C, scale=0.1),
            _a(rng, C, hd, scale=0.2), _a(rng, hd, scale=0.1),
            _a(rng, 3, 3, hd, scale=0.2), _a(rng, hd, scale=0.1),
            _a(rng, hd, C, scale=0.2), _a(rng, C, scale=0.1)]


def _mask_np():
    return np.asarray(jwindows.shift_attn_mask(RES, RES, WIN, WIN // 2),
                      np.float32)


def _dps_np(rng, n):
    return (rng.random(n) < 0.6).astype(np.float32) * 1.25


def _j(args):
    return [None if a is None else jnp.asarray(a) if isinstance(a, np.ndarray)
            else a for a in args]


def _t(args, grad=False):
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a.copy())
            if grad:
                a.requires_grad_()
        out.append(a)
    return out


def _close(got, want, what=""):
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, f"{what} #{i}"
            continue
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} #{i}")


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels (interpret mode) and jax.vjp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked,with_lam", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_attn_bwd_twin_matches_jax(rng, masked, with_lam):
    a = _attn_np(rng, B)
    g = _a(rng, B, RES, RES, C, scale=0.5)
    mask = _mask_np() if masked else None
    lam = _a(rng, B, H, scale=0.3) if with_lam else None
    got = lb.attn_block_bwd_plain(*_t([a[0], g] + a[1:] + [mask, lam]), WIN,
                                  1e-6, True, 1)
    ja = _j(a)
    pallas = jlbb.attn_block_bwd(ja[0], jnp.asarray(g), *ja[1:], *_j([mask, lam]),
                                 WIN, 1e-6, True, True, 1)
    _close(got, pallas, "pallas")
    diff = ja[:12] + ([jnp.asarray(lam)] if with_lam else [])
    _, vjp = jax.vjp(
        lambda *p: jlb._xla_block_attention(
            *p[:12], None if mask is None else jnp.asarray(mask),
            p[12] if with_lam else None, WIN, 1e-6), *diff)
    want = vjp(jnp.asarray(g))
    _close(got[:12] + ((got[12],) if with_lam else ()), want, "vjp")


def test_intra_bwd_twin_matches_jax(rng):
    a = _attn_np(rng, L * B, groups=L)
    g = _a(rng, L * B, RES, RES, C, scale=0.5)
    mask = _mask_np()
    got = lb.attn_block_bwd_plain(*_t([a[0], g] + a[1:] + [mask, None]), WIN,
                                  1e-6, False, L)
    ja = _j(a)
    pallas = jlbb.attn_block_bwd(ja[0], jnp.asarray(g), *ja[1:],
                                 jnp.asarray(mask), None, WIN, 1e-6, True,
                                 False, L)
    _close(got, pallas, "pallas")
    _, vjp = jax.vjp(lambda *p: jlb._xla_freq_intra(
        *p, jnp.asarray(mask), L, WIN, 1e-6), *ja)
    _close(got[:12], vjp(jnp.asarray(g)), "vjp")


@pytest.mark.parametrize("masked", [False, True])
def test_inter_bwd_twin_matches_jax(rng, masked):
    a = _attn_np(rng, L * B)
    g = _a(rng, L * B, RES, RES, C, scale=0.5)
    res = _a(rng, L * B, RES, RES, C, scale=0.5)
    biasB = _a(rng, H, L * N, L * N, scale=0.05)
    mask = _mask_np() if masked else None
    got = lb.freq_inter_bwd_plain(*_t([a[0], g] + a[3:11] + [biasB, mask]), L,
                                  WIN)
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = jlbb.freq_inter_bwd(jnp.asarray(a[0]), jnp.asarray(g),
                                 *_j(a[3:11]), jnp.asarray(biasB), jmask, L,
                                 WIN, True)
    _close(got, pallas, "pallas")
    diff = _j([a[0], res] + a[3:11] + [biasB])
    _, vjp = jax.vjp(lambda *p: jlb._xla_freq_inter(*p, jmask, L, WIN, 1e-6),
                     *diff)
    want = vjp(jnp.asarray(g))
    _close(got, (want[0],) + tuple(want[2:]), "vjp")


def test_ffn_bwd_twin_matches_jax_over_row_tiles(rng, monkeypatch):
    # a zero budget cuts the image into several row tiles, so the Pallas
    # body's halo rows and revisited accumulators are in play
    monkeypatch.setenv("FAIRM_FFN_BWD_T_MB", "0")
    x = _a(rng, B, RES, RES, C, scale=0.5)
    g = _a(rng, B, RES, RES, C, scale=0.5)
    w = _ffn_np(rng)
    assert jlbb._ffn_bwd_choose_t(RES, RES, 4 * C, 4) < RES
    got = lb.ffn_block_bwd_plain(*_t([x, g] + w), 1e-6)
    pallas = jlbb.ffn_block_bwd(jnp.asarray(x), jnp.asarray(g), *_j(w), 1e-6,
                                True)
    _close(got, pallas, "pallas")
    _, vjp = jax.vjp(lambda *p: jlb._xla_block_ffn(*p, 1e-6),
                     jnp.asarray(x), *_j(w))
    _close(got, vjp(jnp.asarray(g)), "vjp")


def test_block_attention_function_matches_jax_grad_with_droppath(rng,
                                                                 monkeypatch):
    """The DropPath rule of the Function (feed s * g, then dx += (1 - s) g)
    against jax.grad through the JAX custom VJP with the Pallas backward."""
    monkeypatch.setenv("FAIRM_BWD_KERNEL", "1")
    a = _attn_np(rng, B)
    mask, lam = _mask_np(), _a(rng, B, H, scale=0.3)
    dps = np.array([0.0, 1.25], np.float32)
    g = _a(rng, B, RES, RES, C, scale=0.5)
    ta = _t(a, grad=True)
    tlam = torch.from_numpy(lam).requires_grad_()
    out = lb.BlockAttention.apply(*ta, torch.from_numpy(mask), tlam, WIN, 1e-6,
                                  torch.from_numpy(dps))
    got = torch.autograd.grad(out, ta + [tlam], torch.from_numpy(g))
    loss = lambda *p: jnp.sum(jlb.fused_block_attention(
        *p[:12], jnp.asarray(mask), p[12], WIN, 1e-6, True,
        jnp.asarray(dps)) * jnp.asarray(g))
    want = jax.grad(loss, argnums=tuple(range(13)))(*_j(a), jnp.asarray(lam))
    _close(got, want, "grad")


# ---------------------------------------------------------------------------
# the Functions against torch.autograd.grad of the forward twins
# ---------------------------------------------------------------------------


def _grads(out, ins, g):
    return torch.autograd.grad(out, ins, g, allow_unused=True)


@pytest.mark.parametrize("masked,with_lam,dropped", [
    (False, False, False), (True, True, True), (True, False, True),
    (False, True, False)])
def test_block_attention_function(rng, masked, with_lam, dropped):
    a = _t(_attn_np(rng, B), grad=True)
    mask = torch.from_numpy(_mask_np()) if masked else None
    lam = (torch.from_numpy(_a(rng, B, H, scale=0.3)).requires_grad_()
           if with_lam else None)
    dps = torch.from_numpy(_dps_np(rng, B)) if dropped else None
    if dropped:
        dps[0] = 0.0  # one dropped, one kept image
        dps[1] = 1.25
    g = torch.from_numpy(_a(rng, B, RES, RES, C, scale=0.5))
    ins = a + ([lam] if with_lam else [])
    want_out = lb.block_attention_plain(*a, mask, lam, WIN, 1e-6, dps)
    got_out = lb.BlockAttention.apply(*a, mask, lam, WIN, 1e-6, dps)
    assert torch.equal(got_out, want_out)
    _close(_grads(got_out, ins, g), _grads(want_out, ins, g))


def test_freq_intra_function(rng):
    a = _t(_attn_np(rng, L * B, groups=L), grad=True)
    mask = torch.from_numpy(_mask_np())
    g = torch.from_numpy(_a(rng, L * B, RES, RES, C, scale=0.5))
    want_out = lb.freq_intra_plain(*a, mask, L, WIN)
    got_out = lb.FreqIntra.apply(*a, mask, L, WIN, 1e-6)
    assert torch.equal(got_out, want_out)
    _close(_grads(got_out, a, g), _grads(want_out, a, g))


@pytest.mark.parametrize("masked,dropped", [(False, False), (True, True)])
def test_freq_inter_function(rng, masked, dropped):
    a = _attn_np(rng, L * B)
    args = _t([a[0], _a(rng, L * B, RES, RES, C, scale=0.5)] + a[3:11]
              + [_a(rng, H, L * N, L * N, scale=0.05)], grad=True)
    mask = torch.from_numpy(_mask_np()) if masked else None
    dps = (torch.tensor([0.0, 1.25, 1.25, 0.0]) if dropped else None)
    g = torch.from_numpy(_a(rng, L * B, RES, RES, C, scale=0.5))
    want_out = lb.freq_inter_plain(*args, mask, L, WIN, 1e-6, dps)
    got_out = lb.FreqInter.apply(*args, mask, L, WIN, 1e-6, dps)
    assert torch.equal(got_out, want_out)
    got, want = _grads(got_out, args, g), _grads(want_out, args, g)
    _close(got, want)
    # the residual's gradient is the unscaled g, dropped image or not
    assert torch.equal(got[1], g)


@pytest.mark.parametrize("dropped", [False, True])
def test_block_ffn_function(rng, dropped):
    args = _t([_a(rng, B, RES, RES, C, scale=0.5)] + _ffn_np(rng), grad=True)
    dps = torch.tensor([0.0, 1.25]) if dropped else None
    g = torch.from_numpy(_a(rng, B, RES, RES, C, scale=0.5))
    want_out = lb.block_ffn_plain(*args, 1e-6, dps)
    got_out = lb.BlockFFN.apply(*args, 1e-6, dps)
    assert torch.equal(got_out, want_out)
    _close(_grads(got_out, args, g), _grads(want_out, args, g))


def test_dropping_dlam_or_the_droppath_correction_is_seen(rng, monkeypatch):
    """The checks above would catch a backward that loses dlam (the only
    route from the L1 loss to the encoder) or the (1 - s) g correction."""
    a = _t(_attn_np(rng, B), grad=True)
    lam = torch.from_numpy(_a(rng, B, H, scale=0.3)).requires_grad_()
    dps = torch.tensor([0.0, 1.25])
    g = torch.from_numpy(_a(rng, B, RES, RES, C, scale=0.5))
    want = _grads(lb.block_attention_plain(*a, None, lam, WIN, 1e-6, dps),
                  a + [lam], g)
    assert want[12].abs().max() > 1e-3 and g[0].abs().max() > 1e-3

    real = lb.attn_block_bwd_plain
    monkeypatch.setattr(lb, "attn_block_bwd_plain", lambda *p, **k: (
        real(*p, **k)[:12] + (torch.zeros_like(lam),)))
    got = _grads(lb.BlockAttention.apply(*a, None, lam, WIN, 1e-6, dps),
                 a + [lam], g)
    assert not torch.allclose(got[12], want[12], atol=TOL)
    monkeypatch.setattr(lb, "attn_block_bwd_plain", real)

    monkeypatch.setattr(lb, "_fix_dx", lambda dx, g, dps: dx)
    got = _grads(lb.BlockAttention.apply(*a, None, lam, WIN, 1e-6, dps),
                 a + [lam], g)
    assert not torch.allclose(got[0], want[0], atol=TOL)


# ---------------------------------------------------------------------------
# the merged Functions against the chain of the half Functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [0, WIN // 2])
def test_block_merged_function_equals_the_chain(rng, shift):
    a = _t(_attn_np(rng, B), grad=True)
    lam = torch.from_numpy(_a(rng, B, H, scale=0.3)).requires_grad_()
    w = _t(_ffn_np(rng), grad=True)
    mask = torch.from_numpy(_mask_np()) if shift else None
    d1, d2 = torch.tensor([0.0, 1.25]), torch.tensor([1.25, 0.0])
    g = torch.from_numpy(_a(rng, B, RES, RES, C, scale=0.5))
    ins = a + [lam] + w
    merged = lb.BlockMerged.apply(*a, mask, lam, *w, WIN, shift, 1e-6, d1, d2)
    u = lb.roll(lb.BlockAttention.apply(lb.roll(a[0], shift), *a[1:], mask,
                                        lam, WIN, 1e-6, d1), -shift)
    chain = lb.BlockFFN.apply(u, *w, 1e-6, d2)
    assert torch.equal(merged, chain)
    assert torch.equal(merged, lb.block_merged_plain(
        *a, mask, lam, *w, WIN, shift, 1e-6, d1, d2))
    for p, q in zip(_grads(merged, ins, g), _grads(chain, ins, g)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("shift", [0, WIN // 2])
def test_block_freq_merged_function_equals_the_chain(rng, shift):
    a = _t(_attn_np(rng, L * B, groups=L), grad=True)
    b = _t(_attn_np(rng, L * B)[3:11]
           + [_a(rng, H, L * N, L * N, scale=0.05)], grad=True)
    w = _t(_ffn_np(rng), grad=True)
    mask = torch.from_numpy(_mask_np()) if shift else None
    d1 = torch.tensor([0.0, 1.25, 1.25, 0.0])
    d2 = torch.tensor([1.25, 0.0, 1.25, 0.0])
    g = torch.from_numpy(_a(rng, L * B, RES, RES, C, scale=0.5))
    ins = a + b + w
    merged = lb.BlockFreqMerged.apply(*a, *b, mask, *w, L, WIN, shift, 1e-6,
                                      d1, d2)
    img = lb.roll(a[0], shift)
    y1 = lb.FreqIntra.apply(img, *a[1:], mask, L, WIN, 1e-6)
    u = lb.roll(lb.FreqInter.apply(y1, img, *b, mask, L, WIN, 1e-6, d1),
                -shift)
    chain = lb.BlockFFN.apply(u, *w, 1e-6, d2)
    assert torch.equal(merged, chain)
    for p, q in zip(_grads(merged, ins, g), _grads(chain, ins, g)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", [(5, 1), (28, 1), (56, 2), (448, 16)])
def test_attn_bwd_nt_operands(c, h, dtype):
    """The B operands of ``dqkv Wqkv^T`` and ``gw Wp^T`` that K6 and K8
    take (K8 also at the encoder's deepest stage, C = 448, 16 heads)
    (``_attn_bwd_nt_operands``): with them the two products give the
    gradients that autograd gives through the forward's operands, and
    their pad columns are zero."""
    rng = np.random.default_rng(c)
    d = c // h
    w3 = [torch.from_numpy(_a(rng, h, c, d)) for _ in range(3)]
    b3 = torch.zeros(h, d)
    wp3 = torch.from_numpy(_a(rng, h, d, c))
    x = torch.zeros(1, WIN, WIN, c, dtype=dtype)
    wqkv, _, wp = lb._attn_bwd_operands(x, w3[0], b3, w3[1], b3, w3[2], b3,
                                        wp3)
    wqkvn, wpn = lb._attn_bwd_nt_operands(wqkv, wp3)
    assert wqkvn.shape == (c, lb.kpad(3 * c)) and wpn.shape == (c, lb.kpad(c))
    assert wqkvn.dtype == dtype and wpn.dtype == dtype
    assert not wqkvn[:, 3 * c:].any() and not wpn[:, c:].any()
    f64 = lambda t: t.to(torch.float64)
    xw = torch.from_numpy(_a(rng, 7, c)).to(torch.float64).requires_grad_()
    dqkv = f64(torch.from_numpy(_a(rng, 7, 3 * c)))
    qkv = xw @ f64(wqkv[:, :c]).t()             # the forward's qkv product
    (dxw,) = torch.autograd.grad(qkv, xw, dqkv)
    torch.testing.assert_close(dqkv @ f64(wqkvn[:, :3 * c]).t(), dxw)
    att = torch.from_numpy(_a(rng, 7, c)).to(torch.float64).requires_grad_()
    gw = f64(torch.from_numpy(_a(rng, 7, c)))
    out = att @ f64(wp[:, :c]).t()              # the forward's proj product
    (dout,) = torch.autograd.grad(out, att, gw)
    torch.testing.assert_close(gw @ f64(wpn[:, :c]).t(), dout)
