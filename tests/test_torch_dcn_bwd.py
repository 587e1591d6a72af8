"""The DCN backward's plain version (``dcn_bwd_plain``, the twin of K14)
against autograd of the port's forward and against the JAX package, on the
CPU.

Offsets are drawn up to +-3.5, with some of them rounded so that samples
hit integer coordinates and some set so that samples land exactly on the
``-1`` and ``H`` rims (where the rim clip is at its bound) or beyond them;
the modulation lies in [0.1, 0.9], away from 0 and 1.

* ``dcn_bwd_plain`` against ``torch.autograd.grad`` of ``dcn_plain``
  within 1e-6 of each output's largest value (fp32: the two differ only in
  the order of their sums);
* against ``jax.vjp`` of the JAX ``_exact_dcn`` within 1e-5 (fp32) and
  2e-2 (bf16, where JAX rounds the fractions, the sample and each sum to
  bf16 and the port keeps them in fp32) of each output's largest value, on
  samples off the rims: at a sample exactly on the -1 / H rim ``jnp.clip``
  passes half the offset's gradient (``maximum`` splits a tie) and
  PyTorch's ``clamp``, whose conventions the port keeps, all of it;
* ``DCNFn`` on CPU tensors runs ``dcn_bwd_plain`` (``gradcheck`` in
  float64; the port's DCN computes its coordinates and its product in fp32,
  so the finite differences take a step of 1e-3 on offsets kept 0.05 away
  from the cell borders, where the sample is linear in each coordinate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.ops.deform_conv import (
    _exact_dcn)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as tdcn)

AUTOGRAD_TOL = 1e-6
JAX_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, B=2, H=12, W=16, C=8, Cout=6, bias=True, dilation=1,
            rims=True):
    """Inputs of a 3x3 DCN with padding = dilation (the output keeps the
    image's size) and its output gradient, as numpy arrays; ``rims``: some
    samples exactly on the rims, else none (such offsets move by 0.25)."""
    rng = np.random.default_rng(seed)
    K, d = 9, dilation
    x = (0.5 * rng.standard_normal((B, H, W, C))).astype(np.float32)
    off = rng.uniform(-3.5, 3.5, (B, H, W, 2 * K)).astype(np.float32)
    off[:, ::3, ::2] = np.round(off[:, ::3, ::2])   # integer coordinates
    # tap (0, 0) of row / column 0 on the -1 rim, tap (2, 2) of the last
    # row / column on the H / W rim (y = oy - d + 2 d + dy)
    if rims:
        off[:, 0, :, 0] = -1.0 + d
        off[:, :, 0, K] = -1.0 + d
        off[:, -1, :, K - 1] = 1.0 - d
        off[:, :, -1, 2 * K - 1] = 1.0 - d
    else:  # also where the offset rounded to bf16 would land on a rim
        tap = np.arange(K)
        base_y = (np.arange(H)[:, None, None] - d + (tap // 3) * d)[None]
        base_x = (np.arange(W)[None, :, None] - d + (tap % 3) * d)[None]
        for o in (off, torch.from_numpy(off).bfloat16().float().numpy()):
            yy, xx = base_y + o[..., :K], base_x + o[..., K:]
            off[..., :K] += np.where((yy == -1) | (yy == H), 0.25, 0.0)
            off[..., K:] += np.where((xx == -1) | (xx == W), 0.25, 0.0)
    mask = rng.uniform(0.1, 0.9, (B, H, W, K)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, Cout))).astype(np.float32)
    b = (0.1 * rng.standard_normal((Cout,))).astype(np.float32) if bias else None
    g = rng.standard_normal((B, H, W, Cout)).astype(np.float32)
    return x, off, mask, w, b, g


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


CASES = [dict(bias=True, dilation=1), dict(bias=False, dilation=1),
         dict(bias=True, dilation=2), dict(bias=False, dilation=2, C=5,
                                           Cout=3)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_dcn_bwd_plain_matches_autograd_of_dcn_plain(case):
    d = case["dilation"]
    x, off, mask, w, b, g = _inputs(seed=1, **case)
    ins = [_t(a).requires_grad_() if a is not None else None
           for a in (x, off, mask, w, b)]
    out = tdcn.dcn_plain(*ins, d, d)
    want = torch.autograd.grad(out, [t for t in ins if t is not None], _t(g))
    got = tdcn.dcn_bwd_plain(*(_t(a) for a in (x, off, mask, w, b, g)), d, d)
    assert got[0].dtype == torch.float32 and (got[4] is None) == (b is None)
    for name, a, r in zip(NAMES, [t for t in got if t is not None], want):
        assert a.shape == r.shape, name
        assert _rel(a.numpy(), r.numpy()) <= AUTOGRAD_TOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_dcn_bwd_plain_matches_jax_vjp(case, dtype):
    d = case["dilation"]
    x, off, mask, w, b, g = _inputs(seed=2, rims=False, **case)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    primals = [_j(a, jdt) for a in (x, off, mask, w, b) if a is not None]
    fn = lambda *p: _exact_dcn(*p, *(() if b is not None else (None,)), 1, d,
                               d)
    _, vjp = jax.vjp(fn, *primals)
    want = vjp(_j(g, jdt))
    got = tdcn.dcn_bwd_plain(*(_t(a, tdt) for a in (x, off, mask, w, b, g)),
                             d, d)
    assert got[0].dtype == tdt
    for name, a, r in zip(NAMES, [t for t in got if t is not None], want):
        assert _rel(a.float().numpy(), np.asarray(r, np.float32)) <= \
            JAX_TOL[dtype], name


def test_dcn_function_on_cpu_runs_the_plain_backward(monkeypatch):
    """``DCNFn.backward`` on CPU tensors is ``dcn_bwd_plain``, never the
    kernel launcher."""
    x, off, mask, w, _, g = _inputs(seed=3, bias=False)
    seen = []
    plain = tdcn.dcn_bwd_plain
    monkeypatch.setattr(tdcn, "dcn_bwd_plain",
                        lambda *a: seen.append(a) or plain(*a))
    monkeypatch.setattr(tdcn, "dcn_bwd_kernel",
                        lambda *a: pytest.fail("the kernel on a CPU tensor"))
    ins = [_t(a).requires_grad_() for a in (x, off, mask, w)]
    got = torch.autograd.grad(tdcn.DCNFn.apply(*ins, None, 1, 1), ins, _t(g))
    assert len(seen) == 1
    want = plain(*(_t(a) for a in (x, off, mask, w)), None, _t(g))
    for a, r in zip(got, want):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dilation", [1, 2])
def test_dcn_function_gradcheck(dilation):
    d = dilation
    rng = np.random.default_rng(4 + d)
    B, H, W, C, Cout, K = 1, 5, 4, 3, 2, 9
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)))
    # offsets whose samples lie 0.05 or more from the cell borders
    frac = rng.uniform(0.05, 0.95, (B, H, W, 2 * K))
    off = torch.from_numpy(rng.integers(-3, 3, (B, H, W, 2 * K)) + frac)
    mask = torch.from_numpy(rng.uniform(0.1, 0.9, (B, H, W, K)))
    w = torch.from_numpy(0.3 * rng.standard_normal((3, 3, C, Cout)))
    b = torch.from_numpy(0.1 * rng.standard_normal((Cout,)))
    ins = [t.double().requires_grad_() for t in (x, off, mask, w, b)]
    assert torch.autograd.gradcheck(
        lambda *a: tdcn.DCNFn.apply(*a, d, d), ins, eps=1e-3, atol=1e-4,
        rtol=1e-3)
