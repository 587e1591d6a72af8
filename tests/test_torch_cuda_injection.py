"""The kernels of the decoder's injection methods against their plain
PyTorch versions, on the card: the window attention K9 and its backward
K10 (``ops/kernels/window_attention.py``), the deformable convolution K11
(``ops/deform_conv.py``), their autograd Functions, and a tiny model of the
per-scale set by the default route against the plain route.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_injection.py

``chip_smoke.py`` checks the flagship shapes.
"""

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as dc)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    window_attention as wa)

# max|kernel - plain| / max(1, max|plain|)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (n, nk, d): the three window shapes of the main path (the tensor-core
# route in bf16), and one off them (the CUDA-core route in both dtypes)
SHAPES = [(64, 64, 56), (64, 192, 56), (192, 192, 28), (16, 48, 12)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _check(got, want, tol, floor=1.0):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(floor, want.abs().max().item())
    assert err <= tol, err


def _attn_inputs(gen, n, nk, d, dtype, masked, W=8, h=2):
    nW = 4
    q, k, v = (_rnd(gen, W, h, m, d, dtype=dtype) for m in (n, nk, nk))
    bias = _rnd(gen, h, n, nk, scale=0.5)
    mask = None
    if masked:  # the SW-MSA mask's form: 0 or -100, tiled along the keys
        mask = (torch.rand(nW, n, nk, generator=gen, device="cuda") < 0.3
                ).float() * -100.0
    return q, k, v, bias, mask, d ** -0.5, nW


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_kernel(card, dtype, shape, masked):
    args = _attn_inputs(card, *shape, dtype, masked)
    wa.reset_launches()
    got = wa.window_attention(*args)
    assert wa.LAUNCHES["window_attn"] == 1
    _check(got, wa.window_attention_plain(*args), TOL[dtype])


def _strided_inputs(gen, source, dtype, W, masked, nW=4):
    """K9's operands as the unfused blocks hand them over: q / k / v views
    of the projections' outputs and one window's bias and SW-MSA mask.
    ``source``: the decoder's ``to_q`` / ``to_kv`` (None), ``to_kv`` on the
    degradation map (``attention_residual``: the same layout),
    ``attention_kv``'s ``to_k`` / ``to_v`` (192 keys), or the encoder's
    band-major projections at L = 3 (``encoder``, d = 28)."""
    h, d = (1, 28) if source == "encoder" else (2, 56)
    C = h * d
    split = lambda t: t.reshape(W, t.shape[1], h, d).permute(0, 2, 1, 3)
    if source == "encoder":
        band = lambda t: t.reshape(3, W, 64, h, d).permute(1, 3, 0, 2, 4)
        xq, xkv = _rnd(gen, 3, W, 64, C, dtype=dtype), _rnd(gen, 3, W, 64, 2 * C,
                                                            dtype=dtype)
        q, k, v = band(xq), band(xkv[..., :C]), band(xkv[..., C:])
        bias = _rnd(gen, h, 192, 192, scale=0.5)
    elif source == "attention_kv":
        q = split(_rnd(gen, W, 64, C, dtype=dtype))
        k, v = (split(_rnd(gen, W, 192, C, dtype=dtype)) for _ in range(2))
        bias = _rnd(gen, h, 64, 64, scale=0.5)
    else:
        xq, xkv = _rnd(gen, W, 64, C, dtype=dtype), _rnd(gen, W, 64, 2 * C,
                                                         dtype=dtype)
        q, k, v = split(xq), split(xkv[..., :C]), split(xkv[..., C:])
        bias = _rnd(gen, h, 64, 64, scale=0.5)
    mask = None
    if masked:  # the SW-MSA mask of one window: 0 or -100
        mask = (torch.rand(nW, 64, 64, generator=gen, device="cuda") < 0.3
                ).float() * -100.0
    return q, k, v, bias, mask, d ** -0.5, nW


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("source", [None, "attention_residual",
                                    "attention_kv", "encoder"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_reads_the_projections_in_place(card, dtype, source,
                                                         masked):
    """K9 on the views the unfused blocks hand it (the decoder's, the
    ``attention_kv`` and ``attention_residual`` projections, the encoder's
    band regroup) and one window's tables (the mask untiled at ratio 3 and
    at L = 3) against the plain twin on the same operands; on the tensor
    cores (bf16) the output is a view of one token-major buffer, ``[L B',
    n / L, h d]`` as the projection after it reads it."""
    q, k, v, bias, mask, scale, nW = _strided_inputs(card, source, dtype, 8,
                                                     masked)
    path = wa.window_path(q, k, v, bias, mask)
    assert path == ("mma" if dtype == torch.bfloat16 else "cores")
    wa.reset_launches()
    got = wa.window_attention(q, k, v, bias, mask, scale, nW)
    assert wa.LAUNCHES["window_attn"] == 1
    assert got.shape == q.shape
    rows = got.permute(2, 0, 3, 1, 4) if got.dim() == 5 else got.permute(0, 2, 1, 3)
    assert rows.is_contiguous() == (path == "mma")
    _check(got, wa.window_attention_plain(q, k, v, bias, mask, scale, nW),
           TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [1, 31, 997])
@pytest.mark.parametrize("source", [None, "attention_kv", "encoder"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_image_chunks(card, dtype, source, windows):
    """K9's chunks of windows at their edges: 1, 31 and 997 windows (a
    prime: the last chunk is short whatever its size), masked with one
    mask index (every window of it in one CTA's walk) and unmasked."""
    for masked, nW in ((True, 1), (False, 1)):
        q, k, v, bias, mask, scale, nW = _strided_inputs(
            card, source, dtype, windows, masked, nW)
        got = wa.window_attention(q, k, v, bias, mask, scale, nW)
        _check(got, wa.window_attention_plain(q, k, v, bias, mask, scale, nW),
               TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_bwd_kernel(card, dtype, shape, masked):
    """dq, dk, dv on the forward's measure; dbias (a sum over windows) on
    max(1, its largest value); two launches give equal bits."""
    q, k, v, bias, mask, scale, nW = _attn_inputs(card, *shape, dtype, masked)
    g = _rnd(card, *q.shape, dtype=dtype)
    args = (q, k, v, bias, mask, g, scale, nW)
    wa.reset_launches()
    got = wa.window_attention_bwd(*args)
    assert wa.LAUNCHES["window_attn_bwd"] == 1
    want = wa.window_attention_bwd_plain(*args)
    for a, b in zip(got, want):
        _check(a, b, BWD_TOL[dtype])
    again = wa.window_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [997, 1])
@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_bwd_chunk_edges(card, dtype, shape, windows):
    """K10's sums over windows at the edges of its chunking, one head: 997
    windows (a prime: the last chunk of windows is short whatever the
    chunk size, masked), and one window (one chunk, unmasked); in bf16 the
    tensor-core core, in fp32 the CUDA cores; two launches give equal
    bits."""
    n, nk, d = shape
    q, k, v = (_rnd(card, windows, 1, m, d, dtype=dtype) for m in (n, nk, nk))
    bias = _rnd(card, 1, n, nk, scale=0.5)
    mask = None
    if windows > 1:
        mask = (torch.rand(1, n, nk, generator=card, device="cuda") < 0.3
                ).float() * -100.0
    g = _rnd(card, *q.shape, dtype=dtype)
    args = (q, k, v, bias, mask, g, d ** -0.5, 1)
    wa.reset_launches()
    got = wa.window_attention_bwd(*args)
    assert wa.LAUNCHES["window_attn_bwd"] == 1
    for a, b in zip(got, wa.window_attention_bwd_plain(*args)):
        _check(a, b, BWD_TOL[dtype])
    again = wa.window_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_function(card, dtype):
    """The Function (K9 forward, K10 backward) against autograd of the
    plain forward: q, k, v and the bias take gradients, the mask none."""
    q, k, v, bias, mask, scale, nW = _attn_inputs(card, 64, 192, 56, dtype,
                                                  True)
    ins = [t.requires_grad_() for t in (q, k, v, bias)]
    g = _rnd(card, *q.shape, dtype=dtype)
    got = torch.autograd.grad(
        wa.WindowAttentionFn.apply(*ins, mask, scale, nW), ins, g)
    want = torch.autograd.grad(
        wa.window_attention_plain(*ins, mask, scale, nW), ins, g)
    for a, b in zip(got, want):
        _check(a, b, {torch.float32: 5e-4, torch.bfloat16: 6e-2}[dtype])


def _dcn_inputs(gen, B, H, C, Cout, dtype):
    x = _rnd(gen, B, H, H, C, dtype=dtype)
    # offsets up to +-3.5, past the image edge at the rim
    offset = (torch.rand(B, H, H, 18, generator=gen, device="cuda") * 7 - 3.5
              ).to(dtype)
    mask = torch.rand(B, H, H, 9, generator=gen, device="cuda").to(dtype)
    weight = _rnd(gen, 3, 3, C, Cout, scale=(9 * C) ** -0.5, dtype=dtype)
    bias = _rnd(gen, Cout, scale=0.1)
    return x, offset, mask, weight, bias


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", [None, 2.0])
@pytest.mark.parametrize("C", [16, 112, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dcn_kernel(card, dtype, C, clamp):
    x, offset, mask, weight, bias = _dcn_inputs(card, 2, 12, C, C, dtype)
    for b in (bias, None):
        dc.reset_launches()
        got = dc.dcn(x, offset, mask, weight, b, clamp=clamp)
        assert dc.LAUNCHES["dcn"] == 1
        _check(got, dc.dcn_plain(x, offset, mask, weight, b, clamp=clamp),
               TOL[dtype])


@pytest.mark.cuda
def test_dcn_function(card):
    """DCNFn: K11 forward, autograd of the plain version backward."""
    ins = [t.requires_grad_() for t in _dcn_inputs(card, 2, 12, 16, 16,
                                                   torch.float32)]
    g = _rnd(card, 2, 12, 12, 16)
    got = torch.autograd.grad(dc.DCNFn.apply(*ins, 1, 1), ins, g)
    want = torch.autograd.grad(dc.dcn_plain(*ins, 1, 1), ins, g)
    for a, b in zip(got, want):
        _check(a, b, 5e-4)


def _liven(bundle, seed=3):
    """Random DCN offset heads and lamb, so that they matter."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in bundle.decoder.named_parameters():
            if "conv_offset_mask" in name:
                r = (torch.rand(p.shape, generator=gen) * 7 - 3.5
                     if name.endswith("bias")
                     else 0.1 * torch.randn(p.shape, generator=gen))
                p.copy_(r)
            elif name.endswith(".lamb"):
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))


@pytest.mark.cuda
@pytest.mark.parametrize("methods", [
    ["residual", "modulator", "self_modulator", "deform_conv", "attention_kv"],
    ["attention_residual", "all_DC"],
    ["all_3_bands"]])
def test_tiny_model_default_route_against_plain(card, methods):
    """Eval forward fp32 and one training backward of a tiny model (P=32,
    widths 8, two blocks per stage) by the default route against the plain
    route; K9 and, with deform_conv, K11 launch in the forward, K10 in the
    backward. all_3_bands with the learnable lamb modulates the attention
    probabilities in every decoder block: those take the plain core, as in
    JAX, and no block of that model launches K9."""
    runs_k9 = methods != ["all_3_bands"]
    extra = dict(learnable_modulator=True) if "residual" in methods else {}
    if methods == ["all_3_bands"]:
        extra = dict(frequency_decompose_type="DC")
    cfg = config.make_config(
        encoder_type="Uformer", decoder_type="Uformer", L=3,
        encoder_msa_type="freq", patch_size=32, encoder_embed_dim=8,
        embed_dim=8, uformer_depth_cap=2, degradation_embedding_method=methods,
        seed=0, drop_path=0.0, dtype="float32", **extra)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)).cuda()
    outs = {}
    for impl in ("default", "plain"):
        bundle = airnet.build_models(cfg, "cuda", impl)
        _liven(bundle)
        wa.reset_launches()
        dc.reset_launches()
        outs[impl] = airnet.eval_forward(bundle, x)
        counts = {**wa.LAUNCHES, **dc.LAUNCHES}
        if impl == "plain":
            assert not any(counts.values())
        else:
            assert (counts["window_attn"] > 0) == runs_k9
            assert (counts["dcn"] > 0) == ("deform_conv" in methods)
    _check(outs["default"], outs["plain"], 1e-3)

    grads = {}
    for impl in ("default", "plain"):
        bundle = airnet.build_models(cfg, "cuda", impl, eval_mode=False)
        _liven(bundle)
        wa.reset_launches()
        ctx = bundle.encoder.features(x)
        out = bundle.decoder(x, ctx)
        out.square().mean().backward()
        if impl == "default":
            assert (wa.LAUNCHES["window_attn_bwd"] > 0) == runs_k9
        grads[impl] = {n: p.grad for n, p in bundle.decoder.named_parameters()
                       if p.grad is not None}
    assert set(grads["default"]) == set(grads["plain"])
    gmax = max(float(g.abs().max()) for g in grads["plain"].values())
    for n, g in grads["plain"].items():
        err = float((grads["default"][n] - g).abs().max())
        assert err <= 1e-2 * max(float(g.abs().max()), 1e-3 * gmax), n
