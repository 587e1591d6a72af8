"""The window attention's operand layout on the CPU: K9 reads q / k / v in
place through a stride descriptor (``ops/kernels/window_attention.py::
descriptor``) and takes the bias and the SW-MSA mask as one window's tables.

* The descriptor of each view the unfused blocks hand K9 (the decoder's
  ``to_q`` / ``to_kv`` slices for every ``kv_source``, ``attention_kv``'s
  ``to_k`` / ``to_v``, the encoder's band-major q / k / v at L = 3),
  applied through ``torch.as_strided``, gives exactly the tensors the
  ``.contiguous()`` / band-regroup path made; the output's descriptor gives
  the token-major layout the projection after it reads.
* The plain twin on untiled tables equals it on the tiled ones bit for bit
  (forward, probabilities, backward, the Function's gradients).
* ``WindowAttention.attend`` / ``FrequencyWindowAttention.attend`` give the
  same bits through the views as through the old copies.

Torch only, on one thread: seconds.
"""

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_blocks as tblocks)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    windows)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    window_attention as wa)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _through_descriptor(t: torch.Tensor) -> torch.Tensor:
    """The operand as K9 reads it: its descriptor applied to its storage,
    the bands joined, ``[W, h, n, d]``."""
    sw, sh, sb, st, nb = wa.descriptor(t)
    W, h, d = t.shape[0], t.shape[1], t.shape[-1]
    L = t.shape[2] if t.dim() == 5 else 1
    view = torch.as_strided(t, (W, h, L, nb, d), (sw, sh, sb, st, 1),
                            t.storage_offset())
    return view.reshape(W, h, L * nb, d)


def _randomize(module: torch.nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)


def _decoder_inputs(kv_source, b=2, nw=4, n=16, dkv=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b * nw, n, 16, generator=g)
    attn_kv = None
    if kv_source == "attention_residual":
        attn_kv = torch.randn(b * nw, n, dkv, generator=g)
    elif kv_source == "attention_kv":
        attn_kv = tuple(torch.randn(b * nw, 3, 3 * n, dkv // 3, generator=g)
                        for _ in range(2))
    return x, attn_kv


@pytest.mark.parametrize("kv_source", [None, "attention_residual",
                                       "attention_kv"])
def test_descriptor_reads_the_decoder_projections(kv_source):
    """q / k / v as ``LinearProjection`` makes them (views of the linear
    layers' outputs): the descriptor reads exactly what ``.contiguous()``
    copied."""
    m = tblocks.WindowAttention(16, 4, 2, num_win=4, kv_source=kv_source,
                                dim_kv=12)
    _randomize(m, 1)
    x, attn_kv = _decoder_inputs(kv_source)
    with torch.no_grad():
        q, k, v = m.qkv(x, 2, torch.float32, attn_kv)
    assert not q.is_contiguous()
    for t in (q, k, v):
        assert torch.equal(_through_descriptor(t), t.contiguous())
    assert k.shape[2] == (48 if kv_source == "attention_kv" else 16)


@pytest.mark.parametrize("kind", ["intra", "inter"])
def test_descriptor_reads_the_encoder_bands(kind):
    """The encoder's q / k / v at L = 3, taken band by band within a window
    (``[B*nW, h, L, n, d]`` views of the band-major projections): the
    descriptor reads exactly the old regroup's ``[B*nW, h, L*n, d]``."""
    L, b_, n, h, c = 3, 3 * 8, 16, 2, 16
    m = tblocks.FrequencyWindowAttention(c, 4, h, L, kind)
    _randomize(m, 2)
    x = torch.randn(b_, n, c, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        q, k, v = m.qkv(x, h, torch.float32)
    regroup = lambda t: (t.reshape(L, b_ // L, h, n, -1)
                         .permute(1, 2, 0, 3, 4).reshape(b_ // L, h, L * n, -1))
    band = lambda t: t.reshape(L, b_ // L, h, n, -1).permute(1, 2, 0, 3, 4)
    for t in (q, k, v):
        view = band(t)
        assert view.data_ptr() == t.data_ptr()  # a view, no copy
        assert torch.equal(_through_descriptor(view), regroup(t))
        assert torch.equal(wa.grouped(view), regroup(t))


@pytest.mark.parametrize("L", [1, 3])
def test_output_descriptor_is_the_projection_layout(L):
    """K9 writes its output token-major ``[L, W, n / L, h, d]``: the view
    it returns reads back through its descriptor as the ``[W, h, n, d]``
    result, and ``_core``'s rows are that buffer as it lies, the layout the
    old permute / band un-regroup made."""
    W, h, nb, d = 4, 2, 16, 8
    buf = torch.randn(L, W, nb, h, d, generator=torch.Generator().manual_seed(4))
    o5 = buf.permute(1, 3, 0, 2, 4)
    want = o5.reshape(W, h, L * nb, d)
    assert torch.equal(_through_descriptor(o5), want)
    rows = o5.permute(2, 0, 3, 1, 4).reshape(L * W, nb, h * d)
    assert rows.data_ptr() == buf.data_ptr() and rows.is_contiguous()
    old = (want.permute(0, 2, 1, 3).reshape(W, L * nb, h * d)
           .reshape(W, L, nb, h * d).transpose(0, 1).reshape(L * W, nb, h * d))
    assert torch.equal(rows, old)


def _tables(h, n, nk, nW, seed=5):
    """One window's bias [h, n, 64] and SW-MSA mask [nW, 64, 64]."""
    g = torch.Generator().manual_seed(seed)
    bias = torch.randn(h, n, 64, generator=g) * 0.5
    mask = torch.from_numpy(windows.shift_attn_mask(16, 16, 8, 4))
    assert mask.shape == (nW, 64, 64)
    return bias, mask


@pytest.mark.parametrize("n,nk", [(64, 192), (192, 192)])
def test_untiled_tables_match_the_tiled_bit_for_bit(n, nk):
    """The plain twin tiles the window's bias (along the keys at ratio 3)
    and mask (over the keys, and over the bands at L = 3) inside itself:
    forward, probabilities and backward equal the tiled tables' bit for
    bit."""
    h, nW, W, d = 2, 4, 8, 8
    bias, mask = _tables(h, n, nk, nW)
    if n == 192:  # the encoder's grouped bias stays one [h, L n, L n] table
        bias = bias.repeat(1, 1, 3)
    g = torch.Generator().manual_seed(6)
    q, k, v, go = (torch.randn(W, h, m, d, generator=g) for m in (n, nk, nk, n))
    tb, tm = bias.repeat(1, 1, nk // bias.shape[-1]), mask.repeat(
        1, n // 64, nk // 64)
    args, targs = (bias, mask, d ** -0.5, nW), (tb, tm, d ** -0.5, nW)
    assert torch.equal(wa.window_attention_plain(q, k, v, *args),
                       wa.window_attention_plain(q, k, v, *targs))
    assert torch.equal(wa.probabilities(q, k, *args),
                       wa.probabilities(q, k, *targs))
    got = wa.window_attention_bwd_plain(q, k, v, bias, mask, go, d ** -0.5, nW)
    want = wa.window_attention_bwd_plain(q, k, v, tb, tm, go, d ** -0.5, nW)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    folded = want[3].reshape(h, n, nk // bias.shape[-1], bias.shape[-1]).sum(2)
    assert got[3].shape == bias.shape and torch.equal(got[3], folded)


def test_function_through_banded_views_matches_autograd():
    """``WindowAttentionFn`` on banded views and untiled tables (the
    encoder's form) against autograd of the plain forward on the joined,
    tiled operands: outputs equal, gradients to 1e-6."""
    W, h, L, nb, d, nW = 4, 2, 3, 64, 8, 4
    g = torch.Generator().manual_seed(7)
    base = [torch.randn(L, W, nb, h * d, generator=g) for _ in range(3)]
    _, mask = _tables(h, 64, 64, nW)
    bias = torch.randn(h, L * nb, L * nb, generator=g) * 0.5
    go = torch.randn(W, h, L, nb, d, generator=g)
    views = [t.requires_grad_() for t in base]
    band = lambda t: t.reshape(L, W, nb, h, d).permute(1, 3, 0, 2, 4)
    out = wa.WindowAttentionFn.apply(*(band(t) for t in views), bias, mask,
                                     d ** -0.5, nW)
    got = torch.autograd.grad(out, views, go)
    joined = [band(t).reshape(W, h, L * nb, d) for t in views]
    want_out = wa.window_attention_plain(*joined, bias, mask.repeat(1, L, L),
                                         d ** -0.5, nW)
    want = torch.autograd.grad(want_out, views, go.reshape(W, h, L * nb, d))
    assert torch.equal(out.reshape(W, h, L * nb, d), want_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_source", [None, "attention_residual",
                                       "attention_kv"])
def test_window_attention_attend_equals_the_copies(kv_source):
    """``WindowAttention.attend`` (shifted windows, untiled tables, the core
    on views) against the old path: the operands made contiguous and the
    bias and mask tiled along the keys, bit for bit."""
    m = tblocks.WindowAttention(16, 8, 2, num_win=4, kv_source=kv_source,
                                dim_kv=12)
    _randomize(m, 8)
    x, attn_kv = _decoder_inputs(kv_source, n=64)
    mask = torch.from_numpy(windows.shift_attn_mask(16, 16, 8, 4))
    with torch.no_grad():
        got, _ = m.attend(x, attn_kv, None, mask)
        q, k, v = m.qkv(x, 2, torch.float32, attn_kv)
        bias = windows.gather_relative_bias(m.relative_position_bias_table,
                                            m.relative_position_index)
        r = k.shape[2] // 64
        out = wa.window_attention_plain(
            q.contiguous(), k.contiguous(), v.contiguous(),
            bias.repeat(1, 1, r), mask.repeat(1, 1, r), 8 ** -0.5, 4)
        want = tblocks._linear(m.proj, out.permute(0, 2, 1, 3).reshape(
            x.shape[0], 64, 16), torch.float32)
    assert torch.equal(got, want)


def test_frequency_attend_equals_the_regroup():
    """``FrequencyWindowAttention.attend`` (L = 3, shifted windows) against
    the old path: q / k / v regrouped into copies, the mask tiled (L, L),
    the output un-regrouped, bit for bit; the returned K / V are the
    regrouped ones."""
    L, b, nw, n, h, c = 3, 1, 4, 64, 2, 16
    m = tblocks.FrequencyWindowAttention(c, 8, h, L, "inter")
    _randomize(m, 9)
    b_ = L * b * nw
    x = torch.randn(b_, n, c, generator=torch.Generator().manual_seed(10))
    mask = torch.from_numpy(windows.shift_attn_mask(16, 16, 8, 4))
    with torch.no_grad():
        got, (gk, gv) = m.attend(x, mask)
        q, k, v = m.qkv(x, h, torch.float32)
        regroup = lambda t: (t.reshape(L, b_ // L, h, n, -1)
                             .permute(1, 2, 0, 3, 4).reshape(b_ // L, h, L * n, -1))
        q, k, v = regroup(q), regroup(k), regroup(v)
        out = wa.window_attention_plain(q, k, v, m._grouped(m._per_pair()),
                                        mask.repeat(1, L, L), (c // h) ** -0.5,
                                        nw)
        out = out.permute(0, 2, 1, 3).reshape(b_ // L, L * n, c)
        out = out.reshape(b_ // L, L, n, c).transpose(0, 1).reshape(b_, n, c)
        want = tblocks._linear(m.proj, out, torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(gk, k) and torch.equal(gv, v)
    _, none = m.attend(x, mask, kv=False)
    assert none is None


def _route_case(dtype, n, nk, d, bc, tile, strided=True, offset=0):
    W, h = 4, 2
    C = h * d
    base = torch.zeros(W * max(n, nk) * 2 * C + offset, dtype=dtype)[offset:]
    def view(m):
        t = base[:W * m * 2 * C].reshape(W, m, 2 * C)[..., :C]
        t = t.reshape(W, m, h, d).permute(0, 2, 1, 3)
        return t if strided else t.contiguous()
    mask = None if tile is None else torch.zeros(4, *tile)
    return view(n), view(nk), view(nk), torch.zeros(h, n, bc), mask


@pytest.mark.parametrize("case,path", [
    ((torch.bfloat16, 64, 64, 56, 64, None), "mma"),
    ((torch.bfloat16, 64, 64, 56, 64, (64, 64)), "mma"),
    ((torch.bfloat16, 64, 192, 56, 64, (64, 64)), "mma"),
    ((torch.bfloat16, 64, 192, 56, 192, (64, 192)), "mma"),
    ((torch.bfloat16, 192, 192, 28, 192, (64, 64)), "mma"),
    ((torch.bfloat16, 192, 192, 28, 192, (192, 192)), "cores"),  # too big
    ((torch.bfloat16, 64, 192, 56, 64, (64, 192)), "cores"),      # mixed
    ((torch.float32, 64, 64, 56, 64, (64, 64)), "cores"),
    ((torch.bfloat16, 16, 48, 12, 48, None), "cores"),
    ((torch.bfloat16, 64, 64, 52, 64, None), "cores"),  # rows of 104 bytes
])
def test_window_path_chooser(case, path):
    """K9 runs on the tensor cores at the main path's shapes, in bf16, with
    the blocks' tables and operands that allow wide copies; elsewhere on the
    CUDA cores."""
    q, k, v, bias, mask = _route_case(*case)
    assert wa.window_path(q, k, v, bias, mask) == path


def test_window_path_needs_aligned_operands():
    """An operand one element off 16-byte alignment goes to the CUDA cores."""
    q, k, v, bias, mask = _route_case(torch.bfloat16, 64, 64, 56, 64, None,
                                      offset=1)
    assert wa.window_path(q, k, v, bias, mask) == "cores"
    q, k, v, bias, mask = _route_case(torch.bfloat16, 64, 64, 56, 64, None,
                                      strided=False)
    assert wa.window_path(q, k, v, bias, mask) == "mma"


def test_launcher_rejects_cpu_views():
    """K9's launcher takes CUDA tensors only, views included."""
    q = torch.randn(2, 16, 2, 8).permute(0, 2, 1, 3)
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_kernel(q, q, q, bias, None, 0.3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wa.descriptor(torch.randn(2, 2, 8, 16).transpose(-1, -2))
    assert list(wa.descriptor(q)) == [256, 8, 256, 16, 16]
