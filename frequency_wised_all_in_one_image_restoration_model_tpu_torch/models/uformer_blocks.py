"""Uformer building blocks (the port of the JAX ``models/uformer_blocks.py``).

The attention and LeFF modules are parameter holders of the block kernels:
their submodule and parameter names mirror the Flax tree (``qkv.to_q``, ``qkv.to_kv``,
``relative_position_bias_table(s)``, ``proj``, ``linear1``, ``dwconv``,
``linear2``) and they hand the block kernels their weights in the JAX
kernel layouts (``wq3 [h, C, d]``, ``wp3 [h, d, C]``, ``w1 [C, Hd]``,
``wd [3, 3, Hd]``). Parameters stay float32 and are cast to the compute
dtype at use, as Flax does with ``param_dtype=float32``. On the card they
hand over their weights once more in the kernels' own formats
(``kernel_operands``), made once per dtype and kept until a parameter
changes.

They also run the unfused LeWin block (JAX ``uformer_lewin.py:244-354``),
which the decoder's degradation-injection methods, the learnable modulator
and the encoder's ``need_kv`` blocks take: :meth:`WindowAttention.attend`
and :meth:`FrequencyWindowAttention.attend` project q / k / v and call the
window-attention core, K9 (``ops/kernels/window_attention.py``), or the
plain core where the attention probabilities are needed (the band
modulations); :meth:`LeFF.composite` is the LeFF as torch ops, with the
deformable convolution K11 (``ops/deform_conv.py``) in its ``deform_conv``
form. Under :func:`.capture.capture` the attention modules form the
probabilities in plain PyTorch and record their maps, as JAX's do when
their intermediates are mutable.

The modules no configuration of the CLI builds (JAX reaches them by
building a block or a stage directly): :class:`SepConv2d` /
:class:`ConvProjection` (``token_projection='conv'``), :class:`ECA1d`
(``LeFF(use_eca=True)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import frequency, windows
from ..ops.deform_conv import DCNFn, dcn_plain
from ..ops.kernels import lewin_block
from ..ops.kernels import window_attention as wa
from . import capture
from .layers import gelu, lecun_normal_, leaky_relu, to_image, to_tokens


def _conv_nhwc(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype,
               transpose: bool = False) -> torch.Tensor:
    """Apply a torch (transposed) conv to an NHWC image in ``dtype``."""
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    x = x.to(dtype).permute(0, 3, 1, 2)
    if transpose:
        y = F.conv_transpose2d(x, w, b, stride=conv.stride)
    else:
        y = F.conv2d(x, w, b, stride=conv.stride, padding=conv.padding,
                     groups=conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


class KernelParams(nn.Module):
    """A parameter holder of a block kernel. ``kernel_operands(dtype)``
    hands over ``kernel_weights()`` in the kernel's own formats
    (``make_operands``), made once per dtype and again only after a
    parameter changes, in place (``load_state_dict``, an optimiser step) or
    by a move to other storage (``.to(device)``).

    While ``torch.export`` traces a served program (``serving.py``) the
    operands are inputs of that program: ``served_operands`` holds them and
    ``kernel_operands`` hands them over as they are (a traced tensor has no
    address to key a cache on)."""

    make_operands = staticmethod(lewin_block.attn_operands)

    def __init__(self):
        super().__init__()
        self._operands = {}
        self.served_operands = None

    def cached_dtypes(self):
        """The dtypes whose operands this holder has made."""
        return tuple(self._operands)

    def kernel_operands(self, dtype: torch.dtype):
        if self.served_operands is not None:
            return self.served_operands
        if torch.compiler.is_exporting():
            raise RuntimeError(f"{type(self).__name__}: a traced program takes "
                               "the kernels' operands as inputs "
                               "(served_operands)")
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        hit = self._operands.get(dtype)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                made = self.make_operands(*self.kernel_weights(), dtype)
            hit = self._operands[dtype] = (stamp, made)
        return hit[1]


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LinearProjection(nn.Module):
    """q / kv projections (reference decoder_Uformer.py:80-125): ``to_q``
    C->C and, by ``kv_source``,

    * None: ``to_kv`` C->2C on x (self-attention);
    * ``'attention_residual'``: ``to_kv`` dim_kv->2C on the windowed
      degradation map;
    * ``'attention_kv'``: ``to_k`` / ``to_v`` dim_kv->C on the encoder's
      saved last-block K / V with their heads folded back into channels.
    """

    def __init__(self, dim: int, kv_source: Optional[str] = None,
                 dim_kv: Optional[int] = None):
        super().__init__()
        self.kv_source = kv_source
        self.to_q = nn.Linear(dim, dim)
        if kv_source == "attention_kv":
            self.to_k = nn.Linear(dim_kv, dim)
            self.to_v = nn.Linear(dim_kv, dim)
        else:
            kv_in = dim_kv if kv_source == "attention_residual" else dim
            self.to_kv = nn.Linear(kv_in, 2 * dim)

    def forward(self, x, heads: int, dtype: torch.dtype, attn_kv=None):
        """``x [B', n, C]`` -> q ``[B', h, n, d]``, k, v ``[B', h, nk, d]`` in
        ``dtype`` (JAX ``LinearProjection.__call__``)."""
        b, n, c = x.shape
        d = c // heads
        split = lambda t: t.reshape(b, t.shape[1], heads, d).permute(0, 2, 1, 3)
        q = split(_linear(self.to_q, x, dtype))
        if self.kv_source == "attention_kv":
            # (K, V) [B', h_enc, nk, d_enc] -> [B', nk, h_enc * d_enc]
            fold = lambda t: t.permute(0, 2, 1, 3).reshape(
                t.shape[0], t.shape[2], -1)
            k_in, v_in = attn_kv
            return (q, split(_linear(self.to_k, fold(k_in), dtype)),
                    split(_linear(self.to_v, fold(v_in), dtype)))
        kv_in = attn_kv if self.kv_source == "attention_residual" else x
        kv = _linear(self.to_kv, kv_in, dtype)
        return q, split(kv[..., :c]), split(kv[..., c:])

    def per_head(self, heads: int):
        """``(wq3, bq3, wk3, bk3, wv3, bv3)`` in the kernels' per-head
        layout ``[h, C, d]`` / ``[h, d]`` (views, no copies)."""
        c = self.to_q.in_features
        d = c // heads
        split = lambda w: w.t().reshape(c, heads, d).permute(1, 0, 2)
        wkv, bkv = self.to_kv.weight, self.to_kv.bias
        return (split(self.to_q.weight), self.to_q.bias.reshape(heads, d),
                split(wkv[:c]), bkv[:c].reshape(heads, d),
                split(wkv[c:]), bkv[c:].reshape(heads, d))


def _core(q, k, v, bias, mask, nW: int, plain: bool) -> torch.Tensor:
    """The window-attention core on ``q [B', h, n, d]``, ``k, v [B', h, nk,
    d]`` (views; or banded ``[B', h, L, n / L, d]``), the bias and the mask
    as one window's tables: K9 through its autograd Function (the plain
    function on a CPU tensor), or the plain function for ``plain``.
    ``[L B', n / L, h d]`` in q's dtype, the bands major: on the card K9's
    own output, no copy."""
    scale = q.shape[-1] ** -0.5
    if plain:
        out = wa.window_attention_plain(q, k, v, bias, mask, scale, nW)
    else:
        out = wa.WindowAttentionFn.apply(q, k, v, bias, mask, scale, nW)
    if out.dim() == 4:
        out = out.unsqueeze(2)
    b_, h, L, n, d = out.shape
    return out.permute(2, 0, 3, 1, 4).reshape(L * b_, n, h * d)


def _reapply(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Modulated probabilities ``[B', h, n, nk]`` fp32 times v, rounded as
    the JAX ``_reapply_attention``: ``[B', n, h * d]`` in v's dtype."""
    b_, h, n, _ = attn.shape
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.permute(0, 2, 1, 3).reshape(b_, n, -1).to(v.dtype)


class SepConv2d(nn.Module):
    """Depthwise ``kernel x kernel`` conv, ReLU, pointwise 1x1 conv
    (reference encoder_Uformer.py:16-43; JAX ``SepConv2d``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.depthwise = nn.Conv2d(in_ch, in_ch, kernel, stride=stride,
                                   padding=(kernel - stride) // 2,
                                   groups=in_ch)
        self.pointwise = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x [B, H, W, C]`` -> ``[B, H', W', out_ch]`` in ``dtype``."""
        y = F.relu(_conv_nhwc(self.depthwise, x, dtype))
        return _conv_nhwc(self.pointwise, y, dtype)


class ConvProjection(nn.Module):
    """Separable-conv q / k / v projection (reference
    encoder_Uformer.py:47-76; JAX ``ConvProjection``): ``to_q`` on the
    window's tokens as an image, ``to_k`` / ``to_v`` on the key source
    (the window itself, or ``attn_kv`` of ``kv_dim`` channels)."""

    def __init__(self, dim: int, kv_dim: Optional[int] = None):
        super().__init__()
        kv_dim = kv_dim or dim
        self.to_q = SepConv2d(dim, dim)
        self.to_k = SepConv2d(kv_dim, dim)
        self.to_v = SepConv2d(kv_dim, dim)

    def forward(self, x, heads: int, dtype: torch.dtype, attn_kv=None):
        """``x [B', n, C]`` -> q, k, v ``[B', h, n, d]`` in ``dtype``, as
        :meth:`LinearProjection.forward`."""
        b, n, c = x.shape
        side = math.isqrt(n)
        kv = x if attn_kv is None else attn_kv
        img = lambda t: to_image(t, side, side)
        split = lambda t: to_tokens(t).reshape(b, n, heads, c // heads) \
            .permute(0, 2, 1, 3)
        return (split(self.to_q(img(x), dtype)), split(self.to_k(img(kv), dtype)),
                split(self.to_v(img(kv), dtype)))


class WindowAttention(KernelParams):
    """Window attention with the relative-position bias (reference
    decoder_Uformer.py:128-299; JAX ``WindowAttention``, and its
    ``_FusedAttnParams`` twin for the block kernels), with the decoder's
    extensions:

    * ``all_bands_dc``: the all_DC per-head gain, an MLP of the encoder's
      band-1 feature (``lamb_*_1``; an exact rank-1 correction when the
      keys are the window's own tokens);
    * ``all_bands_num = N``: the ``all_<N>_bands`` modulation, band i of
      the probabilities scaled by the gain of band feature i, i = 1..N-1;
    * ``lamb_bands_num`` / ``lamb_bands_dc``: the learnable per-band gain
      ``lamb [N-1, 1, h]`` of ``frequency_decompose_type``;
    * ``kv_source``: see :class:`LinearProjection`;
    * ``token_projection='conv'``: q / k / v by :class:`ConvProjection`
      (unfused blocks only; the key source as JAX passes it, the window or
      the ``attention_residual`` map).
    """

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 all_bands_dc: bool = False, encoder_embed_dim: int = 28,
                 num_win: int = 1, kv_source: Optional[str] = None,
                 dim_kv: Optional[int] = None,
                 all_bands_num: Optional[int] = None,
                 lamb_bands_num: Optional[int] = None,
                 lamb_bands_dc: bool = False,
                 token_projection: str = "linear"):
        super().__init__()
        self.num_heads, self.num_win = num_heads, num_win
        if token_projection == "conv":
            if kv_source == "attention_kv":
                raise ValueError("token_projection='conv' takes no encoder "
                                 "(K, V): the JAX ConvProjection reads the "
                                 "key source as an image")
            self.qkv = ConvProjection(
                dim, dim_kv if kv_source == "attention_residual" else None)
        else:
            self.qkv = LinearProjection(dim, kv_source, dim_kv)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * win_size - 1) ** 2, num_heads))
        self.all_bands_dc = all_bands_dc
        self.all_bands_num = 2 if all_bands_dc else all_bands_num
        self.lamb_bands_num, self.lamb_bands_dc = lamb_bands_num, lamb_bands_dc
        if lamb_bands_num is not None:
            nb = 2 if lamb_bands_dc else lamb_bands_num
            self.lamb = nn.Parameter(torch.zeros(nb - 1, 1, num_heads))
        g = encoder_embed_dim * 16
        for i in range(1, self.all_bands_num or 1):
            self.add_module(f"lamb_norm_{i}", nn.LayerNorm(g, eps=1e-6))
            self.add_module(f"lamb_head_{i}", nn.Linear(g, num_heads))
            self.add_module(f"lamb_mlp_{i}_0", nn.Linear(num_heads, num_heads))
            self.add_module(f"lamb_mlp_{i}_1", nn.Linear(num_heads, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index", torch.from_numpy(
            windows.relative_position_index(win_size, win_size)),
            persistent=False)

    def kernel_weights(self):
        """``(wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, bias [h, n, n])``."""
        h = self.num_heads
        c = self.proj.in_features
        bias = windows.gather_relative_bias(self.relative_position_bias_table,
                                            self.relative_position_index)
        wp3 = self.proj.weight.t().reshape(h, c // h, c)
        return (*self.qkv.per_head(h), wp3, self.proj.bias, bias)

    def gain(self, i: int, all_inter, dtype: torch.dtype) -> torch.Tensor:
        """The per-head gain ``[B, 1, h]`` of band feature ``i``
        (decoder_Uformer.py:279-288; JAX ``band_gain``)."""
        g = getattr(self, f"lamb_norm_{i}")(all_inter[i].float())
        g = _linear(getattr(self, f"lamb_head_{i}"), g, dtype)
        g = leaky_relu(_linear(getattr(self, f"lamb_mlp_{i}_0"),
                               g.mean(dim=1, keepdim=True), dtype))
        return _linear(getattr(self, f"lamb_mlp_{i}_1"), g, dtype)

    def lam(self, all_inter, dtype: torch.dtype) -> torch.Tensor:
        """all_DC per-head gain ``[B, h]`` from the band-1 degradation
        embedding, in plain torch (decoder_Uformer.py:279-288)."""
        return self.gain(1, all_inter, dtype).reshape(-1, self.num_heads)

    def attend(self, xw, attn_kv=None, all_inter=None, mask=None,
               plain: bool = False):
        """The unfused attention (JAX ``WindowAttention.__call__``) on the
        windows ``xw [B*nW, n, C]`` in the compute dtype: ``(out [B*nW, n,
        C], (k, v))``. The core is K9 unless the band modulations need the
        probabilities, or a capture covers the module, where it is the plain
        core as in JAX; a capture records ``attn_map`` and the gains
        ``embed_lamb_<i>``."""
        b_, n, c = xw.shape
        h, dt = self.num_heads, xw.dtype
        q, k, v = self.qkv(xw, h, dt, attn_kv)
        nk = k.shape[2]
        bias = windows.gather_relative_bias(self.relative_position_bias_table,
                                            self.relative_position_index)
        # keys longer than the window (encoder_Uformer.py:161-162): the
        # window's bias and mask stand for their tiling along the keys
        nW = mask.shape[0] if mask is not None else 1
        nb = self.all_bands_num
        dc_fast = self.all_bands_dc and n == nk
        capturing = capture.active(self) is not None
        if (self.lamb_bands_num is None and (nb is None or dc_fast)
                and not capturing):
            out = _core(q, k, v, bias, mask, nW, plain)
        else:
            attn = wa.probabilities(q, k, bias, mask, (c // h) ** -0.5, nW)
            out = _reapply(attn, v)

        if self.lamb_bands_num is not None:
            if self.lamb_bands_dc:
                bands = frequency.frequency_decompose_dc(attn)
            else:
                bands = frequency.frequency_decompose(attn, self.lamb_bands_num)
            attn = attn + (bands[1:] * self.lamb[:, :, :, None, None]).sum(0)
            out = _reapply(attn, v)

        if nb is not None and dc_fast:
            # attn + (attn - 1/n) lam applied to v: a rescale and a rank-1 term
            g = self.gain(1, all_inter, dt)
            capture.record(self, "embed_lamb_1", g)
            lam = g.reshape(-1, h).float()
            lam = lam.repeat_interleave(self.num_win, dim=0)[:, :, None, None]
            v_sum = v.float().sum(dim=2)[:, :, None, :]
            out_h = out.reshape(b_, n, h, -1).permute(0, 2, 1, 3).float()
            out_h = out_h * (1.0 + lam) - (lam / n) * v_sum
            out = out_h.permute(0, 2, 1, 3).reshape(b_, n, c).to(dt)
        elif nb is not None:
            if self.all_bands_dc:
                bands = frequency.frequency_decompose_dc(attn)
            else:
                bands = frequency.frequency_decompose_1(attn, nb - 1)
            new = attn
            for i in range(1, nb):
                g = self.gain(i, all_inter, dt)
                capture.record(self, f"embed_lamb_{i}", g)
                band = (bands[i].reshape(-1, self.num_win, h, n, n)
                        * g.float()[:, :, :, None, None])
                new = new + band.reshape(-1, h, n, n)
            attn = new
            out = _reapply(attn, v)
        if capturing:
            capture.record(self, "attn_map", attn)
        return _linear(self.proj, out, dt), (k, v)


class FrequencyWindowAttention(KernelParams):
    """Parameter holder of the intra/inter frequency-band window attention
    (reference encoder_Uformer.py:190-313; JAX ``_FusedFreqAttnParams``)."""

    def __init__(self, dim: int, win_size: int, num_heads: int, L: int,
                 kind: str):
        super().__init__()
        if kind not in ("intra", "inter"):
            raise ValueError(f"kind must be intra/inter, got {kind!r}")
        self.num_heads, self.L, self.kind = num_heads, L, kind
        self.qkv = LinearProjection(dim)
        self.relative_position_bias_tables = nn.Parameter(
            torch.zeros(L * L, (2 * win_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        n = win_size * win_size
        self.register_buffer("relative_position_index", torch.from_numpy(
            windows.relative_position_index(win_size, win_size)),
            persistent=False)
        self.register_buffer("band_mask", torch.from_numpy(
            windows.band_mask(L, n, kind)), persistent=False)

    def kernel_weights(self):
        """Per-head weights plus the per-band diagonal tables ``[L, h, n, n]``
        ('intra') or the grouped bias ``[h, L*n, L*n]`` with the band mask
        folded in ('inter')."""
        h, L = self.num_heads, self.L
        per_pair = self._per_pair()                  # [L*L, h, n, n]
        if self.kind == "intra":
            bias = per_pair[torch.arange(L) * (L + 1)]
        else:
            bias = self._grouped(per_pair)
        c = self.proj.in_features
        wp3 = self.proj.weight.t().reshape(h, c // h, c)
        return (*self.qkv.per_head(h), wp3, self.proj.bias, bias)

    def make_operands(self, *weights):
        """The kernels' operands; an 'inter' holder's also carry its per-pair
        tables, which the fused K3 reads in place of the grouped bias."""
        op = lewin_block.attn_operands(*weights)
        return op._replace(pairs=self.pairs()) if self.kind == "inter" else op

    def pairs(self):
        """The per-pair tables ``[L*L, (2 win - 1)^2, h]`` fp32, detached."""
        return self.relative_position_bias_tables.detach().float().contiguous()

    def _per_pair(self):
        h, L = self.num_heads, self.L
        idx = self.relative_position_index
        n = idx.shape[0]
        return (windows.gather_rows(self.relative_position_bias_tables,
                                    idx.reshape(-1))
                .reshape(L * L, n, n, h).permute(0, 3, 1, 2))

    def _grouped(self, per_pair):
        """The L x L tables as one ``[h, L*n, L*n]`` bias, band mask added."""
        L, h, n = self.L, self.num_heads, per_pair.shape[-1]
        return (per_pair.reshape(L, L, h, n, n).permute(2, 0, 3, 1, 4)
                .reshape(h, L * n, L * n)) + self.band_mask

    def attend(self, xw, mask=None, plain: bool = False, kv: bool = True):
        """The unfused attention (JAX ``FrequencyWindowAttention.__call__``,
        :431-459) on the band-folded windows ``xw [L*B*nW, n, C]``: q / k / v
        taken band by band within a window (views ``[B*nW, h, L, n, d]``,
        bands major), the band-masked grouped bias, the SW-MSA mask of one
        window standing for its (L, L) tiling, the core K9, whose output is
        already band-folded. ``(out [L*B*nW, n, C], (k, v))`` with k, v
        regrouped to ``[B*nW, h, L*n, d]`` (``kv``; else None). Under a
        capture the core is the plain one on the band-grouped map, which it
        records as ``attn_map`` (JAX :448-453)."""
        b_, n, c = xw.shape
        h, L, dt = self.num_heads, self.L, xw.dtype
        q, k, v = self.qkv(xw, h, dt)
        band = lambda t: (t.reshape(L, b_ // L, h, n, -1)
                          .permute(1, 2, 0, 3, 4))
        q, k, v = band(q), band(k), band(v)
        bias = self._grouped(self._per_pair())
        nW = 1 if mask is None else mask.shape[0]
        if capture.active(self) is not None:
            attn = wa.probabilities(wa.grouped(q), wa.grouped(k), bias, mask,
                                    (c // h) ** -0.5, nW)
            capture.record(self, "attn_map", attn)
            out = _reapply(attn, wa.grouped(v))     # [B*nW, L*n, C]
            out = out.reshape(b_ // L, L, n, c).transpose(0, 1).reshape(b_, n, c)
        else:
            out = _core(q, k, v, bias, mask, nW, plain)
        return (_linear(self.proj, out, dt),
                (wa.grouped(k), wa.grouped(v)) if kv else None)


class ECA1d(nn.Module):
    """1-D efficient channel attention (reference leff.py:44-69; JAX
    ``ECA1d``): the token mean of each channel, a ``k_size`` conv across
    the channels (zero padded), a sigmoid gate. ``conv`` is the raw
    parameter as JAX declares it, ``[k, 1, 1]`` (HIO)."""

    def __init__(self, k_size: int = 3):
        super().__init__()
        self.conv = nn.Parameter(torch.zeros(k_size, 1, 1))

    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's LeCun-normal, fan-in ``k``."""
        with torch.no_grad():
            lecun_normal_(self.conv, self.conv.shape[0], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, N, C]`` -> same shape and dtype."""
        dt = x.dtype
        k = self.conv.shape[0]
        y = x.mean(dim=1)[:, None, :]                       # [B, 1, C]
        y = F.conv1d(y, self.conv.reshape(1, 1, k).to(dt), padding=(k - 1) // 2)
        return x * torch.sigmoid(y)


class LeFF(KernelParams):
    """Locally-enhanced FFN: Linear C->Hd, GELU, 3x3 depthwise conv, GELU,
    Linear Hd->C (reference leff.py:71-117), the parameter holder of K2.
    With ``deform=True`` (the ``deform_conv`` injection, leff.py:79-83,
    103-107) the depthwise conv is :class:`DCNLayerLeFF`, conditioned on
    the degradation map through ``linear_inter``; the reference narrows
    the hidden width to C for it (decoder_Uformer.py:600-601). With
    ``use_eca`` :class:`ECA1d` gates the output (:meth:`composite` only: no
    block builds it, as in JAX)."""

    make_operands = staticmethod(lewin_block.ffn_operands)

    def __init__(self, dim: int, hidden: int, deform: bool = False,
                 degradation_dim: int = -1, use_eca: bool = False):
        super().__init__()
        self.deform = deform
        self.linear1 = nn.Linear(dim, hidden)
        if deform:
            self.linear_inter = nn.Linear(degradation_dim, hidden)
            self.dcn = DCNLayerLeFF(hidden, hidden)
        else:
            self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.linear2 = nn.Linear(hidden, dim)
        if use_eca:
            self.eca = ECA1d()

    def kernel_weights(self):
        """``(w1 [C, Hd], b1, wd [3, 3, Hd], bd, w2 [Hd, C], b2)``."""
        return (self.linear1.weight.t(), self.linear1.bias,
                self.dwconv.weight[:, 0].permute(1, 2, 0), self.dwconv.bias,
                self.linear2.weight.t(), self.linear2.bias)

    def composite(self, x, inter=None, plain: bool = False):
        """The LeFF as torch ops on tokens ``x [B, N, C]`` in the compute
        dtype (JAX ``LeFF.__call__``); the deformable convolution is K11
        unless ``plain``."""
        side = int(round(x.shape[1] ** 0.5))
        dt = x.dtype
        img = to_image(gelu(_linear(self.linear1, x, dt)), side, side)
        if self.deform:
            g = to_image(gelu(_linear(self.linear_inter, inter, dt)), side, side)
            img = self.dcn(img, g, plain)
        else:
            img = _conv_nhwc(self.dwconv, img, dt)
        y = _linear(self.linear2, to_tokens(gelu(img)), dt)
        return self.eca(y) if hasattr(self, "eca") else y


class DCNLayerLeFF(nn.Module):
    """The modulated deformable 3x3 conv inside the ``deform_conv`` LeFF
    (JAX ``DCNLayerLeFF``): ``conv_offset_mask`` on ``cat(x, inter)`` gives
    the 18 offsets and 9 modulation logits, zero at init. ``weight`` is the
    raw parameter as JAX declares it, HWIO ``[k, k, Cin, Cout]`` drawn from
    U[0, 2 stdv); the convolution uses ``weight - stdv``."""

    def __init__(self, channels_in: int, channels_out: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.pad = (k - 1) // 2
        self.stdv = 1.0 / math.sqrt(channels_in * k * k)
        self.conv_offset_mask = nn.Conv2d(2 * channels_in, 3 * k * k, k,
                                          padding=self.pad)
        self.weight = nn.Parameter(torch.zeros(k, k, channels_in, channels_out))

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX's initialisers: a zero offset head, a uniform weight."""
        with torch.no_grad():
            self.conv_offset_mask.weight.zero_()
            self.conv_offset_mask.bias.zero_()
            self.weight.uniform_(0.0, 2 * self.stdv, generator=generator)

    def forward(self, x, inter, plain: bool = False):
        """``x, inter [B, H, W, C]`` in the compute dtype -> ``[B, H, W, Cout]``."""
        dt = x.dtype
        om = _conv_nhwc(self.conv_offset_mask, torch.cat([x, inter], -1), dt)
        o1, o2, m = om.chunk(3, dim=-1)
        offset = torch.cat([o1, o2], -1)
        mask = torch.sigmoid(m).contiguous()
        weight = (self.weight - self.stdv).to(dt)
        if plain:
            return dcn_plain(x, offset, mask, weight, None, self.pad)
        return DCNFn.apply(x.contiguous(), offset, mask, weight, None,
                           self.pad, 1)


class SelfModulatedLayerNorm(nn.Module):
    """Affine-free LayerNorm (eps 1e-3) then ``(1 + gamma) x + beta`` with
    gamma, beta linear in the degradation map (reference
    net/utils/self_modulated_layernorm.py:8-26; JAX :791-806)."""

    def __init__(self, dim: int, degradation_dim: int):
        super().__init__()
        self.mlp_gamma = nn.Linear(degradation_dim, dim)
        self.mlp_beta = nn.Linear(degradation_dim, dim)

    def forward(self, x, inter, dtype: torch.dtype) -> torch.Tensor:
        gamma = _linear(self.mlp_gamma, inter, dtype)
        beta = _linear(self.mlp_beta, inter, dtype)
        out = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-3)
        return out.to(dtype) * (1.0 + gamma) + beta


class Downsample(nn.Module):
    """Strided conv on tokens, padding (kernel - 1) // 2: 4x4 stride 2
    between stages (encoder_Uformer.py:425-441), 1x1 stride res // win for
    the decoder's degradation modulator (decoder_Uformer.py:414-430)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 4,
                 stride: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=(kernel - 1) // 2)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        side = int(round(x.shape[1] ** 0.5))
        return to_tokens(_conv_nhwc(self.conv, to_image(x, side, side), dtype))


class Upsample(nn.Module):
    """2x2 stride-2 transposed conv on tokens (encoder_Uformer.py:445-460).
    torch's kernel is the spatial flip of Flax's ConvTranspose kernel; the
    weight converter flips it."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        side = int(round(x.shape[1] ** 0.5))
        return to_tokens(_conv_nhwc(self.deconv, to_image(x, side, side),
                                    dtype, transpose=True))


class InputProj(nn.Module):
    """3x3 conv + LeakyReLU(0.01) -> tokens (encoder_Uformer.py:464-483)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return to_tokens(leaky_relu(_conv_nhwc(self.proj, x, dtype), 0.01))


class OutputProj(nn.Module):
    """tokens -> 3x3 conv image (encoder_Uformer.py:487-510)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        side = int(round(x.shape[1] ** 0.5))
        return _conv_nhwc(self.proj, to_image(x, side, side), dtype)
