"""Uformer building blocks needed by the flagship eval forward (the port of
the JAX ``models/uformer_blocks.py``, fused-block path).

The attention and LeFF modules are parameter holders: their submodule and
parameter names mirror the Flax tree (``qkv.to_q``, ``qkv.to_kv``,
``relative_position_bias_table(s)``, ``proj``, ``linear1``, ``dwconv``,
``linear2``) and they hand the block kernels their weights in the JAX
kernel layouts (``wq3 [h, C, d]``, ``wp3 [h, d, C]``, ``w1 [C, Hd]``,
``wd [3, 3, Hd]``). Parameters stay float32 and are cast to the compute
dtype at use, as Flax does with ``param_dtype=float32``. On the card they
hand over their weights once more in the kernels' own formats
(``kernel_operands``), made once per dtype and kept until a parameter
changes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import windows
from ..ops.kernels import lewin_block
from .layers import leaky_relu, to_image, to_tokens


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
    by a move to other storage (``.to(device)``)."""

    make_operands = staticmethod(lewin_block.attn_operands)

    def __init__(self):
        super().__init__()
        self._operands = {}

    def kernel_operands(self, dtype: torch.dtype):
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
    """q / kv projections (self-attention form): ``to_q`` C->C and
    ``to_kv`` C->2C (reference decoder_Uformer.py:80-125)."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, 2 * dim)

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


class WindowAttention(KernelParams):
    """Parameter holder of the origin-MSA window attention with the
    optional all_DC gain MLP (reference decoder_Uformer.py:128-299; JAX
    ``_FusedAttnParams``)."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 all_bands_dc: bool = False, encoder_embed_dim: int = 28):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = LinearProjection(dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * win_size - 1) ** 2, num_heads))
        self.all_bands_dc = all_bands_dc
        if all_bands_dc:
            g = encoder_embed_dim * 16
            self.lamb_norm_1 = nn.LayerNorm(g, eps=1e-6)
            self.lamb_head_1 = nn.Linear(g, num_heads)
            self.lamb_mlp_1_0 = nn.Linear(num_heads, num_heads)
            self.lamb_mlp_1_1 = nn.Linear(num_heads, num_heads)
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

    def lam(self, all_inter, dtype: torch.dtype) -> torch.Tensor:
        """all_DC per-head gain ``[B, h]`` from the band-1 degradation
        embedding, in plain torch (decoder_Uformer.py:279-288)."""
        g = self.lamb_norm_1(all_inter[1].float())
        g = _linear(self.lamb_head_1, g, dtype).mean(dim=1, keepdim=True)
        g = leaky_relu(_linear(self.lamb_mlp_1_0, g, dtype))
        g = _linear(self.lamb_mlp_1_1, g, dtype)
        return g.reshape(-1, self.num_heads)


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
        idx = self.relative_position_index
        n = idx.shape[0]
        tables = self.relative_position_bias_tables
        per_pair = (windows.gather_rows(tables, idx.reshape(-1))
                    .reshape(L * L, n, n, h).permute(0, 3, 1, 2))  # [L*L, h, n, n]
        if self.kind == "intra":
            bias = per_pair[torch.arange(L) * (L + 1)]
        else:
            bias = (per_pair.reshape(L, L, h, n, n).permute(2, 0, 3, 1, 4)
                    .reshape(h, L * n, L * n)) + self.band_mask
        c = self.proj.in_features
        wp3 = self.proj.weight.t().reshape(h, c // h, c)
        return (*self.qkv.per_head(h), wp3, self.proj.bias, bias)


class LeFF(KernelParams):
    """Parameter holder of the locally-enhanced FFN: Linear C->Hd, 3x3
    depthwise conv, Linear Hd->C (reference leff.py:71-117)."""

    make_operands = staticmethod(lewin_block.ffn_operands)

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def kernel_weights(self):
        """``(w1 [C, Hd], b1, wd [3, 3, Hd], bd, w2 [Hd, C], b2)``."""
        return (self.linear1.weight.t(), self.linear1.bias,
                self.dwconv.weight[:, 0].permute(1, 2, 0), self.dwconv.bias,
                self.linear2.weight.t(), self.linear2.bias)


class Downsample(nn.Module):
    """4x4 stride-2 conv, padding 1, on tokens (encoder_Uformer.py:425-441)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 4, stride=2, padding=1)

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
