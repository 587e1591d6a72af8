"""LeWin transformer block and stage layer (the port of the JAX
``models/uformer_lewin.py`` fused-block paths).

Every block runs through the block kernels (``ops/kernels/lewin_block.py``)
by one of two routes, or through their plain twins on the CPU:

* the chain: origin MSA as K1 -> K2, frequency MSA as K1 (intra) -> K3
  (inter) -> K2, with the SW-MSA cyclic roll as ``torch.roll`` around the
  attention half (JAX uformer_lewin.py:163-170, 227-238);
* merged: the whole block as one K4 / K5 launch on the true-layout image,
  the roll inside the kernel (JAX uformer_lewin.py:150-161, 214-225).

The JAX package picks the route per stage from gates measured on the TPU;
here :data:`DEFAULT_MERGED` and :data:`MERGED_MIN_TOKENS` hold what an H100
measured (``chip_smoke.py`` phase 3, PERF.md section 6).

With gradients enabled a block goes through the autograd Functions of
``ops/kernels/lewin_block.py`` (``BlockAttention``, ``FreqIntra``,
``FreqInter``, ``BlockFFN``, ``BlockMerged``, ``BlockFreqMerged``) on the raw
parameters in the kernels' entry layouts, so that autograd carries the
kernels' gradients back into the bias tables, ``to_q`` / ``to_kv``, and the
all_DC gain MLP. The Functions save the block's input (and ``u``, ``y1``
for the merged routes) only and the backward kernels recompute the rest,
which is what rematerialisation buys the JAX package. Without gradients the
cached kernel operands stay the fast path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import windows
from ..ops.kernels import lewin_block as lb
from .layers import DropPath, to_image, to_tokens
from .uformer_blocks import FrequencyWindowAttention, LeFF, WindowAttention


IMPLS = ("default", "kernel", "merged", "plain")

# The blocks ``impl='default'`` runs as one merged kernel: (msa_type, stage
# resolution, shifted, compute dtype), on a batch of at least
# MERGED_MIN_TOKENS tokens (images x res^2); every other block, and a
# smaller batch, takes the chain. From the per-block A/B on an H100 at
# B = 4, 16 and 32 (``chip_smoke.py`` phase 3; PERF.md section 6, "merged
# against chain"): in bf16 the merged kernel is ahead (0.85-0.94 of the
# chain's time) where it absorbs the two roll passes of a shifted block at
# the byte-bound stages, from 32768 tokens up (res 32 at B=32, res 64 at
# B=16, res 128 at B=4); at 16384 tokens it ties or loses (1.00-1.07), below
# that it loses, and so it does at every other block. In float32 at the eval
# entry point's batch it is within 5% of the chain or behind at every stage,
# so float32 keeps the chain.
DEFAULT_MERGED = frozenset(
    ("origin", res, True, torch.bfloat16) for res in (128, 64, 32))
MERGED_MIN_TOKENS = 32768


class LeWinBlock(nn.Module):
    """One (S)W-MSA + LeFF block. ``impl='kernel'`` launches the chain of
    kernels on a CUDA tensor, with each module's cached kernel operands,
    ``'merged'`` the one merged kernel, ``'default'`` what
    :data:`DEFAULT_MERGED` names for the block and the batch; all three run
    the plain twins on a CPU tensor, as the kernel entry points do.
    ``'plain'`` runs the plain twins everywhere, for comparisons."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 win_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 msa_type: str = "origin", L: int = 1,
                 all_bands_dc: bool = False, encoder_embed_dim: int = 28,
                 impl: str = "kernel"):
        super().__init__()
        res = input_resolution
        self.res = res
        self.win = min(win_size, res)
        self.shift = shift_size if res > win_size else 0
        self.msa_type, self.L = msa_type, L
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.impl = impl
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if msa_type == "freq":
            self.attn_intra = FrequencyWindowAttention(dim, self.win, num_heads,
                                                       L, "intra")
            self.attn_inter = FrequencyWindowAttention(dim, self.win, num_heads,
                                                       L, "inter")
        elif msa_type == "origin":
            self.attn = WindowAttention(dim, self.win, num_heads, all_bands_dc,
                                        encoder_embed_dim)
        else:
            raise ValueError(f"invalid msa_type: {msa_type!r}")
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = LeFF(dim, int(dim * mlp_ratio))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        mask = None
        if self.shift > 0:
            mask = torch.from_numpy(
                windows.shift_attn_mask(res, res, self.win, self.shift))
        self.register_buffer("attn_mask", mask, persistent=False)

    def route(self, dtype: torch.dtype, batch: int) -> str:
        """'kernel', 'merged' or 'plain': what a CUDA tensor of ``batch``
        images in ``dtype`` runs through."""
        if self.impl != "default":
            return self.impl
        key = (self.msa_type, self.res, self.shift > 0, dtype)
        merged = (key in DEFAULT_MERGED
                  and batch * self.res * self.res >= MERGED_MIN_TOKENS)
        return "merged" if merged else "kernel"

    def forward(self, x: torch.Tensor, all_inter=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x [B, N, C]`` tokens in the compute dtype -> same shape."""
        b, dt = x.shape[0], x.dtype
        win, shift, L, mask = self.win, self.shift, self.L, self.attn_mask
        dps1 = self.drop_path1.scale(b, x.device, generator)
        dps2 = self.drop_path2.scale(b, x.device, generator)
        route = self.route(dt, b)
        on_card = route != "plain" and x.is_cuda
        img = to_image(x, self.res, self.res)
        n1 = (self.norm1.weight, self.norm1.bias)
        n2 = (self.norm2.weight, self.norm2.bias)
        if torch.is_grad_enabled() and route != "plain":
            return to_tokens(self._forward_functions(
                img, route == "merged", all_inter, n1, n2, dps1, dps2))
        if on_card and route == "merged":
            ffn = self.mlp.kernel_operands(dt)
            if self.msa_type == "freq":
                y = lb.freq_merged_kernel(
                    img, *n1, self.attn_intra.kernel_operands(dt),
                    self.attn_inter.kernel_operands(dt), mask, *n2, ffn, L,
                    win, shift, 1e-6, dps1, dps2)
            else:
                lam = None
                if self.attn.all_bands_dc:
                    lam = self.attn.lam(all_inter, dt)
                y = lb.merged_kernel(img, *n1, self.attn.kernel_operands(dt),
                                     mask, lam, *n2, ffn, win, shift, 1e-6,
                                     dps1, dps2)
            return to_tokens(y)
        if shift > 0:
            img = torch.roll(img, (-shift, -shift), dims=(1, 2))
        if self.msa_type == "freq":
            # the intra + inter MSA output is the DropPath branch; its
            # shortcut is added in the inter kernel, so dps1 applies there
            intra, inter = self.attn_intra, self.attn_inter
            if on_card:
                y1 = lb.attention_kernel(img, *n1, intra.kernel_operands(dt),
                                         mask, None, win, 1e-6, False, L, None)
                y = lb.freq_inter_kernel(y1, img, inter.kernel_operands(dt),
                                         mask, L, win, dps1)
            else:
                y1 = lb.freq_intra_plain(img, *n1, *intra.kernel_weights(),
                                         mask, L, win)
                y = lb.freq_inter_plain(y1, img, *inter.kernel_weights(), mask,
                                        L, win, 1e-6, dps1)
        else:
            lam = None
            if self.attn.all_bands_dc:
                lam = self.attn.lam(all_inter, dt)
            if on_card:
                y = lb.attention_kernel(img, *n1, self.attn.kernel_operands(dt),
                                        mask, lam, win, 1e-6, True, 1, dps1)
            else:
                y = lb.block_attention_plain(img, *n1, *self.attn.kernel_weights(),
                                             mask, lam, win, 1e-6, dps1)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if on_card:
            y = lb.ffn_kernel(y, *n2, self.mlp.kernel_operands(dt), 1e-6, dps2)
        else:
            y = lb.block_ffn_plain(y, *n2, *self.mlp.kernel_weights(), 1e-6,
                                   dps2)
        return to_tokens(y)


    def _forward_functions(self, img, merged: bool, all_inter, n1, n2, dps1,
                           dps2) -> torch.Tensor:
        """The block through the autograd Functions (kernels on a CUDA
        tensor, twins on a CPU tensor), on the image ``[B, H, W, C]``."""
        win, shift, L, mask = self.win, self.shift, self.L, self.attn_mask
        ffn = self.mlp.kernel_weights()
        if self.msa_type == "freq":
            intra = self.attn_intra.kernel_weights()
            inter = self.attn_inter.kernel_weights()
            if merged:
                return lb.BlockFreqMerged.apply(
                    img, *n1, *intra, *inter, mask, *n2, *ffn, L, win, shift,
                    1e-6, dps1, dps2)
            rolled = lb.roll(img, shift)
            y1 = lb.FreqIntra.apply(rolled, *n1, *intra, mask, L, win, 1e-6)
            y = lb.FreqInter.apply(y1, rolled, *inter, mask, L, win, 1e-6,
                                   dps1)
        else:
            lam = None
            if self.attn.all_bands_dc:
                lam = self.attn.lam(all_inter, img.dtype)
            attn = self.attn.kernel_weights()
            if merged:
                return lb.BlockMerged.apply(img, *n1, *attn, mask, lam, *n2,
                                            *ffn, win, shift, 1e-6, dps1, dps2)
            y = lb.BlockAttention.apply(lb.roll(img, shift), *n1, *attn, mask,
                                        lam, win, 1e-6, dps1)
        return lb.BlockFFN.apply(lb.roll(y, -shift), *n2, *ffn, 1e-6, dps2)


class BasicUformerLayer(nn.Module):
    """A stage of LeWin blocks ``block0..``; odd blocks shifted by win // 2
    (encoder_Uformer.py:687-743)."""

    def __init__(self, dim: int, input_resolution: int, depth: int,
                 num_heads: int, win_size: int = 8, mlp_ratio: float = 4.0,
                 drop_path: Sequence[float] = (), msa_type: str = "origin",
                 L: int = 1, all_bands_dc: bool = False,
                 encoder_embed_dim: int = 28, impl: str = "kernel"):
        super().__init__()
        dp = list(drop_path) or [0.0] * depth
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", LeWinBlock(
                dim, input_resolution, num_heads, win_size,
                shift_size=win_size // 2 if i % 2 == 1 else 0,
                mlp_ratio=mlp_ratio, drop_path=dp[i] if i < len(dp) else dp[-1],
                msa_type=msa_type, L=L, all_bands_dc=all_bands_dc,
                encoder_embed_dim=encoder_embed_dim, impl=impl))

    def forward(self, x, all_inter=None, generator=None):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, all_inter, generator)
        return x
