"""LeWin transformer block and stage layer (the port of the JAX
``models/uformer_lewin.py``).

A block that carries none of the decoder's degradation-injection methods,
no learnable modulator, no band modulation that needs the attention
probabilities and no ``need_kv`` (exactly where JAX takes its fused path,
uformer_lewin.py:97-109, 177-186) runs through the block kernels
(``ops/kernels/lewin_block.py``) by one of two routes, or through their
plain twins on the CPU:

* the chain: origin MSA as K1 -> K2, frequency MSA as K1 (intra) -> K3
  (inter) -> K2, with the SW-MSA cyclic roll as ``torch.roll`` around the
  attention half (JAX uformer_lewin.py:163-170, 227-238);
* merged: the whole block as one K4 / K5 launch on the true-layout image,
  the roll inside the kernel (JAX uformer_lewin.py:150-161, 214-225);
* split (origin MSA): K12 -> K13, the attention half with its q / k / v
  blocks and the FFN half as a sum over hidden blocks, each product's
  reduction cut into fp32 partials (the Pallas split kernels, which JAX
  takes for fp32 at C = 896 under ``FAIRM_SPLIT_KERNELS``,
  lewin_block.py:341-372).

The JAX package picks the route per stage from gates measured on the TPU;
here :data:`DEFAULT_MERGED` and :data:`DEFAULT_SPLIT` hold what an H100
measured (``chip_smoke.py`` phases 3 and 13, PERF.md section 6).

With gradients enabled a block goes through the autograd Functions of
``ops/kernels/lewin_block.py`` (``BlockAttention``, ``FreqIntra``,
``FreqInter``, ``BlockFFN``, ``BlockMerged``, ``BlockFreqMerged``) on the raw
parameters in the kernels' entry layouts, so that autograd carries the
kernels' gradients back into the bias tables, ``to_q`` / ``to_kv``, and the
all_DC gain MLP. The Functions save the block's input (and ``u``, ``y1``
for the merged routes) only and the backward kernels recompute the rest,
which is what rematerialisation buys the JAX package. Without gradients the
cached kernel operands stay the fast path.

Every other block is unfused, as in JAX (uformer_lewin.py:244-354): torch
ops around the window-attention kernel K9 (``WindowAttention.attend``,
``FrequencyWindowAttention.attend``; its autograd Function under
gradients) and, for ``deform_conv``, the deformable convolution K11 in the
LeFF. The decoder's methods:

* ``self_modulator``: :class:`SelfModulatedLayerNorm` for norm1 / norm2,
  conditioned on the degradation map (``norm{1,2}_deg_norm``);
* ``modulator``: the degradation map strided to one window and
  concat-embedded into every window (``degradation_modulator*``);
* ``deform_conv``: the LeFF's depthwise conv becomes a DCN, hidden C;
* ``attention_residual``: the windowed degradation map is the key / value
  source (``attn_deg_norm``);
* ``attention_kv``: the encoder's saved last-block K / V are;
* the learnable ``modulator`` parameter ``[win^2, C]`` added to every
  window (``--learnable_modulator``).

Two fields no configuration of the CLI sets make a block unfused too, as
in JAX (uformer_lewin.py:101-102, 181-182; reached by building a block or
a stage directly): ``token_projection='conv'`` (q / k / v by separable
convolutions, ``uformer_blocks.ConvProjection``; the frequency-wise MSA
keeps its linear projection, as JAX's does) and ``token_mlp`` ``'ffn'`` /
``'mlp'`` (the token MLP ``layers.Mlp`` for the LeFF). A block under
:func:`.capture.capture` takes the unfused path as well (JAX's
``is_mutable_collection('intermediates')``), decided at run time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import windows
from ..ops.kernels import lewin_block as lb
from . import capture
from .layers import DropPath, Mlp, leaky_relu, lecun_normal_, to_image, to_tokens
from .uformer_blocks import (Downsample, FrequencyWindowAttention, LeFF,
                             SelfModulatedLayerNorm, WindowAttention, _linear)


IMPLS = ("default", "kernel", "merged", "split", "plain")

# The blocks ``impl='default'`` runs as one merged kernel, each from a least
# batch in tokens (images x res^2): (msa_type, stage resolution, shifted,
# compute dtype, width C) -> tokens; every other block, and a smaller batch,
# takes the chain. From the per-block A/B on an H100 at B = 4, 16 and 32
# (``chip_smoke.py`` phase 3; PERF.md section 6, "merged against chain"):
# with K4's products on the TMA / wgmma tile and, up to C = 224, its
# attention half fused on the SM, the merged kernel is ahead for the
# shifted bf16 decoder blocks at res 32 (C = 224 at every batch, merged /
# chain 0.74-0.92; C = 448 from B = 16, 0.87-0.97). Once the LeFF's hidden
# is kept in fp32 (it doubles the merged kernel's hidden bytes, not the
# chain's), the chain is ahead at res 64 and res 128, C = 112, at every
# batch (1.06-1.09), and at res 64, C = 224, below B = 32 (1.02-1.03 at
# B = 4 and 16, 0.96 at B = 32). It is behind at res 128 C = 56 (1.14), for
# every unshifted block (no roll to absorb: 1.03-1.57) and near even at
# res 16. In float32 it is behind at every stage (1.01-1.39), so float32
# keeps the chain. The encoder's frequency blocks (tokens of the band-folded
# batch, 3 x tiles x res^2) run K5's band-group form, which equals the chain
# bit for bit, where both A/Bs put it ahead of the chain K1 -> K3 -> K2
# with its rolls (PERF.md section 6, PR 15): per block
# (``tools/bwd_kernel_profile.py --k5``) the shifted blocks at res 128 and
# 64 from B = 4 (0.81-0.93 of the chain) and res 32 from B = 16, shifted
# and not (0.80-0.95; behind at B = 4); the flagship's joint step with
# gradients (``tools/e2e_ab.py --k5-routes``) at B = 32 (about 3% faster),
# not at B = 4 (host-paced, unresolved), so the entries start at B = 32
# (96 band images). K5 is behind for the unshifted blocks at res 128 and 64
# (1.01-1.12). Its twelve phases (res 16 and 8, float32) are not in the
# table: phase 3's A/B has them ahead at res 16 in bf16 (0.67-1.00) and
# behind or mixed elsewhere, and no step A/B was run for them.
DEFAULT_MERGED = {
    ("origin", 32, True, torch.bfloat16, 224): 4096,
    ("origin", 32, True, torch.bfloat16, 448): 16384,
    ("origin", 64, True, torch.bfloat16, 224): 131072,
    ("freq", 128, True, torch.bfloat16, 28): 1572864,
    ("freq", 64, True, torch.bfloat16, 56): 393216,
    ("freq", 32, False, torch.bfloat16, 112): 98304,
    ("freq", 32, True, torch.bfloat16, 112): 98304,
}

# The origin-MSA blocks ``impl='default'`` runs as K12 -> K13: (width C,
# compute dtype, stage resolution) -> the least batch in tokens (images x
# res^2) that takes them; a smaller batch, and every other block, takes the
# chain. From the per-block A/B of the split kernels against the chain on
# an H100 at the C = 896 stages, res 8 and 16, 64 ... 8192 tokens, fp32 and
# bf16 (``chip_smoke.py`` phase 13; PERF.md section 6, "split against
# chain", PR 13): in fp32 the split kernels (on their FMA core) are ahead
# at every batch measured (0.16-0.68 of the chain's time, from one image);
# in bf16 they are ahead at res 16 from 4096 tokens (0.91-0.95) and behind
# at res 16 below that (1.01-1.17) and at res 8 (1.13-1.42).
DEFAULT_SPLIT = {
    (896, torch.float32, 8): 64,
    (896, torch.float32, 16): 256,
    (896, torch.bfloat16, 16): 4096,
}


class LeWinBlock(nn.Module):
    """One (S)W-MSA + LeFF block. ``impl='kernel'`` launches the chain of
    kernels on a CUDA tensor, with each module's cached kernel operands,
    ``'merged'`` the one merged kernel, ``'split'`` K12 -> K13 (origin
    MSA), ``'default'`` what :data:`DEFAULT_MERGED` and
    :data:`DEFAULT_SPLIT` (with their least batches) name for the block and
    the batch; all four run the plain twins on a CPU tensor, as the kernel
    entry points do.
    ``'plain'`` runs the plain twins everywhere, for comparisons. With
    gradients enabled a split block runs the chain's autograd Functions:
    the split kernels have no backward of their own, as in JAX."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 win_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 msa_type: str = "origin", L: int = 1,
                 all_bands_dc: bool = False, encoder_embed_dim: int = 28,
                 impl: str = "kernel", need_kv: bool = False,
                 modulator: bool = False, injection: Sequence[str] = (),
                 degradation_dim: int = -1,
                 all_bands_num: Optional[int] = None,
                 lamb_bands_num: Optional[int] = None,
                 lamb_bands_dc: bool = False, token_mlp: str = "leff",
                 token_projection: str = "linear"):
        super().__init__()
        res = input_resolution
        self.res, self.dim = res, dim
        self.win = min(win_size, res)
        self.shift = shift_size if res > win_size else 0
        self.msa_type, self.L = msa_type, L
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if msa_type not in ("origin", "freq"):
            raise ValueError(f"invalid msa_type: {msa_type!r}")
        self.impl = impl
        self.injection = tuple(injection)
        self.need_kv, self.use_modulator = need_kv, modulator
        # JAX's fused_ok / fused_freq_ok (uformer_lewin.py:97-109, 177-186)
        self.unfused = bool(
            modulator or need_kv or self.injection
            or token_projection != "linear" or token_mlp in ("ffn", "mlp")
            or (msa_type == "origin"
                and (lamb_bands_num is not None
                     or (all_bands_num is not None and not all_bands_dc))))
        win, deg = self.win, degradation_dim
        if "self_modulator" in self.injection:
            self.norm1_deg_norm = nn.LayerNorm(deg, eps=1e-6)
            self.norm1 = SelfModulatedLayerNorm(dim, deg)
        else:
            self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if modulator:
            self.modulator = nn.Parameter(torch.zeros(win * win, dim))
        if "modulator" in self.injection:
            self.degradation_modulator = Downsample(deg, dim, kernel=1,
                                                    stride=res // win)
            self.degradation_modulator_norm = nn.LayerNorm(dim, eps=1e-6)
            self.degradation_modulator_embed = nn.Linear(2 * dim, dim)
        if "attention_residual" in self.injection:
            self.attn_deg_norm = nn.LayerNorm(deg, eps=1e-6)
        if msa_type == "freq":
            self.attn_intra = FrequencyWindowAttention(dim, win, num_heads,
                                                       L, "intra")
            self.attn_inter = FrequencyWindowAttention(dim, win, num_heads,
                                                       L, "inter")
        else:
            kv_source = next((m for m in ("attention_residual", "attention_kv")
                              if m in self.injection), None)
            self.attn = WindowAttention(
                dim, win, num_heads, all_bands_dc, encoder_embed_dim,
                num_win=(res // win) ** 2, kv_source=kv_source, dim_kv=deg,
                all_bands_num=all_bands_num, lamb_bands_num=lamb_bands_num,
                lamb_bands_dc=lamb_bands_dc, token_projection=token_projection)
        if "self_modulator" in self.injection:
            self.norm2_deg_norm = nn.LayerNorm(deg, eps=1e-6)
            self.norm2 = SelfModulatedLayerNorm(dim, deg)
        else:
            self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if token_mlp in ("ffn", "mlp"):
            self.mlp = Mlp(dim, int(dim * mlp_ratio))
        elif "deform_conv" in self.injection:
            self.mlp = LeFF(dim, dim, deform=True, degradation_dim=deg)
        else:
            self.mlp = LeFF(dim, int(dim * mlp_ratio))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        mask = None
        if self.shift > 0:
            mask = torch.from_numpy(
                windows.shift_attn_mask(res, res, self.win, self.shift))
        self.register_buffer("attn_mask", mask, persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX's initialisers where they differ from the model-wide rule:
        the learnable modulator N(0, 1), the modulator embedding Dense
        LeCun-normal (Flax's default)."""
        with torch.no_grad():
            if self.use_modulator:
                self.modulator.normal_(0.0, 1.0, generator=generator)
            if "modulator" in self.injection:
                w = self.degradation_modulator_embed.weight
                lecun_normal_(w, w.shape[1], generator)

    def route(self, dtype: torch.dtype, batch: int) -> str:
        """'kernel', 'merged', 'split' or 'plain': what a CUDA tensor of
        ``batch`` images in ``dtype`` runs through. The split kernels take
        origin-MSA blocks only: a frequency-MSA block takes the chain."""
        split = self.msa_type == "origin"
        if self.impl == "split":
            return "split" if split else "kernel"
        if self.impl != "default":
            return self.impl
        key = (self.msa_type, self.res, self.shift > 0, dtype, self.dim)
        tokens = batch * self.res * self.res
        if key in DEFAULT_MERGED and tokens >= DEFAULT_MERGED[key]:
            return "merged"
        least = DEFAULT_SPLIT.get((self.dim, dtype, self.res))
        if split and least is not None and tokens >= least:
            return "split"
        return "kernel"

    def forward(self, x: torch.Tensor, all_inter=None,
                generator: Optional[torch.Generator] = None, inter=None,
                inter_kv=None) -> torch.Tensor:
        """``x [B, N, C]`` tokens in the compute dtype -> same shape."""
        return self.run(x, all_inter, generator, inter, inter_kv)[0]

    def run(self, x: torch.Tensor, all_inter=None,
            generator: Optional[torch.Generator] = None, inter=None,
            inter_kv=None):
        """``(out [B, N, C], kv)``: ``kv`` the block's (K, V) for a
        ``need_kv`` block, else None. ``inter [B, N, deg]`` is the
        degradation map of the per-scale methods, ``inter_kv`` the encoder's
        (K, V) for ``attention_kv``."""
        b, dt = x.shape[0], x.dtype
        win, shift, L, mask = self.win, self.shift, self.L, self.attn_mask
        dps1 = self.drop_path1.scale(b, x.device, generator)
        dps2 = self.drop_path2.scale(b, x.device, generator)
        if self.unfused or capture.active(self) is not None:
            return self._forward_unfused(x, inter, inter_kv, all_inter, dps1,
                                         dps2)
        route = self.route(dt, b)
        on_card = route != "plain" and x.is_cuda
        img = to_image(x, self.res, self.res)
        n1 = (self.norm1.weight, self.norm1.bias)
        n2 = (self.norm2.weight, self.norm2.bias)
        if torch.is_grad_enabled() and route != "plain":
            return to_tokens(self._forward_functions(
                img, route == "merged", all_inter, n1, n2, dps1, dps2)), None
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
            return to_tokens(y), None
        if on_card and route == "split":
            # K12 reads and writes the image through the SW-MSA roll: no
            # roll around the split kernels
            lam = None
            if self.attn.all_bands_dc:
                lam = self.attn.lam(all_inter, dt)
            y = lb.attention_split_kernel(img, *n1,
                                          self.attn.kernel_operands(dt), mask,
                                          lam, win, 1e-6, dps1, shift=shift)
            return to_tokens(lb.ffn_split_kernel(
                y, *n2, self.mlp.kernel_operands(dt), 1e-6, dps2)), None
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
            if route == "split":
                y = lb.block_attention_split(img, *n1,
                                             *self.attn.kernel_weights(),
                                             mask, lam, win, 1e-6, dps1)
            elif on_card:
                y = lb.attention_kernel(img, *n1, self.attn.kernel_operands(dt),
                                        mask, lam, win, 1e-6, True, 1, dps1)
            else:
                y = lb.block_attention_plain(img, *n1, *self.attn.kernel_weights(),
                                             mask, lam, win, 1e-6, dps1)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if route == "split":
            y = lb.block_ffn_split(y, *n2, *self.mlp.kernel_weights(), 1e-6,
                                   dps2)
        elif on_card:
            y = lb.ffn_kernel(y, *n2, self.mlp.kernel_operands(dt), 1e-6, dps2)
        else:
            y = lb.block_ffn_plain(y, *n2, *self.mlp.kernel_weights(), 1e-6,
                                   dps2)
        return to_tokens(y), None

    def _norm(self, which: int, x, inter):
        """norm1 / norm2 in fp32, rounded to the compute dtype; the
        self-modulated form with ``self_modulator``."""
        dt = x.dtype
        norm = getattr(self, f"norm{which}")
        if "self_modulator" not in self.injection:
            return norm(x.float()).to(dt)
        g = leaky_relu(getattr(self, f"norm{which}_deg_norm")(inter.float()).to(dt))
        return norm(x, g, dt)

    def _forward_unfused(self, x, inter, inter_kv, all_inter, dps1, dps2):
        """The unfused block (JAX uformer_lewin.py:244-354): ``(out, kv)``."""
        b, _, c = x.shape
        dt = x.dtype
        res, win, shift, mask = self.res, self.win, self.shift, self.attn_mask
        nw = (res // win) ** 2
        plain = self.impl == "plain"
        shortcut = x
        img = lb.roll(to_image(self._norm(1, x, inter), res, res), shift)
        xw = windows.window_partition(img, win).reshape(-1, win * win, c)
        if self.use_modulator:
            xw = xw + self.modulator.to(dt)[None]
        if "modulator" in self.injection:
            # the degradation map as one win x win token grid, concat-embedded
            # into every window (decoder_Uformer.py:693-706)
            mod = self.degradation_modulator(inter, dt)
            mod = leaky_relu(self.degradation_modulator_norm(mod.float()).to(dt))
            mod = mod[:, None].expand(b, nw, win * win, c)
            xw = torch.cat([mod, xw.reshape(b, nw, win * win, c)], -1)
            xw = _linear(self.degradation_modulator_embed, xw, dt).reshape(
                -1, win * win, c)
        if self.msa_type == "freq":
            xw, _ = self.attn_intra.attend(xw, mask, plain, kv=False)
            xw, kv = self.attn_inter.attend(xw, mask, plain, kv=self.need_kv)
        else:
            attn_kv = None
            if "attention_residual" in self.injection:
                gi = leaky_relu(self.attn_deg_norm(inter.float()).to(dt))
                gimg = lb.roll(to_image(gi, res, res), shift)
                attn_kv = windows.window_partition(gimg, win).reshape(
                    -1, win * win, gi.shape[-1])
            elif "attention_kv" in self.injection:
                attn_kv = inter_kv
            xw, kv = self.attn.attend(xw, attn_kv, all_inter, mask, plain)
        img = windows.window_reverse(xw.reshape(-1, win, win, c), win, res, res)
        y = to_tokens(lb.roll(img, -shift))
        if dps1 is not None:
            y = y * dps1.to(dt)[:, None, None]
        x = shortcut + y
        y = self._norm(2, x, inter)
        y = (self.mlp(y) if isinstance(self.mlp, Mlp)
             else self.mlp.composite(y, inter, plain))
        if dps2 is not None:
            y = y * dps2.to(dt)[:, None, None]
        return x + y, (kv if self.need_kv else None)


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
                    1e-6, dps1, dps2, self.attn_inter.pairs())
            rolled = lb.roll(img, shift)
            y1 = lb.FreqIntra.apply(rolled, *n1, *intra, mask, L, win, 1e-6)
            y = lb.FreqInter.apply(y1, rolled, *inter, mask, L, win, 1e-6,
                                   dps1, self.attn_inter.pairs())
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
    (encoder_Uformer.py:687-743). ``need_kv`` marks the last block, whose
    (K, V) :meth:`run` returns; the other keywords go to every block."""

    def __init__(self, dim: int, input_resolution: int, depth: int,
                 num_heads: int, win_size: int = 8, mlp_ratio: float = 4.0,
                 drop_path: Sequence[float] = (), msa_type: str = "origin",
                 L: int = 1, all_bands_dc: bool = False,
                 encoder_embed_dim: int = 28, impl: str = "kernel",
                 need_kv: bool = False, **block_kw):
        super().__init__()
        dp = list(drop_path) or [0.0] * depth
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", LeWinBlock(
                dim, input_resolution, num_heads, win_size,
                shift_size=win_size // 2 if i % 2 == 1 else 0,
                mlp_ratio=mlp_ratio, drop_path=dp[i] if i < len(dp) else dp[-1],
                msa_type=msa_type, L=L, all_bands_dc=all_bands_dc,
                encoder_embed_dim=encoder_embed_dim, impl=impl,
                need_kv=need_kv and i + 1 == depth, **block_kw))

    def run(self, x, all_inter=None, generator=None, inter=None,
            inter_kv=None):
        """``(out, kv)``, kv from the last block when ``need_kv``."""
        kv = None
        for i in range(self.depth):
            x, kv_i = getattr(self, f"block{i}").run(x, all_inter, generator,
                                                    inter, inter_kv)
            kv = kv_i if kv_i is not None else kv
        return x, kv

    def forward(self, x, all_inter=None, generator=None, inter=None,
                inter_kv=None):
        return self.run(x, all_inter, generator, inter, inter_kv)[0]
