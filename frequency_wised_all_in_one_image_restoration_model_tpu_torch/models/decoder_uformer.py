"""Uformer restoration decoder, a full U-Net (the port of the JAX
``models/decoder_uformer.py``), with ``all_DC`` conditioning only.

InputProj -> 4 stages (depths [2,2,8,8]) with downsample -> bottleneck_0 ->
bottleneck_1 -> 4 stages (depths [8,8,2,2]) with transposed-conv upsample
and skip concat -> OutputProj -> global residual (decoder_Uformer.py:
835-1171). Every LeWin block takes the all_DC gain from the encoder's
band-1 feature (decoder_Uformer.py:275-288).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .encoder_uformer import DegradationContext
from .uformer_blocks import Downsample, InputProj, OutputProj, Upsample
from .uformer_lewin import BasicUformerLayer

DECODER_DEPTHS = (2, 2, 8, 8, 2, 8, 8, 2, 2)   # decoder_Uformer.py:837
DECODER_HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)


def check_supported(cfg) -> None:
    """The port runs the flagship conditioning only."""
    methods = tuple(cfg.degradation_embedding_method)
    if methods != ("all_DC",):
        raise NotImplementedError(
            f"degradation_embedding_method {list(methods)}: the port runs "
            "['all_DC'] only; the other injection methods are not ported yet "
            "(ROADMAP.md, Queue 1 item 8)")
    if cfg.learnable_modulator:
        raise NotImplementedError(
            "learnable_modulator is not ported yet (ROADMAP.md, Queue 1 item 8)")
    if cfg.frequency_decompose_type != "none":
        raise NotImplementedError(
            f"frequency_decompose_type {cfg.frequency_decompose_type!r} is not "
            "ported yet (ROADMAP.md, Queue 1 item 8)")


class UformerDecoder(nn.Module):
    def __init__(self, cfg, img_size: int = 128, in_chans: int = 3,
                 out_chans: int = 3, drop_path_rate: float = 0.1,
                 dtype=torch.float32, impl: str = "kernel"):
        super().__init__()
        check_supported(cfg)
        self.dtype, self.in_chans = dtype, in_chans
        ed, p, eed = cfg.embed_dim, img_size, cfg.encoder_embed_dim
        depths = DECODER_DEPTHS
        if cfg.uformer_depth_cap is not None:
            depths = tuple(min(d, cfg.uformer_depth_cap) for d in depths)
        enc_dpr = list(np.linspace(0.0, drop_path_rate, sum(depths[:4])))
        conv_dpr = [drop_path_rate] * depths[4]
        dec_dpr = enc_dpr[::-1]
        stage = lambda dim, res, depth, heads, dpr: BasicUformerLayer(
            dim, res, depth, heads, win_size=8, drop_path=dpr,
            all_bands_dc=True, encoder_embed_dim=eed, impl=impl)

        self.input_proj = InputProj(in_chans, ed)
        for i in range(4):
            lo = sum(depths[:i])
            self.add_module(f"encoderlayer_{i}", stage(
                ed * 2 ** i, p // 2 ** i, depths[i], DECODER_HEADS[i],
                enc_dpr[lo:lo + depths[i]]))
            self.add_module(f"dowsample_{i}",
                            Downsample(ed * 2 ** i, ed * 2 ** (i + 1)))
        for j in range(2):
            self.add_module(f"bottleneck_{j}", stage(
                ed * 16, p // 16, depths[4], DECODER_HEADS[4], conv_dpr))
        for depth_idx, s in ((5, 3), (6, 2), (7, 1), (8, 0)):
            # the stage after upsample_s runs on cat(up, skip): 2 * ed * 2^s
            in_up = ed * 16 if s == 3 else ed * 2 ** (s + 2)
            self.add_module(f"upsample_{s}", Upsample(in_up, ed * 2 ** s))
            lo = sum(depths[5:depth_idx])
            self.add_module(f"decoderlayer_{s}", stage(
                ed * 2 ** (s + 1), p // 2 ** s, depths[depth_idx],
                DECODER_HEADS[depth_idx], dec_dpr[lo:lo + depths[depth_idx]]))
        self.output_proj = OutputProj(ed * 2, out_chans)

    def forward(self, x: torch.Tensor, ctx: DegradationContext,
                generator=None) -> torch.Tensor:
        """``x [B, P, P, 3]`` -> restored ``[B, P, P, 3]`` float32."""
        dt = self.dtype
        bands = ctx.band_inter
        if len(bands) < 2:
            raise ValueError("all_DC needs an encoder emitting >= 2 bands")
        x = x.to(dt)
        y = self.input_proj(x, dt)
        skips = []
        for i in range(4):
            y = getattr(self, f"encoderlayer_{i}")(y, bands, generator)
            skips.append(y)
            y = getattr(self, f"dowsample_{i}")(y, dt)
        y = self.bottleneck_0(y, bands, generator)
        y = self.bottleneck_1(y, bands, generator)
        for s in (3, 2, 1, 0):
            y = getattr(self, f"upsample_{s}")(y, dt)
            y = torch.cat([y, skips[s]], dim=-1)
            y = getattr(self, f"decoderlayer_{s}")(y, bands, generator)
        out = self.output_proj(y, dt).float()
        if self.in_chans == 3:  # global residual (decoder_Uformer.py:1169-1171)
            out = x.float() + out
        return out
