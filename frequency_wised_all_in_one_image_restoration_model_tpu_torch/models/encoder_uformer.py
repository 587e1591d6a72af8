"""Uformer contrastive degradation encoder (the port of the JAX
``models/encoder_uformer.py``), frequency-wise MSA.

InputProj -> 4 x (stage + 4x4/s2 downsample) -> bottleneck stage, on the
input split into L FFT bands folded into the batch ``(l b) h w c``
(encoder_Uformer.py:934-935, 964-966), then per-band contrastive heads
(:940-957, 973-984). :meth:`UformerEncoder.features` is what the eval
forward needs; the heads run only in :meth:`UformerEncoder.forward`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops import frequency
from .layers import leaky_relu
from .uformer_blocks import Downsample, InputProj, _linear
from .uformer_lewin import BasicUformerLayer

ENCODER_DEPTHS = (2, 2, 2, 2, 2)        # encoder_Uformer.py:748 (first 5 used)
ENCODER_HEADS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class DegradationContext:
    """What the all_DC decoder conditions on: L per-band bottleneck
    features ``[B, (P/16)^2, ed*16]`` (the reference's ``inter``)."""

    band_inter: Tuple[torch.Tensor, ...]


class UformerEncoder(nn.Module):
    def __init__(self, cfg, img_size: int = 128, in_chans: int = 3,
                 drop_path_rate: float = 0.1, dtype=torch.float32,
                 impl: str = "kernel"):
        super().__init__()
        if cfg.encoder_msa_type != "freq" or cfg.L < 2:
            raise NotImplementedError(
                "the port's Uformer encoder runs the frequency-wise MSA with "
                "L >= 2 bands; the origin-MSA encoder is not ported yet "
                "(ROADMAP.md, Queue 1 item 9)")
        self.cfg, self.dtype, self.img_size = cfg, dtype, img_size
        L, ed = cfg.L, cfg.encoder_embed_dim
        p = img_size
        depths = ENCODER_DEPTHS
        if cfg.uformer_depth_cap is not None:
            depths = tuple(min(d, cfg.uformer_depth_cap) for d in depths)
        ramp = list(np.linspace(0.0, drop_path_rate, sum(depths[:4])))
        self.input_proj = InputProj(in_chans, ed)
        used = 0
        for i in range(5):
            dpr = (ramp[used:used + depths[i]] if i < 4
                   else [drop_path_rate] * depths[4])
            used += depths[i] if i < 4 else 0
            stage = BasicUformerLayer(
                ed * 2 ** i, p // 2 ** i, depths[i], ENCODER_HEADS[i],
                win_size=8, drop_path=dpr, msa_type="freq", L=L, impl=impl)
            self.add_module(f"encoderlayer_{i}" if i < 4 else "bottleneck",
                            stage)
            if i < 4:
                self.add_module(f"dowsample_{i}",
                                Downsample(ed * 2 ** i, ed * 2 ** (i + 1)))
        dim = cfg.encoder_dim
        for i in range(L):
            self.add_module(f"mlp_head_{i}_norm", nn.LayerNorm(ed * 16, eps=1e-6))
            self.add_module(f"mlp_head_{i}_dense", nn.Linear(ed * 16, dim * 256))
            self.add_module(f"norm_{i}", nn.BatchNorm2d(dim, eps=1e-5))
            self.add_module(f"mlp_{i}_0", nn.Linear(dim, dim))
            self.add_module(f"mlp_{i}_1", nn.Linear(dim, dim))

    def features(self, x: torch.Tensor, generator=None) -> DegradationContext:
        """``x [B, P, P, 3]`` float -> the per-band bottleneck features."""
        L = self.cfg.L
        b, p = x.shape[0], x.shape[1]
        bands = frequency.frequency_decompose_1(x.permute(0, 3, 1, 2), L - 1)
        y = bands.permute(0, 1, 3, 4, 2).reshape(L * b, p, p, -1)
        y = self.input_proj(y, self.dtype)
        for i in range(4):
            y = getattr(self, f"encoderlayer_{i}")(y, generator=generator)
            y = getattr(self, f"dowsample_{i}")(y, self.dtype)
        y = self.bottleneck(y, generator=generator)
        bands16 = y.reshape(L, b, *y.shape[1:])
        return DegradationContext(band_inter=tuple(bands16[i] for i in range(L)))

    def heads(self, ctx: DegradationContext) -> torch.Tensor:
        """Per-band contrastive heads -> ``[L, B, encoder_dim]`` float32
        (encoder_Uformer.py:973-984; BatchNorm on its running statistics
        in eval)."""
        dim, p, dt = self.cfg.encoder_dim, self.img_size, self.dtype
        outs = []
        for i, band in enumerate(ctx.band_inter):
            b = band.shape[0]
            fea = getattr(self, f"mlp_head_{i}_norm")(band.float())
            fea = _linear(getattr(self, f"mlp_head_{i}_dense"), fea, dt)
            # [B, N16, dim*256] -> [B, dim, P, P]: a row-major relabel
            fea = getattr(self, f"norm_{i}")(fea.reshape(b, dim, p, p).float())
            fea = leaky_relu(fea).mean(dim=(2, 3))
            fea = leaky_relu(_linear(getattr(self, f"mlp_{i}_0"), fea, dt))
            fea = _linear(getattr(self, f"mlp_{i}_1"), fea, dt)
            outs.append(fea.float())
        return torch.stack(outs, dim=0)

    def forward(self, x: torch.Tensor, generator=None):
        """``(None, out [L, B, encoder_dim], DegradationContext)``, as the
        JAX encoder returns."""
        ctx = self.features(x, generator)
        return None, self.heads(ctx), ctx
