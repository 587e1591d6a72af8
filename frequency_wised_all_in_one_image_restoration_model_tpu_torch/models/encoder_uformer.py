"""Uformer contrastive degradation encoder (the port of the JAX
``models/encoder_uformer.py``).

InputProj -> 4 x (stage + 4x4/s2 downsample) -> bottleneck stage, then
per-band contrastive heads (encoder_Uformer.py:940-957, 973-984). With
``L >= 2`` the input is split into L FFT bands folded into the batch ``(l
b) h w c`` (:934-935, 964-966); with ``L = 1`` it is the image itself. The
stages run the frequency-wise MSA (``encoder_msa_type freq``) or the
origin MSA, whose blocks see the L bands as L times the batch.
:meth:`UformerEncoder.features` is what the eval forward needs; the heads
run only in :meth:`UformerEncoder.forward`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import frequency
from .layers import batch_norm, leaky_relu
from .uformer_blocks import Downsample, InputProj, _linear
from .uformer_lewin import BasicUformerLayer


ENCODER_DEPTHS = (2, 2, 2, 2, 2)        # encoder_Uformer.py:748 (first 5 used)
ENCODER_HEADS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class DegradationContext:
    """Everything the decoder conditions on (JAX ``DegradationContext``):

    * ``band_inter``: L per-band bottleneck features ``[B, (P/16)^2,
      ed*16]`` (the reference's ``inter``), for the ``all_*`` methods;
    * ``pyramid``: the band-0 slice of each of the 5 stages' outputs,
      ``[B, (P/2^s)^2, ed*2^s]``, the degradation maps of the per-scale
      methods;
    * ``kv``: per stage the last block's (K, V), regrouped by the
      frequency-wise MSA to ``[B*nW, h, L*n, d]`` (bands major within a
      window) and passed whole, or band 0's ``[B*nW, h, n, d]`` of the
      origin MSA, for ``attention_kv``; else None.

    With ``L = 1`` ``band_inter`` is the bottleneck output and ``pyramid``
    every stage's output.
    """

    band_inter: Tuple[torch.Tensor, ...]
    pyramid: Optional[Tuple[torch.Tensor, ...]] = None
    kv: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]] = None


class UformerEncoder(nn.Module):
    def __init__(self, cfg, img_size: int = 128, in_chans: int = 3,
                 drop_path_rate: float = 0.1, dtype=torch.float32,
                 impl: str = "kernel"):
        super().__init__()
        self.cfg, self.dtype, self.img_size = cfg, dtype, img_size
        # the decoder's attention_kv reads each stage's last-block K / V
        self.need_kv = "attention_kv" in cfg.degradation_embedding_method
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
                win_size=8, drop_path=dpr, msa_type=cfg.encoder_msa_type, L=L,
                impl=impl, need_kv=self.need_kv)
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
        """``x [B, P, P, 3]`` float -> the per-band bottleneck features, the
        per-scale pyramid and, for ``attention_kv``, the per-stage (K, V)
        (JAX encoder_uformer.py:115-140)."""
        L = self.cfg.L
        b, p = x.shape[0], x.shape[1]
        y = x
        if L != 1:
            bands = frequency.frequency_decompose_1(x.permute(0, 3, 1, 2),
                                                    L - 1)
            y = bands.permute(0, 1, 3, 4, 2).reshape(L * b, p, p, -1)
        y = self.input_proj(y, self.dtype)
        feats, kvs = [], []
        for i in range(5):
            stage = getattr(self, f"encoderlayer_{i}" if i < 4 else "bottleneck")
            y, kv = stage.run(y, generator=generator)
            feats.append(y)
            kvs.append(kv)
            if i < 4:
                y = getattr(self, f"dowsample_{i}")(y, self.dtype)
        if L == 1:
            return DegradationContext(band_inter=(y,), pyramid=tuple(feats),
                                      kv=tuple(kvs) if self.need_kv else None)
        band0 = lambda t: t.reshape(L, -1, *t.shape[1:])[0]
        kv = None
        if self.need_kv:
            # the origin MSA folds the bands into the batch of K / V: band 0;
            # the frequency-wise MSA regroups them into each window's tokens
            kv = tuple(kvs)
            if self.cfg.encoder_msa_type == "origin":
                kv = tuple(None if t is None else tuple(map(band0, t))
                           for t in kvs)
        bands16 = y.reshape(L, b, *y.shape[1:])
        return DegradationContext(
            band_inter=tuple(bands16[i] for i in range(L)),
            pyramid=tuple(band0(f) for f in feats), kv=kv)

    def heads(self, ctx: DegradationContext) -> torch.Tensor:
        """Per-band contrastive heads -> ``[L, B, encoder_dim]`` float32
        (encoder_Uformer.py:973-984; BatchNorm on the batch's statistics in
        training, on its running statistics in eval)."""
        dim, p, dt = self.cfg.encoder_dim, self.img_size, self.dtype
        outs = []
        for i, band in enumerate(ctx.band_inter):
            b = band.shape[0]
            fea = getattr(self, f"mlp_head_{i}_norm")(band.float())
            fea = _linear(getattr(self, f"mlp_head_{i}_dense"), fea, dt)
            # [B, N16, dim*256] -> [B, dim, P, P]: a row-major relabel
            fea = batch_norm(getattr(self, f"norm_{i}"),
                             fea.reshape(b, dim, p, p).float())
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
