"""Uformer restoration decoder, a full U-Net (the port of the JAX
``models/decoder_uformer.py``), with every degradation-injection method
the JAX decoder accepts.

InputProj -> 4 stages (depths [2,2,8,8]) with downsample -> bottleneck_0 ->
bottleneck_1 (the injection stage) -> 4 stages (depths [8,8,2,2]) with
transposed-conv upsample and skip concat -> OutputProj -> global residual
(decoder_Uformer.py:835-1171). Conditioning, from the encoder's
:class:`DegradationContext`:

* ``all_DC`` / ``all_<N>_bands``: every block modulates its attention map
  by per-head gains of the encoder's band features (decoder_Uformer.py:
  275-288); ``frequency_decompose_type`` adds the learnable ``lamb``;
* ``residual``: ``degradation_embed_{s}``, a Linear over cat(pyramid_s,
  features), before bottleneck_1 (s = 4) and on every skip (s = 3..0),
  with registered parameters (JAX :139-147, 171-172);
* the per-scale methods (``modulator``, ``self_modulator``,
  ``deform_conv``, ``attention_residual``, ``attention_kv``) in
  bottleneck_1 and the up stages, each stage conditioned on the pyramid
  level (and the encoder's K / V) of its scale (JAX :149-189);
* ``--learnable_modulator`` on the up stages.

Behind the ResNet or ViT encoder the conditioning is a plain tensor, which
carries none of this wiring (JAX :83-87): no band features, no pyramid, so
no ``degradation_embed`` layers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .encoder_uformer import DegradationContext
from .uformer_blocks import Downsample, InputProj, OutputProj, Upsample, _linear
from .uformer_lewin import BasicUformerLayer

DECODER_DEPTHS = (2, 2, 8, 8, 2, 8, 8, 2, 2)   # decoder_Uformer.py:837
DECODER_HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)
PER_SCALE = ("modulator", "self_modulator", "deform_conv",
             "attention_residual", "attention_kv")


def _band_config(cfg):
    """(all_bands_num, all_bands_dc) from the degradation methods
    (decoder_Uformer.py:166-174) and (lamb_bands_num, lamb_bands_dc) from
    frequency_decompose_type (:154-165)."""
    all_num, all_dc = None, False
    for m in cfg.degradation_embedding_method:
        if m == "all_DC":
            all_num, all_dc = 2, True
        elif m.startswith("all_") and m.endswith("_bands"):
            all_num, all_dc = int(m.split("_")[1]), False
    lamb_num, lamb_dc = None, False
    if cfg.frequency_decompose_type == "DC":
        lamb_num, lamb_dc = 2, True
    elif cfg.frequency_decompose_type != "none":
        lamb_num, lamb_dc = int(cfg.frequency_decompose_type.split("_")[0]), False
    return all_num, all_dc, lamb_num, lamb_dc


class UformerDecoder(nn.Module):
    def __init__(self, cfg, img_size: int = 128, in_chans: int = 3,
                 out_chans: int = 3, drop_path_rate: float = 0.1,
                 dtype=torch.float32, impl: str = "kernel"):
        super().__init__()
        self.dtype, self.in_chans = dtype, in_chans
        ed, p, eed = cfg.embed_dim, img_size, cfg.encoder_embed_dim
        methods = tuple(cfg.degradation_embedding_method)
        # the embeddings read the Uformer encoder's pyramid (JAX :146, 170)
        self.residual = ("residual" in methods
                         and cfg.encoder_type == "Uformer")
        per_scale = tuple(m for m in methods if m in PER_SCALE)
        all_num, all_dc, lamb_num, lamb_dc = _band_config(cfg)
        self.all_num = all_num
        depths = DECODER_DEPTHS
        if cfg.uformer_depth_cap is not None:
            depths = tuple(min(d, cfg.uformer_depth_cap) for d in depths)
        enc_dpr = list(np.linspace(0.0, drop_path_rate, sum(depths[:4])))
        conv_dpr = [drop_path_rate] * depths[4]
        dec_dpr = enc_dpr[::-1]
        bands = dict(all_bands_dc=all_dc, all_bands_num=all_num,
                     lamb_bands_num=lamb_num, lamb_bands_dc=lamb_dc,
                     encoder_embed_dim=eed, impl=impl)
        stage = lambda dim, res, depth, heads, dpr, **kw: BasicUformerLayer(
            dim, res, depth, heads, win_size=8, drop_path=dpr, **bands, **kw)

        self.input_proj = InputProj(in_chans, ed)
        for i in range(4):
            lo = sum(depths[:i])
            self.add_module(f"encoderlayer_{i}", stage(
                ed * 2 ** i, p // 2 ** i, depths[i], DECODER_HEADS[i],
                enc_dpr[lo:lo + depths[i]]))
            self.add_module(f"dowsample_{i}",
                            Downsample(ed * 2 ** i, ed * 2 ** (i + 1)))
        self.bottleneck_0 = stage(ed * 16, p // 16, depths[4],
                                  DECODER_HEADS[4], conv_dpr)
        if self.residual:
            # Linear(cat(pyramid_s, features_s)), registered (the reference
            # keeps them in a plain list, decoder_Uformer.py:883-885)
            for s in (4, 3, 2, 1, 0):
                c = ed * 2 ** s
                self.add_module(f"degradation_embed_{s}",
                                nn.Linear(eed * 2 ** s + c, c))
        self.bottleneck_1 = stage(ed * 16, p // 16, depths[4],
                                  DECODER_HEADS[4], conv_dpr,
                                  injection=per_scale,
                                  degradation_dim=eed * 16)
        for depth_idx, s in ((5, 3), (6, 2), (7, 1), (8, 0)):
            # the stage after upsample_s runs on cat(up, skip): 2 * ed * 2^s
            in_up = ed * 16 if s == 3 else ed * 2 ** (s + 2)
            self.add_module(f"upsample_{s}", Upsample(in_up, ed * 2 ** s))
            lo = sum(depths[5:depth_idx])
            self.add_module(f"decoderlayer_{s}", stage(
                ed * 2 ** (s + 1), p // 2 ** s, depths[depth_idx],
                DECODER_HEADS[depth_idx], dec_dpr[lo:lo + depths[depth_idx]],
                modulator=cfg.learnable_modulator, injection=per_scale,
                degradation_dim=eed * 2 ** s))
        self.output_proj = OutputProj(ed * 2, out_chans)

    def forward(self, x: torch.Tensor, ctx, generator=None) -> torch.Tensor:
        """``x [B, P, P, 3]`` -> restored ``[B, P, P, 3]`` float32. ``ctx`` is
        the Uformer encoder's :class:`DegradationContext`, or the spatial map
        of the ResNet / ViT encoder."""
        dt = self.dtype
        bands = pyramid = kv = None
        if isinstance(ctx, DegradationContext):
            bands, pyramid, kv = ctx.band_inter, ctx.pyramid, ctx.kv
        got = 0 if bands is None else len(bands)
        if self.all_num is not None and got < self.all_num:
            raise ValueError(
                f"'all_*' methods need an encoder emitting >= {self.all_num} "
                f"bands (got {got}); use the Uformer encoder with "
                "L >= num_bands")
        level = lambda t, s: None if t is None else t[s]

        def embed(s, y):
            # Linear(cat(inter_s, conv_s)) per scale (decoder_Uformer.py:
            # 1147-1148, 1159-1160)
            if not self.residual or pyramid is None:
                return y
            return _linear(getattr(self, f"degradation_embed_{s}"),
                           torch.cat([pyramid[s].to(dt), y], -1), dt)

        x = x.to(dt)
        y = self.input_proj(x, dt)
        skips = []
        for i in range(4):
            y = getattr(self, f"encoderlayer_{i}")(y, bands, generator)
            skips.append(y)
            y = getattr(self, f"dowsample_{i}")(y, dt)
        y = self.bottleneck_0(y, bands, generator)
        y = self.bottleneck_1(embed(4, y), bands, generator,
                              level(pyramid, 4), level(kv, 4))
        for s in (3, 2, 1, 0):
            y = getattr(self, f"upsample_{s}")(y, dt)
            y = torch.cat([y, embed(s, skips[s])], dim=-1)
            y = getattr(self, f"decoderlayer_{s}")(
                y, bands, generator, level(pyramid, s), level(kv, s))
        out = self.output_proj(y, dt).float()
        if self.in_chans == 3:  # global residual (decoder_Uformer.py:1169-1171)
            out = x.float() + out
        return out
