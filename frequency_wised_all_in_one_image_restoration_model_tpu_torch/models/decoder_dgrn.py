"""DGRN restoration decoder, the AirNet path (the port of the JAX
``models/decoder_dgrn.py``; reference net/decoder_DGRN.py:9-158).

Head conv -> ``n_groups`` DGG groups of ``n_blocks`` DGB blocks -> body
conv with a residual -> tail conv. Each DGM adds a degradation-conditioned
deformable conv (DCN) branch and an SFT branch (a per-pixel affine from
``inter``) to its input. The DCN is the exact modulated DCNv2 through
:class:`ops.deform_conv.DCNFn`, whose forward is the kernel K11 on the
card; its offset / mask head on ``cat(x, inter)`` is zero at init, as in
JAX. Module names follow the Flax tree.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import leaky_relu, torch_default_
from .uformer_blocks import DCNLayerLeFF, _conv_nhwc

# JAX's DCNLayer and DCNLayerLeFF are the same operation, kept apart there
# only to avoid a circular import (uformer_blocks.py:695-697): offset /
# mask head on cat(x, inter), the raw HWIO weight drawn from U[0, 2 stdv)
# and used minus stdv, no bias
DCNLayer = DCNLayerLeFF


class SFTLayer(nn.Module):
    """``x * gamma + beta``, both from ``inter`` by two 1x1 convs around a
    LeakyReLU (decoder_DGRN.py:35-57)."""

    def __init__(self, inter_dim: int, channels_out: int):
        super().__init__()
        for name in ("conv_gamma", "conv_beta"):
            self.add_module(f"{name}_0", nn.Conv2d(inter_dim, channels_out, 1,
                                                   bias=False))
            self.add_module(f"{name}_1", nn.Conv2d(channels_out, channels_out,
                                                   1, bias=False))

    def forward(self, x, inter):
        dt = x.dtype

        def branch(name):
            y = leaky_relu(_conv_nhwc(getattr(self, f"{name}_0"), inter, dt))
            return _conv_nhwc(getattr(self, f"{name}_1"), y, dt)

        return x * branch("conv_gamma") + branch("conv_beta")


class DGM(nn.Module):
    """``x + DCN(x, inter) + SFT(x, inter)`` (decoder_DGRN.py:9-32)."""

    def __init__(self, n_feat: int, kernel_size: int = 3):
        super().__init__()
        self.dcn = DCNLayer(n_feat, n_feat, kernel_size)
        self.sft = SFTLayer(n_feat, n_feat)

    def forward(self, x, inter, plain: bool):
        return x + self.dcn(x, inter, plain) + self.sft(x, inter)


def _conv(n_feat: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(n_feat, n_feat, k, padding=k // 2)


class DGB(nn.Module):
    """Two DGM -> conv steps with a residual (decoder_DGRN.py:60-84)."""

    def __init__(self, n_feat: int, kernel_size: int = 3):
        super().__init__()
        self.dgm1 = DGM(n_feat, kernel_size)
        self.conv1 = _conv(n_feat, kernel_size)
        self.dgm2 = DGM(n_feat, kernel_size)
        self.conv2 = _conv(n_feat, kernel_size)

    def forward(self, x, inter, plain: bool):
        dt = x.dtype
        y = leaky_relu(self.dgm1(x, inter, plain))
        y = leaky_relu(_conv_nhwc(self.conv1, y, dt))
        y = leaky_relu(self.dgm2(y, inter, plain))
        return _conv_nhwc(self.conv2, y, dt) + x


class DGG(nn.Module):
    """``n_blocks`` DGBs and a conv, with a residual
    (decoder_DGRN.py:87-110)."""

    def __init__(self, n_feat: int, kernel_size: int = 3, n_blocks: int = 5):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"dgb{i}", DGB(n_feat, kernel_size))
        self.conv = _conv(n_feat, kernel_size)

    def forward(self, x, inter, plain: bool):
        res = x
        for i in range(self.n_blocks):
            res = getattr(self, f"dgb{i}")(res, inter, plain)
        return _conv_nhwc(self.conv, res, x.dtype) + x


class DGRN(nn.Module):
    """The restoration net (decoder_DGRN.py:113-158). ``n_feats`` is
    ``encoder_dim // 4`` behind the ResNet encoder and ``encoder_dim``
    behind the others (JAX ``airnet.py:87-91``), which is also the width of
    ``inter``. ``impl='plain'`` runs the DCN's plain version on any device;
    every other route takes K11 on a CUDA tensor."""

    def __init__(self, n_feats: int = 64, n_groups: int = 5, n_blocks: int = 5,
                 kernel_size: int = 3, dtype=torch.float32,
                 impl: str = "default"):
        super().__init__()
        self.dtype, self.n_groups = dtype, n_groups
        self.plain = impl == "plain"
        k = kernel_size
        self.head = nn.Conv2d(3, n_feats, k, padding=k // 2)
        for g in range(n_groups):
            self.add_module(f"dgg{g}", DGG(n_feats, k, n_blocks))
        self.body_conv = _conv(n_feats, k)
        self.tail = nn.Conv2d(n_feats, 3, k, padding=k // 2)

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX's initialisers: torch's default reset for every conv (the
        DCN layers' own ``init_weights``, which run after this one, then
        zero their offset heads and draw their weights)."""
        torch_default_(self, generator)

    def forward(self, x: torch.Tensor, inter: torch.Tensor,
                generator=None) -> torch.Tensor:
        """``x [B, P, P, 3]``, ``inter [B, P, P, n_feats]`` -> restored
        ``[B, P, P, 3]`` float32. DGRN draws nothing at random."""
        del generator
        if not isinstance(inter, torch.Tensor):
            raise TypeError("DGRN conditions on the spatial map of the ResNet "
                            f"or ViT encoder, got {type(inter).__name__}")
        dt, plain = self.dtype, self.plain
        x, inter = x.to(dt), inter.to(dt)
        head = _conv_nhwc(self.head, x, dt)
        res = head
        for g in range(self.n_groups):
            res = getattr(self, f"dgg{g}")(res, inter, plain)
        res = _conv_nhwc(self.body_conv, res, dt) + head
        return _conv_nhwc(self.tail, res, dt).float()
