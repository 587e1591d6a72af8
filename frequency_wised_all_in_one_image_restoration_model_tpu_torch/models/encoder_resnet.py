"""Contrastive ResNet degradation encoder (the port of the JAX
``models/encoder_resnet.py``; reference net/encoder_ResNet.py:4-47).

Three residual stages, a global pool and a projection MLP. Returns ``(fea
[B, dim], out [1, B, dim], inter [B, H, W, dim // 4])``: ``inter``, the
first stage's output, is the spatial degradation map the decoder conditions
on. Module names follow the Flax tree (``E_pre``, ``ResBlock_0``,
``Conv_0``, ``BatchNorm_0``, ``Dense_0``, ...), which the weight bridge
(``utils/weights.py``) relies on. BatchNorm is Flax's (momentum 0.9, eps
1e-5): batch statistics in training, running statistics in eval.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import batch_norm, leaky_relu, torch_default_
from .uformer_blocks import _conv_nhwc, _linear


class ResBlock(nn.Module):
    """Conv-BN-LReLU-Conv-BN plus a 1x1 Conv-BN shortcut
    (encoder_ResNet.py:4-20)."""

    def __init__(self, in_feat: int, out_feat: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_feat, out_feat, 3, stride, padding=1,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(out_feat, eps=1e-5)
        self.Conv_1 = nn.Conv2d(out_feat, out_feat, 3, padding=1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(out_feat, eps=1e-5)
        self.Conv_2 = nn.Conv2d(in_feat, out_feat, 1, stride, bias=False)
        self.BatchNorm_2 = nn.BatchNorm2d(out_feat, eps=1e-5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x [B, H, W, Cin]`` -> ``[B, H / s, W / s, Cout]`` float32 (the
        BatchNorms compute in float32, the convolutions in ``dtype``)."""
        def conv_bn(i, t):
            y = _conv_nhwc(getattr(self, f"Conv_{i}"), t, dtype)
            y = batch_norm(getattr(self, f"BatchNorm_{i}"),
                           y.float().permute(0, 3, 1, 2))
            return y.permute(0, 2, 3, 1)

        y = conv_bn(1, leaky_relu(conv_bn(0, x)))
        return leaky_relu(y + conv_bn(2, x))


class ResNetEncoder(nn.Module):
    """``dim`` is the contrastive embedding width (encoder_ResNet.py:23-47)."""

    def __init__(self, dim: int = 256, in_chans: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.E_pre = ResBlock(in_chans, dim // 4, 1)
        self.ResBlock_0 = ResBlock(dim // 4, dim // 2, 2)
        self.ResBlock_1 = ResBlock(dim // 2, dim, 2)
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX's initialisers: torch's default reset everywhere."""
        torch_default_(self, generator)

    def features(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``inter``, what the decoder conditions on: the first stage."""
        del generator  # no random draws
        return self.E_pre(x, self.dtype)

    def forward(self, x: torch.Tensor, generator=None):
        """``(fea [B, dim], out [1, B, dim], inter [B, H, W, dim // 4])``,
        the first two float32."""
        dt = self.dtype
        inter = self.features(x, generator)
        y = self.ResBlock_1(self.ResBlock_0(inter, dt), dt)
        fea = y.mean(dim=(1, 2))
        out = _linear(self.Dense_1, leaky_relu(_linear(self.Dense_0, fea, dt)),
                      dt)
        return fea.float(), out.float()[None], inter
