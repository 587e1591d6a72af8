"""SFNet-style frequency-pair fusion gate (the port of the JAX
``models/sfnet.py``; reference net/utils/SFNet_modulator.py:4-40).

``SFconv`` fuses a low / high frequency feature pair through an SKNet-style
softmax gate: global pool of the sum -> bottleneck 1x1 conv -> one 1x1 conv
per branch -> softmax over the branches -> weighted sum -> output 1x1 conv.
Dead code in the reference (never imported), kept as part of its surface.
"""

from __future__ import annotations

import torch
from torch import nn

from .uformer_blocks import _conv_nhwc


class SFconv(nn.Module):
    def __init__(self, features: int, m: int = 2, ratio: int = 2,
                 dtype=torch.float32):
        super().__init__()
        del m  # the branch count; one low / high pair, as in JAX
        d = max(features // ratio, 4)
        self.dtype = dtype
        self.fc = nn.Conv2d(features, d, 1)
        self.fc_low = nn.Conv2d(d, features, 1)
        self.fc_high = nn.Conv2d(d, features, 1)
        self.out = nn.Conv2d(features, features, 1)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        """``low, high [B, H, W, C]`` -> fused ``[B, H, W, C]``."""
        dt = self.dtype
        pooled = (low + high).mean(dim=(1, 2), keepdim=True)
        z = _conv_nhwc(self.fc, pooled, dt)
        att = torch.softmax(torch.stack([_conv_nhwc(self.fc_low, z, dt),
                                         _conv_nhwc(self.fc_high, z, dt)]), 0)
        return _conv_nhwc(self.out, low * att[0] + high * att[1], dt)
