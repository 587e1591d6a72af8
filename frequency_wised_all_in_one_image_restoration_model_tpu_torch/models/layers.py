"""Shared small layers: activations, the token MLP, layout helpers,
DropPath, init."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1), the reference's activation everywhere but InputProj."""
    return F.leaky_relu(x, negative_slope=slope)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU, as Flax's ``nn.gelu`` default."""
    return F.gelu(x, approximate="tanh")


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over ``x [B, C, H, W]`` float32 as Flax's ``nn.BatchNorm
    (momentum=0.9)`` does it: in training the batch's mean and biased
    variance normalise and also enter the running statistics (torch's own
    layer puts the unbiased variance there); in eval the running
    statistics normalise."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(mean, alpha=0.1)
        bn.running_var.mul_(0.9).add_(var, alpha=0.1)
        bn.num_batches_tracked += 1
    shape = (1, -1, 1, 1)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + bn.eps)
    return y * bn.weight.reshape(shape) + bn.bias.reshape(shape)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*W, C]."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def to_image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, H, W, C]."""
    b, n, c = x.shape
    if n != h * w:
        raise ValueError(f"{n} tokens do not form a {h}x{w} image")
    return x.reshape(b, h, w, c)


class Mlp(nn.Module):
    """Linear, GELU, Linear token MLP (reference encoder_Uformer.py:374-393;
    JAX ``layers.Mlp``), under Flax's automatic names ``Dense_0`` /
    ``Dense_1``; computes in its input's dtype."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, out or dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        lin = lambda m, t: F.linear(t, m.weight.to(dt), m.bias.to(dt))
        return lin(self.Dense_1, gelu(lin(self.Dense_0, x)))


class DropPath(nn.Module):
    """Per-sample stochastic depth. Eval is the identity; in training
    :meth:`scale` draws the per-image branch scale ``{0, 1/keep}`` that the
    block kernels take as ``dps``, from an explicit generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def scale(self, batch: int, device, generator: Optional[torch.Generator]
              ) -> Optional[torch.Tensor]:
        if not self.training or self.rate == 0.0:
            return None
        keep = 1.0 - self.rate
        draw = torch.rand(batch, generator=generator, device=device)
        return (draw < keep).float() / keep


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout``: in training every element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the draw from
    ``generator``; in eval the identity."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def torch_default_(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default reset, which the JAX package's ResNet and DGRN
    layers copy (``torch_conv_init``, ``torch_bias_init``): every Conv2d and
    Linear kernel and bias of ``module`` uniform in +-1/sqrt(fan_in)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = (1.0 / (m.weight[0].numel())) ** 0.5
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Flax's default kernel initialiser: variance_scaling(1, fan_in,
    truncated_normal), truncated at 2 sigma with the 0.8796 correction."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def trunc_normal_init(module: nn.Module, generator: torch.Generator) -> None:
    """Draw a module tree's parameters the way the JAX package initialises
    them: Linear kernels and bias tables trunc-normal(0.02) with zero bias,
    convolutions LeCun-normal (Flax's default) with zero bias, norms at
    identity; then each module's own ``init_weights(generator)``, where it
    has one, for the parameters JAX draws otherwise. ``generator`` makes the
    draw reproducible from a seed."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            lecun_normal_(w, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        for name, p in m.named_parameters(recurse=False):
            if name.startswith("relative_position_bias_table"):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
    # modules whose JAX initialisers differ from the rules above
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
