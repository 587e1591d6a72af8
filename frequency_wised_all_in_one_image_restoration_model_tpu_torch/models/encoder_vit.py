"""ViT contrastive degradation encoder with attention-map band modulation
(the port of the JAX ``models/encoder_vit.py``; reference
net/encoder_ViT.py:119-203).

16x16 patch embed between two LayerNorms, a learned position embedding,
``depth`` pre-norm transformer blocks whose attention maps are optionally
split into frequency bands (``frequency_decompose_type`` ``DC`` or
``<N>_bands``, over the token x token map) and re-added with the learnable
per-band, per-head gains ``lamb`` (every band, band 0 included,
encoder_ViT.py:84-92; per batch slot with ``batch_wise_decompose``), then
``mlp_head`` re-projects the tokens to the spatial degradation map
``inter [B, H, W, encoder_dim]``, BatchNorm, and the contrastive MLP.
Attention and products are plain PyTorch, as JAX leaves them to XLA.
Dropout draws from the generator the caller passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import frequency
from ..parallel import distributed
from .layers import batch_norm, dropout, gelu, leaky_relu, lecun_normal_
from .uformer_blocks import _linear


def _bands(decompose_type: str) -> int:
    """The number of bands a decomposition type splits a map into."""
    return 2 if decompose_type == "DC" else int(decompose_type.split("_")[0])


class ViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int, rate: float = 0.1,
                 decompose_type: str = "none", wised_batch: int = 0):
        super().__init__()
        self.heads, self.rate = heads, rate
        self.decompose_type = decompose_type
        inner = dim  # heads * (dim // heads)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim)
        if decompose_type != "none":
            self.lamb = nn.Parameter(torch.zeros(_bands(decompose_type),
                                                 wised_batch or 1, heads))

    def init_weights(self, generator: torch.Generator) -> None:
        """``to_qkv`` has Flax's default LeCun-normal kernel."""
        w = self.to_qkv.weight
        with torch.no_grad():
            lecun_normal_(w, w.shape[1], generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``x [B, N, dim]`` in the compute dtype -> same shape."""
        b, n, dim = x.shape
        h, dt = self.heads, x.dtype
        qkv = F.linear(x, self.to_qkv.weight.to(dt))
        q, k, v = (t.reshape(b, n, h, dim // h).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        scale = (dim // h) ** -0.5
        attn = torch.softmax(torch.matmul(q.float() * scale,
                                          k.float().transpose(-1, -2)), -1)
        if self.decompose_type != "none":
            if self.decompose_type == "DC":
                bands = frequency.frequency_decompose_dc(attn)
            else:
                bands = frequency.frequency_decompose(
                    attn, _bands(self.decompose_type))
            lamb = self.lamb
            if 1 < lamb.shape[1] != b:
                # a slot per sample of the global batch: this rank's slots
                lamb = lamb[:, distributed.process_slice(lamb.shape[1])]
            attn = attn + (bands * lamb[:, :, :, None, None]).sum(0)
        attn = dropout(attn, self.rate, self.training, generator)
        out = torch.matmul(attn.to(dt), v).transpose(1, 2).reshape(b, n, dim)
        return dropout(_linear(self.to_out, out, dt), self.rate,
                       self.training, generator)


class ViTEncoder(nn.Module):
    def __init__(self, cfg, image_size: int = 128, patch: int = 16,
                 depth: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.patch, self.depth, self.rate = patch, depth, dropout_rate
        c = cfg.out_channels
        dim = c * patch * patch  # encoder_ViT.py:134
        n = (image_size // patch) ** 2
        ed = cfg.encoder_dim
        wised = cfg.batch_size if cfg.batch_wise_decompose else 0
        self.patch_norm1 = nn.LayerNorm(patch * patch * c, eps=1e-6)
        self.patch_embed = nn.Linear(patch * patch * c, dim)
        self.patch_norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.pos_embedding = nn.Parameter(torch.zeros(1, n, dim))
        for i in range(depth):
            self.add_module(f"norm_attn_{i}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"attn_{i}", ViTAttention(
                dim, heads, dropout_rate, cfg.frequency_decompose_type,
                wised))
            self.add_module(f"norm_ff_{i}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"ff_{i}_0", nn.Linear(dim, mlp_dim))
            self.add_module(f"ff_{i}_1", nn.Linear(mlp_dim, dim))
        self.mlp_head_norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_head_dense = nn.Linear(dim, dim // c * ed)
        self.norm = nn.BatchNorm2d(ed, eps=1e-5)
        self.mlp_0 = nn.Linear(ed, ed)
        self.mlp_1 = nn.Linear(ed, ed)

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX's initialisers where they differ from the model-wide rule:
        the position embedding N(0, 1), the contrastive MLP LeCun-normal
        (Flax's default)."""
        with torch.no_grad():
            self.pos_embedding.normal_(0.0, 1.0, generator=generator)
            for m in (self.mlp_0, self.mlp_1):
                lecun_normal_(m.weight, m.weight.shape[1], generator)

    def _drop(self, x, generator):
        return dropout(x, self.rate, self.training, generator)

    def _spatial(self, x: torch.Tensor, generator) -> torch.Tensor:
        """``x [B, H, W, C]`` -> the degradation map ``[B, H, W,
        encoder_dim]`` float32."""
        dt, pp, ed = self.dtype, self.patch, self.cfg.encoder_dim
        b, hh, ww, c = x.shape
        n = (hh // pp) * (ww // pp)
        # 'b (h p1) (w p2) c -> b (h w) (p1 p2 c)'
        y = (x.reshape(b, hh // pp, pp, ww // pp, pp, c)
             .permute(0, 1, 3, 2, 4, 5).reshape(b, n, pp * pp * c))
        y = _linear(self.patch_embed, self.patch_norm1(y.float()), dt)
        y = self.patch_norm2(y.float()).to(dt) + self.pos_embedding.to(dt)
        y = self._drop(y, generator)
        for i in range(self.depth):
            a = getattr(self, f"norm_attn_{i}")(y.float()).to(dt)
            y = y + getattr(self, f"attn_{i}")(a, generator)
            f = getattr(self, f"norm_ff_{i}")(y.float()).to(dt)
            f = self._drop(gelu(_linear(getattr(self, f"ff_{i}_0"), f, dt)),
                           generator)
            y = y + self._drop(_linear(getattr(self, f"ff_{i}_1"), f, dt),
                               generator)
        # tokens -> spatial map (encoder_ViT.py:193-197): a row-major relabel
        g = _linear(self.mlp_head_dense, self.mlp_head_norm(y.float()), dt)
        inter = batch_norm(self.norm, g.reshape(b, ed, hh, ww).float())
        return leaky_relu(inter).permute(0, 2, 3, 1)

    def features(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``inter [B, H, W, encoder_dim]`` in the compute dtype, what the
        decoder conditions on."""
        return self._spatial(x, generator).to(self.dtype)

    def forward(self, x: torch.Tensor, generator=None):
        """``(fea [B, encoder_dim], out [1, B, encoder_dim], inter)``, the
        first two float32."""
        dt = self.dtype
        inter = self._spatial(x, generator)
        fea = inter.mean(dim=(1, 2))
        out = _linear(self.mlp_1, leaky_relu(_linear(self.mlp_0, fea, dt)), dt)
        return fea, out.float()[None], inter.to(dt)
