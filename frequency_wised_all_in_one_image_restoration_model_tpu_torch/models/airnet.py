"""AirNet composition: degradation encoder + restoration decoder (the port
of the JAX ``models/airnet.py``; reference net/model.py:13-71).

Every pair JAX ``build_models`` builds: a ResNet, ViT or Uformer encoder
(frequency-wise or origin MSA, any L) with a DGRN (``decoder_type ResNet``)
or Uformer decoder, built for eval (``cfg.eval_dtype``, eval mode) or for
training (``cfg.dtype``, train mode: BatchNorm on batch statistics,
DropPath and dropout drawing). Each encoder's ``forward(x, generator)``
returns ``(fea, out [num_losses, B, dim], conditioning)`` and its
``features(x)`` the conditioning alone; each decoder's ``forward(x,
conditioning, generator)`` the restored image. The conditioning is the
Uformer encoder's ``DegradationContext`` or the spatial map of the others.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import check_ported
from .decoder_dgrn import DGRN
from .decoder_uformer import UformerDecoder
from .encoder_resnet import ResNetEncoder
from .encoder_uformer import UformerEncoder
from .encoder_vit import ViTEncoder
from .layers import trunc_normal_init

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def model_dtype(cfg, eval_mode: bool = True) -> torch.dtype:
    """The compute dtype: ``cfg.eval_dtype`` for eval, ``cfg.dtype`` for
    training."""
    return _DTYPES[cfg.eval_dtype if eval_mode else cfg.dtype]


def effective_num_losses(cfg) -> int:
    """Per-band contrastive losses: the bands the encoder emits, L for the
    Uformer encoder and 1 for ResNet / ViT (JAX ``effective_num_losses``)."""
    return cfg.L if cfg.encoder_type == "Uformer" else 1


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: object
    encoder: nn.Module
    decoder: nn.Module

    @property
    def num_losses(self) -> int:
        return effective_num_losses(self.cfg)

    @property
    def device(self) -> torch.device:
        return next(self.decoder.parameters()).device


def build_models(cfg, device, impl: str = "default",
                 eval_mode: bool = True) -> ModelBundle:
    """Encoder + decoder on ``device``, weights drawn from a
    ``torch.Generator`` seeded with ``cfg.seed`` (load real weights with
    ``load_state_dict`` after :func:`utils.weights.from_jax`). ``eval_mode``
    picks ``cfg.eval_dtype`` and ``.eval()``; a train build computes in
    ``cfg.dtype`` and is in ``.train()``.

    ``impl`` is the LeWin blocks' route (``models/uformer_lewin.py``):
    ``'kernel'`` the chain of CUDA kernels, ``'merged'`` one merged kernel
    per block, ``'split'`` the split kernels K12 / K13, ``'default'`` the
    route measured faster per stage (all four run the plain twins on a CPU
    device); ``'plain'`` the plain twins on any device, for comparisons.
    DGRN's DCN runs K11 on a CUDA device on every route but ``'plain'``."""
    check_ported(cfg)
    dtype = model_dtype(cfg, eval_mode)
    if cfg.encoder_type == "ResNet":
        encoder = ResNetEncoder(cfg.encoder_dim, dtype=dtype)
    elif cfg.encoder_type == "ViT":
        encoder = ViTEncoder(cfg, image_size=cfg.patch_size, dtype=dtype)
    elif cfg.encoder_type == "Uformer":
        encoder = UformerEncoder(cfg, img_size=cfg.patch_size,
                                 drop_path_rate=cfg.drop_path, dtype=dtype,
                                 impl=impl)
    else:
        raise ValueError(cfg.encoder_type)
    if cfg.decoder_type == "ResNet":
        # DGRN; n_feats per reference decoder_DGRN.py:120-124
        n_feats = (cfg.encoder_dim // 4 if cfg.encoder_type == "ResNet"
                   else cfg.encoder_dim)
        decoder = DGRN(n_feats, cfg.dgrn_groups, cfg.dgrn_blocks, dtype=dtype,
                       impl=impl)
    elif cfg.decoder_type == "Uformer":
        decoder = UformerDecoder(cfg, img_size=cfg.patch_size,
                                 drop_path_rate=cfg.drop_path, dtype=dtype,
                                 impl=impl)
    else:
        raise ValueError(cfg.decoder_type)
    gen = torch.Generator().manual_seed(cfg.seed)
    trunc_normal_init(encoder, gen)
    trunc_normal_init(decoder, gen)
    encoder, decoder = encoder.to(device), decoder.to(device)
    return ModelBundle(cfg=cfg, encoder=encoder.train(not eval_mode),
                       decoder=decoder.train(not eval_mode))


@torch.inference_mode()
def eval_forward(bundle: ModelBundle, x: torch.Tensor) -> torch.Tensor:
    """Eval AirNet forward ``x [B, P, P, 3] -> [B, P, P, 3]`` float32:
    the encoder's conditioning -> decoder (reference model.py:66-70). The
    encoder's contrastive heads are not run: eval uses only ``inter``."""
    ctx = bundle.encoder.features(x)
    return bundle.decoder(x, ctx)
