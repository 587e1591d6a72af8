"""AirNet composition: degradation encoder + restoration decoder (the port
of the JAX ``models/airnet.py``; reference net/model.py:13-71).

The port's slice is the flagship: Uformer encoder (L FFT bands,
frequency-wise MSA) and Uformer decoder with all_DC conditioning, built for
eval (``cfg.eval_dtype``, eval mode) or for training (``cfg.dtype``, train
mode: BatchNorm on batch statistics, DropPath drawing).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import check_ported
from .decoder_uformer import UformerDecoder
from .encoder_uformer import UformerEncoder
from .layers import trunc_normal_init

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def model_dtype(cfg, eval_mode: bool = True) -> torch.dtype:
    """The compute dtype: ``cfg.eval_dtype`` for eval, ``cfg.dtype`` for
    training."""
    return _DTYPES[cfg.eval_dtype if eval_mode else cfg.dtype]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: object
    encoder: UformerEncoder
    decoder: UformerDecoder

    @property
    def num_losses(self) -> int:
        """Per-band contrastive losses: the bands the encoder emits."""
        return self.cfg.L

    @property
    def device(self) -> torch.device:
        return self.decoder.output_proj.proj.weight.device


def build_models(cfg, device, impl: str = "default",
                 eval_mode: bool = True) -> ModelBundle:
    """Encoder + decoder on ``device``, weights drawn from a
    ``torch.Generator`` seeded with ``cfg.seed`` (load real weights with
    ``load_state_dict`` after :func:`utils.weights.from_jax`). ``eval_mode``
    picks ``cfg.eval_dtype`` and ``.eval()``; a train build computes in
    ``cfg.dtype`` and is in ``.train()``.

    ``impl`` is the LeWin blocks' route (``models/uformer_lewin.py``):
    ``'kernel'`` the chain of CUDA kernels, ``'merged'`` one merged kernel
    per block, ``'default'`` the route measured faster per stage (all three
    run the plain twins on a CPU device); ``'plain'`` the plain twins on
    any device, for comparisons."""
    check_ported(cfg)
    dtype = model_dtype(cfg, eval_mode)
    encoder = UformerEncoder(cfg, img_size=cfg.patch_size,
                             drop_path_rate=cfg.drop_path, dtype=dtype,
                             impl=impl)
    decoder = UformerDecoder(cfg, img_size=cfg.patch_size,
                             drop_path_rate=cfg.drop_path, dtype=dtype,
                             impl=impl)
    gen = torch.Generator().manual_seed(cfg.seed)
    trunc_normal_init(encoder, gen)
    trunc_normal_init(decoder, gen)
    encoder, decoder = encoder.to(device), decoder.to(device)
    return ModelBundle(cfg=cfg, encoder=encoder.train(not eval_mode),
                       decoder=decoder.train(not eval_mode))


@torch.inference_mode()
def eval_forward(bundle: ModelBundle, x: torch.Tensor) -> torch.Tensor:
    """Eval AirNet forward ``x [B, P, P, 3] -> [B, P, P, 3]`` float32:
    encoder band features -> decoder (reference model.py:66-70). The
    encoder's contrastive heads are not run: eval uses only ``inter``."""
    ctx = bundle.encoder.features(x)
    return bundle.decoder(x, ctx)
