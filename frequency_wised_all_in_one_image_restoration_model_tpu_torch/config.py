"""The port's configuration: the fields of the JAX package's ``config.Config``
that the ported slice reads, under the same names, with the same defaults
and the same derivation of ``encoder_dim`` (reference option.py:30-50,
80-101).

The JAX package's ``config`` stays the CLI; a configuration made there
carries over with :func:`from_fields`. The port keeps its own copy so that
it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# encoder_type -> encoder_dim (reference option.py:80-101)
ENCODER_DIMS = {"ResNet": 256, "ViT": 3, "Uformer": 256, "Oformer": 256}


@dataclasses.dataclass(frozen=True)
class Config:
    """The slice's fields of the JAX ``config.Config``."""

    patch_size: int = 128
    encoder_type: str = "Uformer"
    decoder_type: str = "Uformer"
    encoder_dim: Optional[int] = None
    frequency_decompose_type: str = "none"
    encoder_embed_dim: int = 28
    embed_dim: int = 56
    degradation_embedding_method: Tuple[str, ...] = ("residual",)
    learnable_modulator: bool = False
    L: int = 3
    encoder_msa_type: str = "freq"
    eval_dtype: str = "float32"
    seed: int = 0
    # cap on each Uformer stage's block count (None = reference depths);
    # for tests and dry runs only
    uformer_depth_cap: Optional[int] = None
    # stochastic-depth peak rate (reference encoder_Uformer.py:750)
    drop_path: float = 0.1


FIELDS = tuple(f.name for f in dataclasses.fields(Config))


def make_config(**overrides) -> Config:
    """A :class:`Config` with ``overrides``; ``encoder_dim`` left as None
    takes the encoder type's default, as the JAX CLI derives it."""
    unknown = sorted(set(overrides) - set(FIELDS))
    if unknown:
        raise AttributeError(f"unknown config field(s): {', '.join(unknown)}")
    if "degradation_embedding_method" in overrides:
        overrides["degradation_embedding_method"] = tuple(
            overrides["degradation_embedding_method"])
    cfg = Config(**overrides)
    if cfg.encoder_dim is None:
        cfg = dataclasses.replace(
            cfg, encoder_dim=ENCODER_DIMS.get(cfg.encoder_type))
    return cfg


def from_fields(cfg) -> Config:
    """The slice's fields of any configuration object that has them, such
    as the JAX package's ``config.Config``."""
    return make_config(**{name: getattr(cfg, name) for name in FIELDS})
