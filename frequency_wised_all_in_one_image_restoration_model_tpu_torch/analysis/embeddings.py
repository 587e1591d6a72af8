"""Degradation-embedding analyses: t-SNE scatter and lamb / embed_lamb dumps
(the port of the JAX ``analysis/embeddings.py``).

Capability match for plot_TSNE_distribution.py:74-94 (t-SNE of contrastive
embeddings colored by task), plot_lamb_curve.py:41-49 (learnable per-band
attention gains) and plot_embed_lamb_curve.py:59-78 (decoder embed_lamb
responses per degradation). Keys are JAX's: the ``/``-joined path of the
parameter or of the module that records, which the port's names mirror.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models import capture


def to_numpy(t) -> np.ndarray:
    """A tensor anywhere (or an array) as a host numpy array (bfloat16 as
    float32, which numpy lacks)."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def tsne_embed(embeddings: np.ndarray, perplexity: float = 30.0,
               seed: int = 0) -> np.ndarray:
    """[N, D] -> [N, 2] via sklearn t-SNE (plot_TSNE_distribution.py:74-80)."""
    from sklearn.manifold import TSNE

    n = embeddings.shape[0]
    perplexity = min(perplexity, max(2.0, (n - 1) / 3.0))
    return TSNE(n_components=2, perplexity=perplexity, init="pca",
                random_state=seed).fit_transform(np.asarray(embeddings))


def collect_embeddings(encode_fn: Callable, batches: Sequence[Dict],
                       band: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Run batches through the contrastive encoder; returns (embeddings
    [N, dim], task_ids [N]). ``encode_fn(d1)`` gives ``[L, B, dim]`` for a
    batch's degraded images, a tensor on any device or an array."""
    embs, ids = [], []
    for batch in batches:
        out = to_numpy(encode_fn(batch["d1"]))  # [L, B, dim]
        embs.append(out[band])
        ids.append(np.asarray(batch["de_id"]))
    return np.concatenate(embs), np.concatenate(ids)


def _named(model: Union[nn.Module, Mapping[str, nn.Module]]):
    """``(name, parameter)`` of a module, or of a mapping of modules with
    each name under its key (``{"encoder": ..., "decoder": ...}`` as JAX's
    ``state.params``)."""
    if isinstance(model, nn.Module):
        yield from model.named_parameters()
        return
    for key, module in model.items():
        for name, p in module.named_parameters():
            yield f"{key}.{name}", p


def extract_lamb_params(model: Union[nn.Module, Mapping[str, nn.Module]],
                        key: str = "lamb") -> Dict[str, np.ndarray]:
    """Every parameter named ``key`` (the ViT's attention gains, the
    decoder's band gains) by its ``/``-joined path, the key of the same leaf
    in JAX's tree (plot_lamb_curve.py:41-49)."""
    return {name.replace(".", "/"): to_numpy(p)
            for name, p in _named(model) if name.split(".")[-1] == key}


def embed_lamb_responses(decoder: nn.Module, x: torch.Tensor,
                         ctx) -> Dict[str, np.ndarray]:
    """Run the decoder on ``x`` with the encoder's conditioning ``ctx``,
    captured, and return every ``embed_lamb_<i>`` gain ``[B, 1, h]`` its
    attention modules record (plot_embed_lamb_curve.py:59-78)."""
    with torch.inference_mode(), capture.capture(decoder) as cap:
        decoder(x, ctx)
    return {k: to_numpy(v) for k, v in cap.named("embed_lamb").items()}
