"""JAX parameters -> the port's ``state_dict``.

The port's module attribute names mirror the Flax tree, so the conversion
walks the tree generically at any depth and only renames leaves and
changes layouts:

  Dense ``kernel [in, out]``          -> Linear ``weight [out, in]``
  Conv ``kernel [kh, kw, in, out]``   -> Conv2d ``weight [out, in, kh, kw]``
  ConvTranspose ``kernel``            -> ConvTranspose2d ``weight
      [in, out, kh, kw]``, spatially flipped (Flax's ConvTranspose does
      not flip its kernel, torch's does; the inverse of
      ``utils/torch_weights.deconv_w`` in the JAX package)
  LayerNorm / BatchNorm ``scale``     -> ``weight``
  BatchNorm ``batch_stats`` mean/var  -> ``running_mean`` / ``running_var``
                                         (and ``num_batches_tracked`` 0)
  anything else (bias tables, biases) -> same name, same layout

Reference ``.pth`` checkpoints reach the port through the JAX package:
``utils/torch_weights.py`` -> JAX variables -> :func:`from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# Flax module names of transposed convolutions in the Uformer tree
_TRANSPOSED = ("deconv",)


def _leaf(module: str, name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            if module in _TRANSPOSED:
                return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected {value.ndim}-d kernel under {module!r}")
    if name == "scale":
        return "weight", value
    return name, value


def _walk(tree: Mapping[str, Any], path, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            _walk(val, path + (key,), out)
            continue
        module = path[-1] if path else ""
        name, arr = _leaf(module, key, np.asarray(val, np.float32))
        out[".".join(path + (name,))] = torch.from_numpy(np.array(arr))


def from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``{'params': ..., 'batch_stats': ...}`` (arrays or numpy) ->
    a ``state_dict`` for the port's module of the same structure."""
    out: Dict[str, torch.Tensor] = {}
    _walk(variables["params"], (), out)

    def stats(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                stats(val, path + (key,))
                continue
            name = {"mean": "running_mean", "var": "running_var"}[key]
            out[".".join(path + (name,))] = torch.from_numpy(
                np.array(val, np.float32))
            out[".".join(path + ("num_batches_tracked",))] = torch.tensor(0)

    stats(variables.get("batch_stats", {}), ())
    return out
