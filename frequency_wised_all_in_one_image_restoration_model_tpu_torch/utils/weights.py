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

The raw parameters are of that last kind and keep JAX's layout: every DCN
``weight`` (the ``deform_conv`` LeFF's and DGRN's ``DCNLayer``) stays HWIO
``[k, k, Cin, Cout]`` as JAX declares it (``DCNLayerLeFF`` reads it so),
the learnable ``modulator`` ``[win^2, C]``, the per-band ``lamb`` of the
Uformer decoder ``[N-1, 1, h]`` and of the ViT ``[N, 1 or batch, h]``, the
ViT ``pos_embedding [1, n, dim]``. The ResNet encoder's BatchNorm
statistics come over as every ``batch_stats`` does.

Reference ``.pth`` checkpoints reach the port through the JAX package:
``utils/torch_weights.py`` -> JAX variables -> :func:`from_jax`.

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` across, into
the tree ``training/checkpoint.py`` saves and loads.
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


def _field(node: Any, name: str, index: int = None):
    """A field of a NamedTuple / dataclass state, or of the nested dicts and
    lists a checkpoint restored without a template gives."""
    if isinstance(node, Mapping):
        return node[name] if name in node else node[str(index)]
    if hasattr(node, name):
        return getattr(node, name)
    return node[index]


def train_state_from_jax(state: Any) -> Dict[str, Any]:
    """A JAX ``TrainState`` (its arrays as numpy; the object itself, or the
    nested dicts of an Orbax restore) -> the port's train-state tree
    (``training/checkpoint.py::load_state_tree``): query and key parameters,
    the BatchNorm statistics of both, queue and pointer, Adam's moments,
    count and learning rate. The JAX RNG key has no counterpart: the
    DropPath generator keeps the seed it was made with."""
    params, extra = _field(state, "params"), _field(state, "extra")
    moco = _field(state, "moco")
    net = lambda p, e: from_jax({"params": p, **(e or {})})
    opt = _field(state, "opt_state")
    adam = _field(_field(opt, "inner_state"), "0", 0)
    moments = lambda tree: {n: from_jax({"params": _field(tree, n)})
                            for n in ("encoder", "decoder")}
    lr = _field(_field(opt, "hyperparams"), "learning_rate")
    return {
        "encoder": net(_field(params, "encoder"), _field(extra, "encoder")),
        "decoder": net(_field(params, "decoder"), _field(extra, "decoder")),
        "train_state": {
            "step": int(np.asarray(_field(state, "step"))),
            "encoder_k": net(_field(moco, "params_k"), _field(moco, "extra_k")),
            "queue": torch.from_numpy(np.array(_field(moco, "queue"),
                                               np.float32)),
            "queue_ptr": torch.tensor(int(np.asarray(_field(moco, "queue_ptr")))),
            "optimizer": {
                "lr": float(np.asarray(lr)),
                "count": int(np.asarray(_field(adam, "count"))),
                "exp_avg": moments(_field(adam, "mu")),
                "exp_avg_sq": moments(_field(adam, "nu")),
            },
            "generator": None,
        },
    }
