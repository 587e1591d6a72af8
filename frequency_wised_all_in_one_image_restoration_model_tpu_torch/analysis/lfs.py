"""Low-frequency-sensitivity (LFS) channel analysis, VTC-LFC style (the port
of the JAX ``analysis/lfs.py``; reference ``utils/lfs_visualization_utils.py``,
which ends inside ``get_mask_and_newcfg`` at line 243):

* :func:`gaussian_filter_fft` — Gaussian low-pass in the FFT domain
  preserving phase (reference ``filtering``, :62-101);
* :func:`lfs_gradients` — the mean parameter gradient of the distillation
  objective (:func:`distillation_loss_fn`: restoration L1 on filtered
  inputs, blended with a KL term against the teacher's degradation
  embedding; reference ``get_weight_mgrad``, :134-191), by autograd through
  the eval forward (``models/airnet.py::restore``): on the card the blocks'
  autograd Functions run the backward kernels;
* :func:`taylor_scores` — per-output-channel first-order Taylor importance
  ``sum((w * grad)^2)`` (reference ``taylor_score``, :193-200);
* :func:`channel_mask` — global threshold at a pruning ratio (the part the
  reference truncates).

The objective and its gradients run in float32 with TF32 off, where JAX
pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.metrics import full_float32
from .embeddings import to_numpy


def gaussian_filter_fft(images: torch.Tensor, cutoff: float = 0.065,
                        reverse: bool = False) -> torch.Tensor:
    """Gaussian low-pass of NHWC images in the FFT amplitude domain, float32.

    ``cutoff`` is the reference's ``L`` (kernel stddev ~ (K*L/2)^2); the
    phase is kept exactly (reference :62-101). ``reverse=False`` applies the
    ifftshifted kernel (low-pass); subtract from the input for the high
    band.
    """
    x = torch.as_tensor(images).float().permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    k = min(h, w)
    d0 = (k * cutoff / 2.0) ** 2
    m0 = (k - 1) / 2.0
    r = torch.arange(k, dtype=torch.float32, device=x.device)
    kernel = torch.exp(-((r[:, None] - m0) ** 2 + (r[None, :] - m0) ** 2)
                       / (2.0 * d0))
    if not reverse:
        kernel = torch.fft.ifftshift(kernel)
    f = torch.fft.fft2(x)
    amp = f.abs() * kernel
    pha = f.angle()
    filtered = torch.fft.ifft2(amp * torch.exp(1j * pha)).real
    return filtered.permute(0, 2, 3, 1)


def lfs_gradients(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                  batches: Iterable, *loss_args) -> Dict[str, torch.Tensor]:
    """Mean gradient of ``loss_fn(batch, *loss_args)`` with respect to
    ``params`` (name -> parameter) over the batches, by name (reference
    get_weight_mgrad accumulation, :180-190); a parameter the loss does not
    reach has a zero gradient, as ``jax.grad`` gives it."""
    names, tensors = list(params), list(params.values())
    acc = None
    n = 0
    for batch in batches:
        with full_float32():
            grads = torch.autograd.grad(loss_fn(batch, *loss_args), tensors,
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, tensors)]
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        n += 1
    return {name: a / n for name, a in zip(names, acc)}


def distillation_loss_fn(restore_fn: Callable, embed_fn: Callable,
                         teacher_embed: torch.Tensor, alpha: float = 0.1,
                         tau: float = 1.0) -> Callable:
    """Builds the LFS objective ``loss(batch)``: alpha * L1(restored, clean)
    + (1 - alpha) * KL(student || teacher) over softened embeddings
    (reference :163-173); ``restore_fn`` and ``embed_fn`` take the batch's
    degraded images ``d1``."""

    def loss(batch):
        with full_float32():
            restored = restore_fn(batch["d1"]).float()
            clean = torch.as_tensor(batch["c1"], device=restored.device)
            l1 = (restored - clean).abs().mean()
            student = embed_fn(batch["d1"]).float()
            s = F.log_softmax(student / tau, dim=1)
            t = F.log_softmax(teacher_embed.float() / tau, dim=1)
            kl = (t.exp() * (t - s)).sum() * (tau * tau) / student.numel()
            return l1 * alpha + kl * (1.0 - alpha)

    return loss


def output_axis(module: nn.Module, name: str) -> int:
    """The output-channel axis of ``module``'s parameter ``name``: a torch
    Linear / Conv2d weight keeps it first, a ConvTranspose2d weight second;
    the raw parameters keep JAX's layout, with it last (DCN ``weight`` HWIO,
    bias tables, ``lamb``, ``modulator``, ECA's ``conv``)."""
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return 1
    if name == "weight" and isinstance(module, (nn.Linear, nn.Conv2d)):
        return 0
    return -1


def taylor_scores(model: Union[nn.Module, Mapping[str, nn.Module]],
                  grads: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Per-output-channel importance ``sum((w * g)^2)`` for every parameter
    of two or more dims (kernels, tables; not biases or scales), by its
    ``/``-joined name (reference taylor_score, :193-200). ``grads`` is keyed
    by the dotted names, as :func:`lfs_gradients` gives them for
    ``model``'s ``named_parameters()`` (each under its key for a mapping).
    The scores of a leaf equal JAX's for the same leaf."""
    roots = model.items() if isinstance(model, Mapping) else (("", model),)
    scores: Dict[str, np.ndarray] = {}
    for key, root in roots:
        for mname, module in root.named_modules():
            for pname, p in module.named_parameters(recurse=False):
                name = ".".join(s for s in (key, mname, pname) if s)
                if p.dim() < 2:
                    continue
                axis = output_axis(module, pname)
                w = (p.detach().float() * grads[name].float()).movedim(axis, 0)
                scores[name.replace(".", "/")] = to_numpy(
                    (w.reshape(w.shape[0], -1) ** 2).sum(-1))
    return scores


def channel_mask(scores: Dict[str, np.ndarray], prune_ratio: float = 0.2
                 ) -> Tuple[Dict[str, np.ndarray], float]:
    """Global-threshold channel mask: prune the lowest ``prune_ratio`` of
    all channels by Taylor score (completes the reference's truncated
    get_mask_and_newcfg). Returns (masks, threshold)."""
    all_scores = np.concatenate([v for v in scores.values()])
    k = int(len(all_scores) * prune_ratio)
    thresh = float(np.sort(all_scores)[k]) if k > 0 else -np.inf
    masks = {name: v > thresh for name, v in scores.items()}
    return masks, thresh
