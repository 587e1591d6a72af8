"""Capture of intermediate tensors by module path: the port's counterpart
of Flax's ``sow('intermediates', ...)`` with ``mutable=['intermediates']``
(JAX ``models/uformer_blocks.py:339-343, 448-453``).

While ``with capture(root) as cap:`` is active, the modules under ``root``
behave as the JAX modules do when their intermediates are mutable:

* a :class:`~.uformer_lewin.LeWinBlock` takes its unfused path (JAX turns
  both fused forms off there, ``uformer_lewin.py:109, 186``);
* a ``WindowAttention`` forms the attention probabilities in plain PyTorch
  (JAX's ``need_probs``) and records ``attn_map`` after the band
  modulations (the unmodulated map on all_DC's rank-1 path) and the gains
  ``embed_lamb_<i>`` ``[B, 1, h]``;
* a ``FrequencyWindowAttention`` forms them too and records ``attn_map``,
  the band-grouped ``[B', h, L*n, L*n]`` map.

Modules outside ``root`` run as always, and nothing changes outside the
context: the same routes and the same kernel launches. Each recorded
tensor is detached and moved to the host as it is recorded (an encoder
inter map at full width is about 38 MB an image). Keys are JAX's: the
module's ``named_modules()`` path under ``root`` with ``/`` for ``.`` (the
port's names mirror the Flax tree), the name, and the call's index (a
``sow`` keeps a tuple), e.g. ``encoderlayer_0/block0/attn/attn_map/0``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn

_ACTIVE: List["Capture"] = []


class Capture:
    """The tensors recorded under one ``root``, by key."""

    def __init__(self, root: nn.Module):
        self._paths = {id(m): name.replace(".", "/")
                       for name, m in root.named_modules()}
        self.records: Dict[str, torch.Tensor] = {}
        self._calls: Dict[tuple, int] = {}

    def covers(self, module: nn.Module) -> bool:
        return id(module) in self._paths

    def record(self, module: nn.Module, name: str, value: torch.Tensor) -> None:
        path = self._paths[id(module)]
        call = self._calls.get((path, name), 0)
        self._calls[(path, name)] = call + 1
        key = "/".join(p for p in (path, name, str(call)) if p)
        self.records[key] = value.detach().to("cpu", copy=True)

    def named(self, name: str) -> Dict[str, torch.Tensor]:
        """The records whose name (the key's second-last part) starts with
        ``name``."""
        return {k: v for k, v in self.records.items()
                if k.split("/")[-2].startswith(name)}


@contextlib.contextmanager
def capture(root: nn.Module) -> Iterator[Capture]:
    """Record the intermediates of the modules under ``root`` while the
    context is active."""
    cap = Capture(root)
    _ACTIVE.append(cap)
    try:
        yield cap
    finally:
        _ACTIVE.remove(cap)


def active(module: nn.Module) -> Optional[Capture]:
    """The innermost active capture that covers ``module``, else None."""
    for cap in reversed(_ACTIVE):
        if cap.covers(module):
            return cap
    return None


def record(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Record ``value`` under ``module``'s path, if a capture covers it."""
    cap = active(module)
    if cap is not None:
        cap.record(module, name, value)
