"""Training throughput meter (the ``StepMeter`` of the JAX package's
``utils/profiling.py``), timed on the card with CUDA events.

A step is queued on the device long before it has run, so the host clock
between two ``step()`` calls measures the queueing. The meter records one
event per step and, every ``every`` steps, waits for the newest and reads
the device time since the window began: one host sync per window. On the
CPU it falls back to the host clock.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class StepMeter:
    """steps/s, samples/s and trained MP/s, reported every ``every`` steps."""

    def __init__(self, batch: int, patch: int, every: int = 50, device=None):
        self.batch, self.patch, self.every = batch, patch, every
        self.n = 0
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._mark()

    def _mark(self) -> None:
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def step(self) -> Optional[Dict[str, float]]:
        self.n += 1
        if self.n % self.every:
            return None
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self.start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self.t0
        stats = {
            "steps_per_sec": self.every / dt,
            "samples_per_sec": self.every * self.batch / dt,
            "train_mps": self.every * self.batch * self.patch ** 2 / dt / 1e6,
        }
        self._mark()
        return stats
