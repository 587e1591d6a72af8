"""Background-thread batch prefetcher.

A copy of the JAX package's ``data/prefetch.py``. The reference overlaps
host preprocessing with GPU compute via 16 DataLoader worker processes
(train.py:50-51). Here one background thread suffices: the native I/O
runtime releases the GIL during decode/augment/noise, so host preparation
of batch N+1..N+depth overlaps the card's step N.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator


class Prefetcher:
    """Wraps a loader with a ``next_batch()`` method; keeps up to ``depth``
    batches ready."""

    def __init__(self, loader: Any, depth: int = 2):
        self.loader = loader
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.loader.next_batch()
            except Exception as e:  # surface errors on the consumer side
                self._q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> Dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __getattr__(self, name):
        return getattr(self.loader, name)
