"""Metrics (counterpart of quantizedmha_tpu/utils/metrics.py, which imports
no JAX; the port keeps its own so it imports nothing of the JAX package).

Counters, gauges and accumulated timings — host-side only, cheap enough
to leave on. Only what the engine and chip_smoke.py use is here; the JAX
module's histograms, rates and renderings come over with their first
caller.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List


class Metrics:
    """Thread-safe metrics registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, List[float]] = {}  # name -> [count, total seconds]

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                entry = self._timings.setdefault(name, [0, 0.0])
                entry[0] += 1
                entry[1] += dt

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)
