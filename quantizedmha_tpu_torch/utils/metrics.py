"""Metrics (counterpart of quantizedmha_tpu/utils/metrics.py, which imports
no JAX; the port keeps its own so it imports nothing of the JAX package).

Counters, gauges and latency histograms with a one-line text rendering
and a JSON snapshot: host-side only, cheap enough to leave on. The
engine's calls (inc, set, timed, counter) and the snapshot's keys are the
JAX module's.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import pathlib
import threading
import time
from typing import Dict, Optional


class _Histogram:
    """Fixed log-bucketed latency histogram (seconds): 25 edges from 1 us
    doubling to ~16.8 s, one bucket past the last."""

    _EDGES = [1e-6 * 2**i for i in range(25)]

    def __init__(self):
        self.counts = [0] * (len(self._EDGES) + 1)
        self.total = 0.0
        self.n = 0
        self.max = 0.0

    def record(self, value_s: float) -> None:
        idx = 0
        while idx < len(self._EDGES) and value_s > self._EDGES[idx]:
            idx += 1
        self.counts[idx] += 1
        self.total += value_s
        self.n += 1
        self.max = max(self.max, value_s)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper edges."""
        if not self.n:
            return 0.0
        target = math.ceil(q * self.n)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self._EDGES[min(i, len(self._EDGES) - 1)]
        return self.max

    def snapshot(self) -> dict:
        return {"count": self.n, "mean_s": self.mean, "p50_s": self.quantile(0.5),
                "p99_s": self.quantile(0.99), "max_s": self.max}


class Metrics:
    """Thread-safe metrics registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._t0 = time.monotonic()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value_s: float) -> None:
        with self._lock:
            self._hists.setdefault(name, _Histogram()).record(value_s)

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def rate(self, name: str) -> float:
        """Counter value per second of registry lifetime."""
        dt = time.monotonic() - self._t0
        return self.counter(name) / dt if dt > 0 else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"uptime_s": time.monotonic() - self._t0,
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "timings": {k: h.snapshot() for k, h in self._hists.items()}}

    def render(self) -> str:
        snap = self.snapshot()
        parts = [f"uptime={snap['uptime_s']:.1f}s"]
        parts += [f"{k}={v:g}" for k, v in sorted(snap["counters"].items())]
        parts += [f"{k}={v:g}" for k, v in sorted(snap["gauges"].items())]
        for k, h in sorted(snap["timings"].items()):
            parts.append(f"{k}[n={h['count']} mean={h['mean_s'] * 1e3:.2f}ms "
                         f"p99<={h['p99_s'] * 1e3:.2f}ms]")
        return " ".join(parts)

    def dump_json(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.snapshot(), indent=2))


# Process-global default registry (opt-in convenience).
_default: Optional[Metrics] = None
_default_lock = threading.Lock()


def default_metrics() -> Metrics:
    global _default
    with _default_lock:
        if _default is None:
            _default = Metrics()
        return _default
