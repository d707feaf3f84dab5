"""Benchmark timing core (counterpart of quantizedmha_tpu/harness/timing.py).

The reference's measured hot loop is `warmup x W; runs x R` around `solve()`
(its drivers/main.cu:130-147). Here each of `repeats` samples times `runs`
back-to-back calls: on the card by two CUDA events around the launches
(the host returns before the device finishes, so only the events see the
device's time), on the CPU by `time.perf_counter` (PyTorch's CPU ops run
to completion before they return). A sample's estimate is its time over
`runs`; the headline is the median of the samples and `best_s` their
minimum. The JAX package's two-point fit exists for a backend whose sync
returns early; CUDA events need no such fit.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List

import torch


@dataclasses.dataclass(frozen=True)
class Timing:
    estimate_s: float       # median of the per-sample estimates (the headline)
    pair_estimates_s: List[float]  # one estimate per sample (spread diagnostic)
    best_s: float = 0.0     # the fastest sample's estimate (see best_ms)

    @property
    def median_s(self) -> float:
        return self.estimate_s

    @property
    def median_ms(self) -> float:
        return self.estimate_s * 1e3

    @property
    def best_ms(self) -> float:
        """The fastest sample's per-call time; the estimate when none was
        recorded."""
        if self.best_s > 0.0:
            return self.best_s * 1e3
        return self.estimate_s * 1e3

    @property
    def spread(self) -> float:
        """Relative spread of the samples' estimates (noise indicator)."""
        if len(self.pair_estimates_s) < 2:
            return 0.0
        lo, hi = min(self.pair_estimates_s), max(self.pair_estimates_s)
        return (hi - lo) / self.estimate_s if self.estimate_s else 0.0

    def __str__(self) -> str:
        return (
            f"{self.estimate_s * 1e3:.3f} ms "
            f"(pairs: {', '.join(f'{t * 1e3:.3f}' for t in self.pair_estimates_s)})"
        )


def tensors_in(x) -> List[torch.Tensor]:
    """The tensors of a result: a tensor, or a tuple, list or dict of them
    (nested)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in tensors_in(item)]
    return []


def _on_cuda(out) -> bool:
    return any(t.is_cuda for t in tensors_in(out))


def _sample_s(fn: Callable, args, runs: int, cuda: bool) -> float:
    """Per-call seconds of `runs` back-to-back calls."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn(*args)
    return (time.perf_counter() - t0) / runs


def benchmark(
    fn: Callable,
    *args,
    warmup: int = 2,
    runs: int = 16,
    repeats: int = 3,
) -> Timing:
    """Per-call latency of `fn(*args)`.

    warmup:  calls before timing (first-use costs: kernel builds, cuBLAS
             handles, the allocator's first blocks); at least one, whose
             result says where the work runs (CUDA events when it holds a
             CUDA tensor).
    runs:    calls in each timed sample.
    repeats: timed samples; the estimate is their median.
    """
    if runs < 1 or repeats < 1:
        raise ValueError(f"runs and repeats must be >= 1, got {runs}, {repeats}")
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    cuda = _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()
    samples = [_sample_s(fn, args, runs, cuda) for _ in range(repeats)]
    return Timing(statistics.median(samples), samples, min(samples))
