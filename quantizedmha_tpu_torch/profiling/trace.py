"""torch.profiler trace capture (counterpart of
quantizedmha_tpu/profiling/trace.py, the `ncu --export` workflow reborn).

The reference's profiling loop ran `bin/profile_<kernel>` under `ncu --set
full --export` (its README.md:142-156). Here `capture` runs a function under
torch.profiler (CPU activity, and CUDA activity when a card is present)
after warm-up calls, so that the trace holds steady-state work and no
first-use builds, and writes the Chrome trace (`trace.json`, for
chrome://tracing or Perfetto, read back by `trace_summary.summarize_trace`)
beside `capture_summary.json`.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import pathlib
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from quantizedmha_tpu_torch.harness.timing import _on_cuda


@dataclasses.dataclass(frozen=True)
class TraceCapture:
    trace_dir: str
    wall_s: float
    iters: int
    files: list

    @property
    def per_iter_ms(self) -> float:
        return self.wall_s / self.iters * 1e3


def capture(
    fn: Callable,
    *args,
    trace_dir="profiles/traces/run",
    iters: int = 5,
    warmup: int = 2,
) -> TraceCapture:
    """Run `fn(*args)` `iters` times under torch.profiler, after `warmup`
    untraced calls. wall_s is the traced window's host time, closed by a
    device synchronize when the work runs on the card."""
    trace_dir = str(trace_dir)
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    cuda = _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    files = sorted(
        os.path.relpath(p, trace_dir)
        for p in glob.glob(os.path.join(trace_dir, "**", "*"), recursive=True)
        if os.path.isfile(p) and not p.endswith("capture_summary.json")
    )
    cap = TraceCapture(trace_dir=trace_dir, wall_s=wall, iters=iters, files=files)
    summary = {
        "trace_dir": trace_dir,
        "iters": iters,
        "wall_s": wall,
        "per_iter_ms": cap.per_iter_ms,
        "files": files,
    }
    pathlib.Path(trace_dir, "capture_summary.json").write_text(
        json.dumps(summary, indent=2)
    )
    return cap


def annotate(name: str):
    """Named trace region (the `cudaProfilerStart/Stop` bracket analog,
    usable as decorator or context manager)."""
    return record_function(name)
