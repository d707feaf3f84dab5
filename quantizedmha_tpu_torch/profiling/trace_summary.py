"""Trace summarization (counterpart of
quantizedmha_tpu/profiling/trace_summary.py): per-kernel device time.

`profiling.trace.capture` writes a torch.profiler Chrome trace; this reads
it back into a per-kernel table, sorted by total time, and groups the
kernels by KERNEL_GROUPS (the port's own kernels by source, cuBLAS, dtype
casts), the grouping `chip_smoke.py`'s profiles use too. A trace without
device kernels (a CPU run) is summarized on its host plane: the top-level
operators and annotated regions of each thread, so that nested ones are
not counted twice.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

# (group, substrings of a device kernel's name): the first group whose
# substring the name holds takes the kernel; the rest are "other".
KERNEL_GROUPS = (("w4_matmul", ("w4_matmul_kernel", "w4_matmul_wgmma_kernel",
                                 "w4_reduce_kernel")),
                 ("flash_int8_fwd", "flash_int8"), ("flash_fwd", "flash_fwd"),
                 ("flash_bwd", "flash_bwd"),
                 ("paged_prefill", "paged_prefill"), ("paged_decode", "paged_decode"),
                 ("paged_decode merge", "decode_merge"),
                 ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("direct_copy (dtype casts)", "direct_copy"))

# Chrome-trace categories of device work, and of host operators and
# annotate() regions.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")


def group_of(name: str) -> str:
    """The KERNEL_GROUPS group of a device kernel's name, else "other"."""
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in ((keys,) if isinstance(keys, str) else keys))),
                "other")


def group_kernels(kernels: Iterable[Tuple[str, float]]):
    """({name: (us, launches)}, {group: (us, launches)}, busy seconds) of
    (kernel name, microseconds) pairs."""
    by_name, by_group = {}, {}
    for name, us in kernels:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, n + 1)
        group = group_of(name)
        t, n = by_group.get(group, (0.0, 0))
        by_group[group] = (t + us, n + 1)
    return by_name, by_group, sum(t for t, _ in by_name.values()) / 1e6


@dataclasses.dataclass(frozen=True)
class OpStat:
    name: str
    count: int
    total_ms: float

    @property
    def avg_us(self) -> float:
        return self.total_ms * 1e3 / self.count if self.count else 0.0


@dataclasses.dataclass(frozen=True)
class TraceSummary:
    trace_dir: str
    plane: str  # "device" (CUDA kernels) or "host" (CPU operators)
    total_ms: float
    ops: List[OpStat]  # sorted by total time, descending
    groups: List[OpStat] = dataclasses.field(default_factory=list)  # KERNEL_GROUPS

    def to_markdown(self, top: int = 20) -> str:
        lines = [
            f"# Trace summary — `{self.plane}`",
            "",
            f"trace: `{self.trace_dir}` | total {self.plane} time "
            f"{self.total_ms:.3f} ms",
            "",
            "| op | count | total ms | avg µs | % |",
            "|---|---|---|---|---|",
        ]
        for op in self.ops[:top]:
            pct = 100.0 * op.total_ms / self.total_ms if self.total_ms else 0.0
            lines.append(
                f"| `{op.name[:60]}` | {op.count} | {op.total_ms:.3f} | "
                f"{op.avg_us:.1f} | {pct:.1f} |"
            )
        if self.groups:
            lines += ["", "| group | launches | total ms | % |", "|---|---|---|---|"]
            for g in self.groups:
                pct = 100.0 * g.total_ms / self.total_ms if self.total_ms else 0.0
                lines.append(f"| {g.name} | {g.count} | {g.total_ms:.3f} | {pct:.1f} |")
        return "\n".join(lines)


def _stats(agg: Dict[str, Tuple[float, int]]) -> List[OpStat]:
    return sorted((OpStat(name=n, count=c, total_ms=us / 1e3) for n, (us, c) in agg.items()),
                  key=lambda o: -o.total_ms)


def _top_level(events: List[dict]) -> List[dict]:
    """The events of each (pid, tid) not nested inside another one."""
    out = []
    ends: Dict[tuple, float] = {}
    for ev in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e["dur"])):
        key = (ev.get("pid"), ev.get("tid"))
        if ev["ts"] >= ends.get(key, float("-inf")):
            out.append(ev)
            ends[key] = ev["ts"] + ev["dur"]
    return out


def summarize_trace(
    trace_dir: str,
    *,
    plane_filter: Optional[str] = None,
) -> TraceSummary:
    """Aggregate per-kernel time from the newest `*.json` Chrome trace
    under `trace_dir` (as written by profiling.trace.capture).

    plane_filter: "device" or "host"; default the device plane when the
    trace holds device kernels, else the host plane.
    """
    paths = sorted(
        (p for p in glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
         if not p.endswith("capture_summary.json")),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no *.json trace under {trace_dir}")
    with open(paths[-1]) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    plane = plane_filter or ("device" if device else "host")
    if plane == "device":
        chosen = device
    elif plane == "host":
        chosen = _top_level([e for e in events if e.get("cat") in _HOST_CATS])
    else:
        raise ValueError(f"plane_filter must be 'device' or 'host', got {plane_filter!r}")
    by_name, by_group, busy_s = group_kernels((e["name"], float(e["dur"])) for e in chosen)
    return TraceSummary(
        trace_dir=str(trace_dir),
        plane=plane,
        total_ms=busy_s * 1e3,
        ops=_stats(by_name),
        groups=_stats(by_group) if plane == "device" else [],
    )
