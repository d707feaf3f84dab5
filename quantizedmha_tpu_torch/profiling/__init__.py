"""Profiling suite (counterpart of quantizedmha_tpu/profiling; the reference's
NCU workflow, tools/ and profiles/ reborn).

- `roofline`:      achieved TFLOP/s vs tensor-core/HBM speed-of-light.
- `trace`:         torch.profiler capture around the timed loop.
- `trace_summary`: per-kernel device time from a captured trace.
- `memory`:        one call's memory budget from the CUDA allocator.
- `device_info`:   hardware-limits dump (tools/device_info.cu analog).
- `compare`:       markdown diff of two bench reports.

Not ported yet: `collectives` (waits for multi-GPU, ROADMAP.md queue 1
item 8).
"""

from quantizedmha_tpu_torch.profiling.compare import compare_files, compare_reports
from quantizedmha_tpu_torch.profiling.device_info import (
    device_info as get_device_info,
    dump as dump_device_info,
)
from quantizedmha_tpu_torch.profiling import device_info  # noqa: F401 — keep submodule name
from quantizedmha_tpu_torch.profiling.roofline import (
    ChipSpec,
    RooflineReport,
    attention_bytes,
    attention_flops,
    detect_chip,
    roofline,
)
from quantizedmha_tpu_torch.profiling.memory import MemoryBudget, memory_budget
from quantizedmha_tpu_torch.profiling.trace import TraceCapture, annotate, capture
from quantizedmha_tpu_torch.profiling.trace_summary import (
    OpStat,
    TraceSummary,
    summarize_trace,
)

__all__ = [
    "compare_files",
    "compare_reports",
    "get_device_info",
    "dump_device_info",
    "ChipSpec",
    "RooflineReport",
    "attention_bytes",
    "attention_flops",
    "detect_chip",
    "roofline",
    "TraceCapture",
    "annotate",
    "capture",
    "MemoryBudget",
    "memory_budget",
    "OpStat",
    "TraceSummary",
    "summarize_trace",
]
