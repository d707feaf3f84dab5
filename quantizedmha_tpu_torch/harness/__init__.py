"""Verification + benchmark harness (counterpart of quantizedmha_tpu/harness;
the reference's drivers/ + utils/ layer).

- `timing`: latency by CUDA events (main.cu:130-147's warmup/timed loop).
- `verify`: tolerance gates + per-tensor error reports (utils/verify.cu:153-173).
- `data`:   input init and binary caches (inputs/data.cu, main.cu:15-19).
- `cli`:    the `bin/profile_<kernel>` equivalent (main.cu:38-157);
            `python -m quantizedmha_tpu_torch.harness`.
"""

from quantizedmha_tpu_torch.harness.data import (
    HostData,
    cached_inputs,
    cached_reference,
    initialize_host_data,
    load_case,
    save_case,
)
from quantizedmha_tpu_torch.harness.timing import Timing, benchmark
from quantizedmha_tpu_torch.harness.verify import ErrorReport, assert_close, compare

__all__ = [
    "HostData",
    "cached_inputs",
    "cached_reference",
    "initialize_host_data",
    "load_case",
    "save_case",
    "Timing",
    "benchmark",
    "ErrorReport",
    "assert_close",
    "compare",
]
