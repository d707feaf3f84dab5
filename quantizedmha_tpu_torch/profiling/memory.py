"""Per-call device memory budgets (counterpart of
quantizedmha_tpu/profiling/memory.py, the PTXAS budget tracking analog).

The reference tracked per-kernel register/SMEM budgets from PTXAS output;
the JAX package reads XLA's compiled-memory analysis of a jitted function.
PyTorch compiles nothing ahead, so the budget comes from one call: the
bytes of the tensors passed and returned, and the CUDA caching allocator's
peak during the call. The purpose is the same: catching a change that
silently doubles a call's scratch memory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from quantizedmha_tpu_torch.harness.timing import tensors_in


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """argument_bytes / output_bytes: the tensors passed and returned (each
    storage once). temp_bytes: the allocator's peak during the call above
    what was allocated before it, less the outputs (None off the card: the
    CPU has no allocator statistics). alias_bytes: output bytes that share
    an argument's storage. generated_code_bytes has no CUDA meaning (kernel
    images are not allocated through the caching allocator) and is 0."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: Optional[int]
    generated_code_bytes: int
    alias_bytes: int

    @property
    def total_bytes(self) -> int:
        return (self.argument_bytes + self.output_bytes + (self.temp_bytes or 0)
                + self.generated_code_bytes - self.alias_bytes)

    def __str__(self) -> str:
        mb = 1024 * 1024
        temp = ("not measured" if self.temp_bytes is None
                else f"{self.temp_bytes / mb:.1f} MiB")
        return (
            f"args {self.argument_bytes / mb:.1f} MiB | "
            f"out {self.output_bytes / mb:.1f} MiB | "
            f"temp {temp} | "
            f"code {self.generated_code_bytes / mb:.2f} MiB | "
            f"total {self.total_bytes / mb:.1f} MiB"
        )


def _storages(tensors) -> dict:
    """{storage pointer: bytes} of the tensors' storages."""
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}


def memory_budget(fn: Callable, *args, **kwargs) -> MemoryBudget:
    """Call `fn(*args, **kwargs)` once and report its memory budget. On the
    card the allocator's peak is reset before the call, so the call should
    not run beside other work on the same device."""
    arg_tensors = tensors_in(list(args) + list(kwargs.values()))
    cuda = any(t.is_cuda for t in arg_tensors)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    args_st = _storages(arg_tensors)
    out_st = _storages(tensors_in(out))
    output_bytes = sum(out_st.values())
    temp = None
    if cuda:
        torch.cuda.synchronize()
        fresh = sum(n for p, n in out_st.items() if p not in args_st)
        temp = max(torch.cuda.max_memory_allocated() - before - fresh, 0)
    return MemoryBudget(
        argument_bytes=sum(args_st.values()),
        output_bytes=output_bytes,
        temp_bytes=temp,
        generated_code_bytes=0,
        alias_bytes=sum(n for p, n in out_st.items() if p in args_st),
    )
