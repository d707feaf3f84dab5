"""Collective audit: count and size the collectives a call issues
(counterpart of quantizedmha_tpu/profiling/collectives.py).

The multi-GPU paths (parallel/ and serving/sharded.py) make claims like "2
all-reduces a layer" and "the INT8 ring rotates a quarter of the float
ring's bytes". The JAX package checks them from compiled HLO; here they are
checked from what ran: `parallel.distributed.record_collectives` wraps
torch.distributed's calls for the length of a call, and `audit_events`
counts and sizes the records by kind. Counts are of executions (a ring
step in a loop counts once a step), not static occurrences.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Sequence

from quantizedmha_tpu_torch.parallel.distributed import Collective, record_collectives


@dataclasses.dataclass(frozen=True)
class CollectiveReport:
    counts: Dict[str, int]          # kind -> calls issued
    bytes_by_kind: Dict[str, int]   # kind -> total result bytes
    total_bytes: int

    def __str__(self) -> str:
        if not self.counts:
            return "no collectives"
        parts = [f"{kind} x{self.counts[kind]} ({self.bytes_by_kind[kind] / 2**20:.2f} MiB)"
                 for kind in sorted(self.counts)]
        return ", ".join(parts) + f" | total {self.total_bytes / 2**20:.2f} MiB"


def audit_events(records: Sequence[Collective]) -> CollectiveReport:
    """Count the recorded collectives and sum their result bytes by kind
    (the counterpart of JAX's audit_hlo)."""
    counts: Counter = Counter()
    nbytes: Counter = Counter()
    for r in records:
        counts[r.kind] += 1
        nbytes[r.kind] += r.nbytes
    return CollectiveReport(counts=dict(counts), bytes_by_kind=dict(nbytes),
                            total_bytes=sum(nbytes.values()))


def audit_fn(fn, *args, **kwargs) -> CollectiveReport:
    """Run fn(*args, **kwargs) and audit the collectives it issued. Every
    rank of the groups involved must make the same call."""
    with record_collectives() as records:
        fn(*args, **kwargs)
    return audit_events(records)
