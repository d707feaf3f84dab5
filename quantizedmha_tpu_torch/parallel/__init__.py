from quantizedmha_tpu_torch.parallel.combine import merge_partial_attention, merge_two_partials
from quantizedmha_tpu_torch.parallel.mesh import make_mesh
from quantizedmha_tpu_torch.parallel.ring import (
    context_parallel_attention,
    ring_attention,
    ring_attention_int8,
)
from quantizedmha_tpu_torch.parallel.shard import head_parallel_attention

__all__ = [
    "make_mesh",
    "merge_partial_attention",
    "merge_two_partials",
    "head_parallel_attention",
    "ring_attention",
    "ring_attention_int8",
    "context_parallel_attention",
]
