from quantizedmha_tpu_torch.parallel.combine import merge_partial_attention, merge_two_partials
from quantizedmha_tpu_torch.parallel.distributed import (
    audit_bytes_by_axis,
    audit_fn_by_axis,
    classify_collectives,
    collective_bytes,
    hybrid_mesh,
    initialize_multihost,
    model_scaling_efficiency,
    record_collectives,
)
from quantizedmha_tpu_torch.parallel.mesh import P, PartitionSpec, make_mesh
from quantizedmha_tpu_torch.parallel.pipeline import pipeline_llama_forward
from quantizedmha_tpu_torch.parallel.ring import (
    context_parallel_attention,
    ring_attention,
    ring_attention_int8,
)
from quantizedmha_tpu_torch.parallel.shard import head_parallel_attention

__all__ = [
    "P",
    "PartitionSpec",
    "audit_bytes_by_axis",
    "audit_fn_by_axis",
    "classify_collectives",
    "collective_bytes",
    "hybrid_mesh",
    "initialize_multihost",
    "model_scaling_efficiency",
    "record_collectives",
    "make_mesh",
    "merge_partial_attention",
    "merge_two_partials",
    "head_parallel_attention",
    "ring_attention",
    "ring_attention_int8",
    "context_parallel_attention",
    "pipeline_llama_forward",
]
