"""Head-parallel (tensor-parallel) attention over a mesh (counterpart of
quantizedmha_tpu/parallel/shard.py).

Heads split across ranks need no communication during attention: each
rank runs the fused kernel on its block of batch and heads. With GQA, q
heads and kv heads shard over the same axis, so each query group sits
with its kv head (the axis size must divide num_kv_heads). The all-reduce
lands after the output projection in the model.

Contract: every rank passes the same global q, k, v; each gets back its
own block, [batch / dp, heads / tp, seq, head_dim], at its mesh
coordinates (JAX's out_specs P(batch_axis, head_axis)). A caller that
needs the whole output gathers the blocks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
from quantizedmha_tpu_torch.ops.flash_attention_int8 import flash_attention_int8


def _block(x: torch.Tensor, dim: int, mesh: DeviceMesh, axis: Optional[str]) -> torch.Tensor:
    """This rank's block of x along dim for mesh axis `axis` (all of x for
    None), raising as shard_map does when the axis does not divide it."""
    if axis is None:
        return x
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if x.shape[dim] % size:
        raise ValueError(
            f"head_parallel_attention: an array of shape {tuple(x.shape)} maps axis {dim} "
            f"(of size {x.shape[dim]}) to mesh axis {axis!r} (of size {size}), which is "
            f"not evenly divisible: {size} does not evenly divide {x.shape[dim]}")
    n = x.shape[dim] // size
    return x.narrow(dim, mesh.get_local_rank(axis) * n, n)


def head_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    *,
    head_axis: str = "tp",
    batch_axis: Optional[str] = "dp",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kernel: str = "fa",
) -> torch.Tensor:
    """Fused attention with heads sharded over `head_axis` (and batch over
    `batch_axis` if given). q/k/v: [batch, heads, seq, head_dim], global,
    the same on every rank; k/v may carry fewer heads than q (GQA).
    Returns this rank's block of the output. kernel "fa" is
    differentiable through flash_attention's backward; "fa_int8" refuses
    grad as flash_attention_int8 does."""
    impl = {"fa": flash_attention, "fa_int8": flash_attention_int8}[kernel]
    q, k, v = (_block(_block(x, 0, mesh, batch_axis), 1, mesh, head_axis) for x in (q, k, v))
    return impl(q, k, v, causal=causal, sm_scale=sm_scale)
