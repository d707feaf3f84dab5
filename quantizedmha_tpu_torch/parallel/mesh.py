"""Device-mesh construction (counterpart of quantizedmha_tpu/parallel/mesh.py).

The JAX package names its chips' axes with a jax.sharding.Mesh and lets
XLA insert the collectives. Here a mesh is a torch.distributed DeviceMesh
over the ranks of the default process group, which the caller initializes
(`torch.distributed.init_process_group`, one rank a GPU); each named axis
has its own process group (`mesh.get_group(name)`) for the collectives of
`parallel/combine.py` and `parallel/ring.py`. `PartitionSpec` (`P`) names,
for each dim of a tensor, the mesh axis it is cut over (None: replicated),
as JAX's does; `serving.sharded.shard_params` cuts a rank's shard by it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class PartitionSpec(tuple):
    """JAX's PartitionSpec: one entry a tensor dim, the mesh axis name that
    dim is cut over or None (replicated). A tuple, so it compares equal to
    JAX's spec of the same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of the given logical shape over the first ranks of the
    initialized default group (row-major, as the JAX package lays devices
    out). device_type "cuda" pairs each rank with a GPU (NCCL); "cpu" runs
    on gloo. Example: make_mesh((2, 4), ("dp", "tp")) on 8 ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    n = math.prod(axis_sizes)
    have = dist.get_world_size()
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")
    ranks = torch.arange(n).reshape(tuple(axis_sizes))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def infer_dp_tp(n_devices: int, num_kv_heads: int) -> Tuple[int, int]:
    """Largest tp that divides both the device count and the KV head count
    (GQA co-location: each device owns whole KV heads)."""
    tp = 1
    for cand in range(min(n_devices, num_kv_heads), 0, -1):
        if n_devices % cand == 0 and num_kv_heads % cand == 0:
            tp = cand
            break
    return n_devices // tp, tp
