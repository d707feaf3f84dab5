"""Tensor-parallel (TP) serving: sharded weights and KV cache over a process
group (counterpart of quantizedmha_tpu/serving/sharded.py).

Megatron-style TP for the decoder: wq / wk / wv and w_gate / w_up are cut on
their output columns over the `tp` mesh axis (contiguous head groups), wo
and w_down on their input rows; norms, embeddings and the lm_head are
replicated. Each rank allocates its own paged cache from `local_config`, so
its pages hold only its own kv heads and the paged kernels run on them
unchanged. The only collectives are the two all-reduces a layer inside
llama_adapter (after wo and after w_down).

Where the JAX package runs one program under shard_map over a virtual or
real mesh, here every rank is a process that runs the same host code
(SPMD): the scheduler (admission, page tables, sampling from the same
seeded generator) is unchanged and identical on every rank, and the
adapter's `group` all-reduces over the `tp` axis's process group.

Shards are cut by `shard_params` (JAX's shard_tree) from PartitionSpecs
(`parallel.mesh.P`). The full parameters may be made on demand
(`LayerStack`, `Lazy`), one layer at a time in the mapping's order, so that
a rank never holds a whole large model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quantizedmha_tpu_torch.models.llama import LlamaConfig
from quantizedmha_tpu_torch.parallel.mesh import P, make_mesh
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight, QuantizedWeight4
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.kv_cache import PagedKVCacheState
from quantizedmha_tpu_torch.serving.mixed_kv import MixedPagedKVState
from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine


def local_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """Per-shard config: head counts divided by the TP degree."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads}")
    # Pin head_dim: it defaults to hidden_size // num_heads, which would be
    # wrong once num_heads shrinks to the per-shard count.
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp, head_dim=cfg.hd)


def tp_param_specs(axis: str = "tp", attention_bias: bool = False,
                   sandwich_norms: bool = False) -> Dict[str, Any]:
    """PartitionSpecs mirroring models.llama.init_params' structure.

    Cutting wq on its flattened [hid, H*hd] output dim splits contiguous head
    groups (the reshape to [.., H, hd] is head-major), so each shard's heads
    line up with its shard of the kv cache."""
    layers = dict(
        attn_norm=P(None, None),
        wq=P(None, None, axis),
        wk=P(None, None, axis),
        wv=P(None, None, axis),
        wo=P(None, axis, None),
        mlp_norm=P(None, None),
        w_gate=P(None, None, axis),
        w_up=P(None, None, axis),
        w_down=P(None, axis, None),
    )
    if attention_bias:
        # Qwen2-style q/k/v biases shard with their projection's output dim.
        layers["bq"] = P(None, axis)
        layers["bk"] = P(None, axis)
        layers["bv"] = P(None, axis)
    if sandwich_norms:
        # Gemma-2's post-norms act on the full hidden row (after the
        # all-reduce), so they replicate like the pre-norms.
        layers["post_attn_norm"] = P(None, None)
        layers["post_mlp_norm"] = P(None, None)
    return dict(embed=P(None, None), layers=layers, final_norm=P(None),
                lm_head=P(None, None))


def tp_cache_specs(axis: str = "tp") -> PagedKVCacheState:
    """Specs of the layer-stacked cache [L, Hkv, ...]: kv heads sharded. Each
    rank allocates its own shard (local_config's kv heads); the specs record
    which axis that is."""
    return PagedKVCacheState(
        k_pages=P(None, axis, None, None, None),
        v_pages=P(None, axis, None, None, None),
        k_scales=P(None, axis, None),
        v_scales=P(None, axis, None),
    )


def tp_mixed_cache_specs(axis: str = "tp") -> MixedPagedKVState:
    """Specs of the layer-stacked mixed cache: both pools shard their kv-head
    axis, like the plain paged cache (nibble packing halves the trailing dim,
    which stays whole)."""
    pool = P(None, axis, None, None, None)  # [L, Hkv, n, page, hd(/2)]
    return MixedPagedKVState(
        k8=pool, v8=pool,
        k8_scales=P(None, axis, None), v8_scales=P(None, axis, None),
        k4=pool, v4=pool,
        k4_scales=P(None, axis, None, None),  # [L, Hkv, n4, subs]
        v4_scales=P(None, axis, None, None),
    )


def _expand(x, s):
    """One leaf's spec matched to its type: a QuantizedWeight's values take
    the weight spec and its per-output-channel scale the spec without the
    input dim (column shards cut their scales, row shards replicate them); a
    QuantizedWeight4 keeps the weight spec on `packed` ([.., in/2, out] has
    the same axes) and cuts its group scale [.., in/G, out] on both."""
    if isinstance(x, QuantizedWeight) and not isinstance(s, QuantizedWeight):
        return QuantizedWeight(values=s, scale=P(*s[:-2], s[-1]))
    if isinstance(x, QuantizedWeight4) and not isinstance(s, QuantizedWeight4):
        return QuantizedWeight4(packed=s, scale=P(*s[:-2], s[-2], s[-1]), group=x.group,
                                packing=x.packing)
    return s


def expand_param_specs(params: Any, specs: Any) -> Any:
    """The spec tree matched to the parameters' structure (JAX's
    expand_param_specs): each QuantizedWeight / QuantizedWeight4 leaf's spec
    expanded as _expand says. Leaves made on demand keep their plain spec."""
    if isinstance(params, dict):
        _check_keys(params, specs)
        return {k: expand_param_specs(v, specs[k]) for k, v in params.items()}
    return _expand(params, specs)


@dataclasses.dataclass
class LayerStack:
    """A layer-stacked leaf made on demand: make(i) returns layer i (a tensor
    or a quantized weight, without the leading layer dim). shard_params
    calls make(0), ..., make(n - 1) in order and keeps only each layer's
    shard."""
    num_layers: int
    make: Callable[[int], Any]


@dataclasses.dataclass
class Lazy:
    """A leaf made on demand by make(), once, when shard_params reaches it."""
    make: Callable[[], Any]


_FUSED = {"wqkv": "wq, wk and wv", "w_gateup": "w_gate and w_up"}


def _check_keys(params: Dict[str, Any], specs: Any) -> None:
    if not isinstance(specs, dict):
        raise ValueError(f"params are a mapping where the specs hold {specs!r}")
    for k in params:
        if k in _FUSED:
            raise ValueError(
                f"{k!r} is a fused projection (quant.weights.fuse_w4_projections), which has "
                f"no tensor-parallel spec: its shard would need columns of each of "
                f"{_FUSED[k]}. Shard the unfused layout ({_FUSED[k]} apart) and fuse after")
        if k not in specs:
            raise ValueError(f"parameter {k!r} has no PartitionSpec (specs: {sorted(specs)})")


def _axis_coords(mesh_or_rank: Union[DeviceMesh, Tuple[int, int]], axis: str) -> Tuple[int, int]:
    """(this rank's index along `axis`, the axis size) from a DeviceMesh or
    an explicit (rank, size) pair."""
    if isinstance(mesh_or_rank, DeviceMesh):
        names = mesh_or_rank.mesh_dim_names or ()
        if axis not in names:
            raise ValueError(f"mesh axes {names} have no {axis!r}")
        return mesh_or_rank.get_local_rank(axis), mesh_or_rank.size(names.index(axis))
    rank, size = mesh_or_rank
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside an axis of size {size}")
    return rank, size


def _out_major(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and not t.is_contiguous() and t.transpose(-1, -2).is_contiguous()


def _cut(t: torch.Tensor, spec, axis: str, rank: int, size: int) -> torch.Tensor:
    """This rank's block of tensor t by spec: every dim whose entry is `axis`
    narrowed to the rank's contiguous part. A cut leaf is a fresh tensor of
    the source's layout (an out-major INT8 weight stays out-major: on a
    row-major one torch._int_mm runs 6.6-7.8x slower); a whole leaf is t."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec!r} has {len(spec)} entries for a {t.dim()}-d tensor "
                         f"{tuple(t.shape)}")
    view = t
    for d, name in enumerate(spec):
        if name is None:
            continue
        if name != axis:
            raise ValueError(f"spec {spec!r} names axis {name!r}; shard_params cuts {axis!r}")
        if t.shape[d] % size:
            raise ValueError(
                f"an array of shape {tuple(t.shape)} maps axis {d} (of size {t.shape[d]}) to "
                f"mesh axis {axis!r} (of size {size}), which is not evenly divisible: "
                f"{size} does not evenly divide {t.shape[d]}")
        n = t.shape[d] // size
        view = view.narrow(d, rank * n, n)
    if view is t:
        return t
    if _out_major(t):
        return view.transpose(-1, -2).clone(memory_format=torch.contiguous_format).transpose(-1, -2)
    return view.clone(memory_format=torch.contiguous_format)


def _cut_leaf(x, spec, axis, rank, size):
    spec = _expand(x, spec)
    if isinstance(x, QuantizedWeight):
        return QuantizedWeight(values=_cut(x.values, spec.values, axis, rank, size),
                               scale=_cut(x.scale, spec.scale, axis, rank, size))
    if isinstance(x, QuantizedWeight4):
        if x.packing == "halves" and spec.packed[-2] == axis:
            raise ValueError(
                "a 'halves'-packed INT4 weight cut on its input rows would mix rows of both "
                "halves in each shard (packed row i holds input rows i and in/2 + i); "
                "quantize with packing='pairs' for tensor parallelism")
        if spec.packed[-2] == axis and (x.in_features // x.group) % size:
            raise ValueError(f"{x.in_features // x.group} scale groups of {x.group} rows do "
                             f"not split evenly over {size} ranks")
        return QuantizedWeight4(packed=_cut(x.packed, spec.packed, axis, rank, size),
                                scale=_cut(x.scale, spec.scale, axis, rank, size),
                                group=x.group, packing=x.packing)
    return _cut(x, spec, axis, rank, size)


def _empty_stack(n: int, first):
    """An [n, ...] stack for layers shaped and laid out like `first`."""
    if isinstance(first, QuantizedWeight):
        return QuantizedWeight(_empty_stack(n, first.values), _empty_stack(n, first.scale))
    if isinstance(first, QuantizedWeight4):
        return QuantizedWeight4(_empty_stack(n, first.packed), _empty_stack(n, first.scale),
                                first.group, first.packing)
    if _out_major(first):
        *lead, a, b = first.shape
        return torch.empty((n, *lead, b, a), dtype=first.dtype,
                           device=first.device).transpose(-1, -2)
    return torch.empty((n, *first.shape), dtype=first.dtype, device=first.device)


def _store(stack, i: int, layer) -> None:
    if isinstance(stack, QuantizedWeight):
        stack.values[i].copy_(layer.values)
        stack.scale[i].copy_(layer.scale)
    elif isinstance(stack, QuantizedWeight4):
        stack.packed[i].copy_(layer.packed)
        stack.scale[i].copy_(layer.scale)
    else:
        stack[i].copy_(layer)


def shard_params(params: Any, specs: Any,
                 mesh_or_rank: Union[DeviceMesh, Tuple[int, int]], axis: str = "tp") -> Any:
    """This rank's shard of a parameter tree (JAX's shard_tree): every leaf
    cut on the dims its PartitionSpec maps to `axis`, at the rank's index
    along it (a DeviceMesh, or an explicit (rank, axis size) pair). Quantized
    weights shard as `expand_param_specs` says; fused projections and a
    'halves'-packed INT4 weight cut on its rows raise. A LayerStack or Lazy
    leaf is made here, layer by layer in the mapping's order, and only its
    shard is kept. Replicated leaves are returned as they are."""
    rank, size = _axis_coords(mesh_or_rank, axis)
    if isinstance(params, dict):
        _check_keys(params, specs)
        return {k: shard_params(v, specs[k], (rank, size), axis) for k, v in params.items()}
    if isinstance(params, Lazy):
        return _cut_leaf(params.make(), specs, axis, rank, size)
    if isinstance(params, LayerStack):
        stack = None
        for i in range(params.num_layers):
            layer = _cut_leaf(params.make(i), P(*specs[1:]), axis, rank, size)
            if stack is None:
                stack = _empty_stack(params.num_layers, layer)
            _store(stack, i, layer)
            del layer
        return stack
    return _cut_leaf(params, specs, axis, rank, size)


def gather_params(shards: Any, specs: Any, mesh: DeviceMesh, axis: str = "tp") -> Any:
    """The whole tree from every rank's float shards (shard_params'
    inverse, for saving a sharded run): each leaf cut along `axis` is
    all-gathered over the axis's group and joined on the dims its spec maps
    to the axis; replicated leaves are returned as they are. Every rank of
    the axis's group makes the same call."""
    if isinstance(shards, dict):
        _check_keys(shards, specs)
        return {k: gather_params(v, specs[k], mesh, axis) for k, v in shards.items()}
    if isinstance(shards, (QuantizedWeight, QuantizedWeight4)):
        raise TypeError("gather_params joins float leaves only")
    dims = [d for d, name in enumerate(specs) if name == axis]
    if not dims:
        return shards
    if len(dims) > 1:
        raise ValueError(f"spec {specs!r} cuts more than one dim over {axis!r}")
    group = mesh.get_group(axis)
    x = shards.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dims[0])


def make_tp_mesh(tp: int, *, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D ("tp",) mesh over the first `tp` ranks of the default group."""
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < tp:
        raise ValueError(f"need {tp} devices, have {have}")
    return make_mesh((tp,), ("tp",), device_type=device_type)


class _TensorParallel:
    """What TPEngine and TPSpecDecodeEngine add to their engines: the TP
    group, the local configs the adapter runs, and the shards."""

    def _init_tp(self, mesh: DeviceMesh, axis: str, *cfgs: LlamaConfig) -> None:
        idx, tp = _axis_coords(mesh, axis)
        group = mesh.get_group(axis)
        if dist.get_world_size(group) != tp or dist.get_rank(group) != idx:
            raise ValueError(
                f"the {axis!r} group has {dist.get_world_size(group)} ranks (this one "
                f"{dist.get_rank(group)}) where the mesh gives {tp} (this one {idx})")
        for cfg in cfgs:
            local_config(cfg, tp)  # raises when tp does not divide the head counts
        self.mesh, self.axis, self.tp, self.tp_group = mesh, axis, tp, group

    def _local(self, cfg: LlamaConfig) -> LlamaConfig:
        return local_config(cfg, self.tp)

    def _shard(self, cfg: LlamaConfig, params: Dict[str, Any]) -> Dict[str, Any]:
        specs = tp_param_specs(self.axis, attention_bias=cfg.attention_bias,
                               sandwich_norms=cfg.sandwich_norms)
        return shard_params(params, specs, self.mesh, self.axis)


class TPEngine(_TensorParallel, Engine):
    """Continuous-batching engine with TP-sharded params and KV cache.

    Drop-in for Engine: the same host API (add_request / step / run /
    metrics) and every cache mode Engine serves (plain, mixed_kv, hybrid_kv,
    hybrid x mixed, prefix cache, bucketed, chunked and interleaved
    prefill, decode_chunk). Takes the full params (or ones made on demand,
    LayerStack / Lazy) and keeps only this rank's shard; allocates its
    cache for its own kv heads. Every rank of the mesh's `axis` group runs
    the same calls in the same order. Raises when the group does not match
    the mesh or when tp does not divide the head counts."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any], ecfg: EngineConfig,
                 mesh: DeviceMesh, *, axis: str = "tp", device="cuda"):
        self._init_tp(mesh, axis, cfg)
        super().__init__(cfg, self._shard(cfg, params), ecfg, device=device)


class TPSpecDecodeEngine(_TensorParallel, SpecDecodeEngine):
    """Speculative decoding with both models TP-sharded on one mesh: the
    draft loop, the target's verification, prefills and cache writes all
    run on each rank's shards (tp must divide both models' head counts);
    the logits are whole on every rank after the all-reduces, so the host's
    acceptance and the device's rejection sampling are unchanged."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any], draft_cfg: LlamaConfig,
                 draft_params: Dict[str, Any], ecfg: EngineConfig, mesh: DeviceMesh,
                 scfg: Optional[SpecConfig] = None, *, axis: str = "tp", device="cuda"):
        self._init_tp(mesh, axis, cfg, draft_cfg)
        super().__init__(cfg, self._shard(cfg, params), draft_cfg,
                         self._shard(draft_cfg, draft_params), ecfg, scfg, device=device)
