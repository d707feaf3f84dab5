"""Process groups across hosts, hybrid meshes and the collective audit
(counterpart of quantizedmha_tpu/parallel/distributed.py).

  * `initialize_multihost`: brings up the default process group once per
    process from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK) and pins the rank's GPU; a single process
    is a no-op.
  * `hybrid_mesh`: a DeviceMesh whose leading ("dcn") axes span nodes and
    whose trailing ("ici") axes span the GPUs inside a node. The JAX names
    are kept: "dcn" is the network between nodes (InfiniBand or Ethernet,
    tens of GB/s), "ici" the NVLink between a node's GPUs (hundreds of GB/s).
    So DP and PP go on the leading axes, TP and CP on the trailing ones.
  * The audit: PyTorch compiles no HLO to parse, so `record_collectives`
    records what a call actually issues (kind, dtype, bytes, the group's
    global ranks) by wrapping torch.distributed's collective and
    point-to-point functions for the duration of the call, and
    `classify_collectives` / `collective_bytes` class each record as "ici"
    or "dcn" by whether its ranks cross a granule of `granule_size` ranks
    (the GPUs of one node). Counts are of the calls that ran: a ring step
    inside a Python loop counts once per step (JAX's audit counts a scan
    body's collectives once).

Kinds are named as the JAX package's HLO names them: "all-reduce",
"all-gather", "reduce-scatter", "all-to-all", and "collective-permute" for
each tensor a ring step sends (its matching receive is not counted again);
"broadcast" has no HLO twin. The HLO-text parsers of the JAX module have no
counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, local_rank: Optional[int] = None,
                         backend: Optional[str] = None) -> int:
    """Bring up the default process group (idempotent); returns the world
    size. Arguments left None come from torchrun's environment: the
    rendezvous tcp://MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK and
    LOCAL_RANK (the GPU this rank pins). A single process (no WORLD_SIZE,
    or 1, and no init_method) is a no-op returning 1. backend: "nccl" when
    CUDA is available, else "gloo"."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and world_size not in (None, 1):
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise ValueError(f"WORLD_SIZE={world_size} but no MASTER_ADDR / MASTER_PORT to "
                             "meet at (run under torchrun, or pass init_method)")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if init_method is None and world_size in (None, 1):
        return 1  # one process, nothing to coordinate
    if rank is None:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
        kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return dist.get_world_size()


def hybrid_mesh(dcn_sizes: Sequence[int], ici_sizes: Sequence[int],
                dcn_names: Sequence[str], ici_names: Sequence[str], *,
                device_type: str = "cuda") -> DeviceMesh:
    """A mesh whose leading axes span nodes ("dcn") and trailing axes the
    GPUs inside a node ("ici"), over the first ranks of the default group.
    Ranks are node-major (torchrun numbers a node's ranks contiguously), so
    each trailing sub-mesh is one node's GPUs.

    Example: hybrid_mesh((2,), (4,), ("dp",), ("tp",)) on 2 nodes x 4 GPUs
    -> mesh ("dp", "tp") whose "tp" collectives never leave a node."""
    if len(dcn_sizes) != len(dcn_names) or len(ici_sizes) != len(ici_names):
        raise ValueError("axis sizes and names must pair up")
    if not dist.is_initialized():
        raise RuntimeError("hybrid_mesh needs an initialized default process group "
                           "(initialize_multihost)")
    shape = tuple(dcn_sizes) + tuple(ici_sizes)
    n, have = math.prod(shape), dist.get_world_size()
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(dcn_names) + tuple(ici_names))


# ---------------------------------------------------------------------------
# The collective audit.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective or point-to-point transfer as it ran: its kind (HLO's
    name), the dtype, the bytes of its result (a gather's gathered tensor, a
    permute's sent tensor), the global ranks it spans and the host's seconds
    inside the call."""
    kind: str
    dtype: str
    nbytes: int
    ranks: tuple
    seconds: float


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(group) -> tuple:
    return tuple(dist.get_process_group_ranks(group if group is not None else dist.group.WORLD))


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


# name: (kind, the record's (tensor, bytes) from the call's arguments)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", lambda a, kw: (a[0], _bytes(a[0]))),
    "broadcast": ("broadcast", lambda a, kw: (a[0], _bytes(a[0]))),
    "all_gather": ("all-gather", lambda a, kw: (a[1], _bytes(a[1]) * len(a[0]))),
    "all_gather_into_tensor": ("all-gather", lambda a, kw: (a[0], _bytes(a[0]))),
    "reduce_scatter_tensor": ("reduce-scatter", lambda a, kw: (a[0], _bytes(a[0]))),
    "all_to_all_single": ("all-to-all", lambda a, kw: (a[0], _bytes(a[0]))),
}


def _group_arg(args, kw, position: int):
    return kw.get("group", args[position] if len(args) > position else None)


# The `group` argument's position in each wrapped function's signature.
_GROUP_POS = {"all_reduce": 2, "broadcast": 2, "all_gather": 2, "all_gather_into_tensor": 2,
              "reduce_scatter_tensor": 3, "all_to_all_single": 4}


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Collective]]:
    """Within the block, every collective (all_reduce, broadcast, all_gather,
    all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single) and
    every tensor sent (send, and each isend of batch_isend_irecv) through
    torch.distributed is appended to the yielded list as it runs. The
    functions are wrapped on the torch.distributed module, so callers that
    look them up there at call time (as this package does) are seen; a
    reference taken before the block is not. Lone isend / irecv calls
    outside batch_isend_irecv are not recorded (this package issues none)."""
    records: List[Collective] = []
    originals = {}

    def timed(fn, make_record):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            records.append(make_record(args, kw, time.perf_counter() - t0))
            return out
        return wrapper

    for name, (kind, pick) in _COLLECTIVES.items():
        fn = originals[name] = getattr(dist, name)

        def make(args, kw, seconds, kind=kind, pick=pick, name=name):
            t, nbytes = pick(args, kw)
            return Collective(kind, _dtype(t), nbytes,
                              _group_ranks(_group_arg(args, kw, _GROUP_POS[name])), seconds)
        setattr(dist, name, timed(fn, make))

    def send_record(args, kw, seconds):
        t, peer = args[0], kw.get("dst", args[1] if len(args) > 1 else None)
        return Collective("collective-permute", _dtype(t), _bytes(t),
                          (dist.get_rank(), peer), seconds)
    originals["send"] = dist.send
    dist.send = timed(originals["send"], send_record)

    batch = originals["batch_isend_irecv"] = dist.batch_isend_irecv

    def batch_wrapper(p2p_op_list):
        t0 = time.perf_counter()
        out = batch(p2p_op_list)
        seconds = time.perf_counter() - t0
        for op in p2p_op_list:
            if getattr(op.op, "__name__", "") == "isend":
                records.append(Collective("collective-permute", _dtype(op.tensor),
                                          _bytes(op.tensor), (dist.get_rank(), op.peer),
                                          seconds))
        return out
    dist.batch_isend_irecv = batch_wrapper
    try:
        yield records
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def _crosses(ranks: Sequence[int], granule_size: int) -> bool:
    return len({r // granule_size for r in ranks}) > 1


def classify_collectives(records: Sequence[Collective],
                         granule_size: int) -> Dict[str, Dict[str, int]]:
    """Split recorded collectives into ICI and DCN traffic classes.

    granule_size: ranks per ICI domain (the GPUs of a node in a hybrid
    mesh). A collective whose ranks (or a permute's pair) all share rank //
    granule_size stays on the node's NVLink ("ici"); one that crosses
    granules pays the network between nodes ("dcn"). Returns {"ici": {kind:
    n}, "dcn": {kind: n}}."""
    out: Dict[str, Dict[str, int]] = {"ici": {}, "dcn": {}}
    for r in records:
        bucket = out["dcn" if _crosses(r.ranks, granule_size) else "ici"]
        bucket[r.kind] = bucket.get(r.kind, 0) + 1
    return out


def collective_bytes(records: Sequence[Collective], granule_size: int) -> Dict[str, int]:
    """The recorded collectives' result bytes, split ICI vs DCN as
    classify_collectives splits them: the first-order wire traffic of an
    all-reduce, all-gather or permute on a ring, which the 1 -> N node
    scaling model takes."""
    out = {"ici": 0, "dcn": 0}
    for r in records:
        out["dcn" if _crosses(r.ranks, granule_size) else "ici"] += r.nbytes
    return out


def audit_fn_by_axis(fn, *args, granule_size: int, **kwargs) -> Dict[str, Dict[str, int]]:
    """Run fn(*args, **kwargs) and classify the collectives it issued as ICI
    vs DCN (classify_collectives)."""
    with record_collectives() as records:
        fn(*args, **kwargs)
    return classify_collectives(records, granule_size)


def audit_bytes_by_axis(fn, *args, granule_size: int, **kwargs) -> Dict[str, int]:
    """collective_bytes of what fn(*args, **kwargs) issued (audit_fn_by_axis's
    byte twin)."""
    with record_collectives() as records:
        fn(*args, **kwargs)
    return collective_bytes(records, granule_size)


def _numel_by_dtype(tree, out=None) -> Dict[torch.dtype, int]:
    """Elements of each dtype over a tree's tensors, in first-seen order."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for v in tree.values():
            _numel_by_dtype(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _numel_by_dtype(v, out)
    else:
        out[tree.dtype] = out.get(tree.dtype, 0) + tree.numel()
    return out


def train_step_collectives(cfg, params, tokens_shape) -> List[dict]:
    """The collectives one rank issues in models.llama.sgd_train_step(...,
    mesh=) on a ("dp", "tp") mesh, in order, derived from the code: each
    {"phase", "axis", "kind", "dtype", "nbytes"}. params: the rank's shards;
    tokens_shape: its (batch, seq). With N = batch x seq rows, h the hidden
    size, L layers, e the size of cfg.dtype:

      forward, "tp": per layer the all-reduces of wo's and w_down's outputs
        (reduce_from_group), N h e bytes each; then the vocab-parallel loss,
        an all-reduce MAX of batch x (seq - 1) f32 row maxima and one SUM
        of their [sum of exp | target logit] pairs;
      backward, "tp": the gradients of the column-parallel inputs
        (copy_to_group): the lm_head's, then per layer (last to first) the
        MLP's and the attention's, N h e bytes each;
      dp, "dp": one all-reduce a gradient dtype of every gradient of that
        dtype flattened, the loss in the float32 buffer (one of its own when
        no gradient is float32).

    Per step: 4L + 3 all-reduces on "tp", one or two on "dp"."""
    batch, seq = tokens_shape
    e = torch.empty((), dtype=cfg.dtype).element_size()
    act = _dtype(torch.empty((), dtype=cfg.dtype))
    row = batch * seq * cfg.hidden_size * e
    rows = batch * (seq - 1)
    out = []

    def add(phase, axis, dtype, nbytes):
        out.append({"phase": phase, "axis": axis, "kind": "all-reduce", "dtype": dtype,
                    "nbytes": nbytes})
    for _ in range(2 * cfg.num_layers):
        add("forward", "tp", act, row)
    add("forward", "tp", "float32", 4 * rows)
    add("forward", "tp", "float32", 8 * rows)
    for _ in range(2 * cfg.num_layers + 1):
        add("backward", "tp", act, row)
    numel = _numel_by_dtype(params)
    numel.setdefault(torch.float32, 0)
    for dtype, n in numel.items():
        extra = 1 if dtype == torch.float32 else 0
        add("dp", "dp", _dtype(torch.empty((), dtype=dtype)),
            (n + extra) * torch.empty((), dtype=dtype).element_size())
    return out


def model_scaling_efficiency(step_time_s: float, dcn_bytes_per_step: float,
                             *, dcn_gbps: float = 25.0,
                             latency_s: float = 10e-6) -> float:
    """Modeled 1 -> N node THROUGHPUT scaling efficiency for a step whose
    per-node work is constant (DP over the DCN axis: each node keeps its own
    batch shard / engine replica): the N-node step pays the audited per-step
    DCN traffic at `dcn_gbps` (+ one launch latency when any DCN collective
    exists) on top of the single-node step time.

        efficiency = N * tput_1 / (N * tput_N') = t_1 / (t_1 + t_dcn)

    With zero audited DCN bytes (serving decode: TP all-reduces on the
    node's NVLink, no cross-node collective per token) the model returns
    exactly 1.0. dcn_gbps default is a conservative per-node figure for the
    network between nodes ('tens of GB/s')."""
    if dcn_bytes_per_step <= 0:
        return 1.0
    t_dcn = dcn_bytes_per_step / (dcn_gbps * 1e9) + latency_s
    return step_time_s / (step_time_s + t_dcn)
