"""Context parallelism: sequence-sharded attention across ranks (counterpart
of quantizedmha_tpu/parallel/ring.py).

1. `context_parallel_attention`: q replicated, K/V sharded on the
   sequence; each rank runs the flash kernel against its own K/V shard
   (saving lse), then the partials merge across the group
   (`merge_partial_attention`: two all-reduces).
2. `ring_attention` / `ring_attention_int8`: q and K/V sharded; the K/V
   blocks rotate around the ring, each rank sending its block to its right
   neighbour and receiving its left one's (`dist.batch_isend_irecv`, issued
   before each step's compute so the transfer overlaps it) for n - 1 steps;
   each step's partial merges into an f32 accumulator. The INT8 ring
   quantizes each shard once and rotates the int8 payloads with their
   scales.

Each step calls a single-GPU kernel with global position offsets: the
float flash forward (`csrc/flash_fwd.cu`) or, for the INT8 ring, the
prequant INT8 kernel (`csrc/flash_int8_fwd.cu`: bf16 P at head_dim <= 64,
int8 P with `block_kv` above). A step's compute (`ring_step`) is kept apart
from the rotation, so that one process can feed a rank's steps the blocks
in ring order and reproduce a rank's result without a process group.

`group` plays the part of the JAX package's `axis_name`: the process group
of one mesh axis (`mesh.get_group("cp")`), None for the default group. The
entries refuse grad (torch.distributed's calls are not tracked by
autograd; ROADMAP.md queue 1 item 8).

Transport: gloo's send and recv take host pointers only (on a CUDA tensor
the sending rank aborts in writev, "Bad address": `harness/gloo_probe.py`),
while its all_reduce, broadcast and all_gather take CUDA tensors. So on a
gloo group `_rotate` stages CUDA blocks through host buffers: a copy to the
host, the send / recv, a copy back. The attention still runs on the card;
an NCCL group never takes that path.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from quantizedmha_tpu_torch.ops._autograd import refuse_grad
from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
from quantizedmha_tpu_torch.ops.flash_attention_int8 import (
    flash_attention_int8_prequant,
    flash_attention_int8_t_prequant,
)
from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
from quantizedmha_tpu_torch.parallel.combine import (
    NO_GRAD_ACROSS_RANKS,
    merge_partial_attention,
    merge_two_partials,
)


def _rank_and_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def source_rank(idx: int, step: int, n: int) -> int:
    """The rank whose K/V block rank `idx` holds after `step` rotations to
    the right."""
    return (idx - step) % n


def context_parallel_attention(
    q: torch.Tensor,
    k_shard: torch.Tensor,
    v_shard: torch.Tensor,
    *,
    group=None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    seq_len: Optional[int] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
) -> torch.Tensor:
    """All-partial + all-reduce context parallelism. q: [b, h, q_len, d],
    the same on every rank; k_shard/v_shard: [b, h_kv, kv_shard, d], this
    rank's shard of the sequence. q is end-aligned: its rows sit at global
    positions [total - q_len, total), total = seq_len or kv_shard x ranks
    (q a suffix of the sequence, as a prefill chunk). Every rank returns
    the whole [b, h, q_len, d] output."""
    refuse_grad(NO_GRAD_ACROSS_RANKS, q, k_shard, v_shard)
    idx, n = _rank_and_size(group)
    kv_shard_len = k_shard.shape[2]
    total = seq_len if seq_len is not None else kv_shard_len * n
    o, lse = flash_attention(
        q, k_shard, v_shard, sm_scale=sm_scale, causal=causal, save_residuals=True,
        q_offset=total - q.shape[2], kv_offset=idx * kv_shard_len,
        window=window, logit_softcap=logit_softcap, attention_sinks=attention_sinks)
    return merge_partial_attention(o, lse, group)


def quantize_shard(k_shard: torch.Tensor, v_shard: torch.Tensor, block_kv: int):
    """A rank's K/V shard quantized once for the INT8 ring: (k_i8, k_scales,
    v_i8, v_scales), one scale per (head, block_kv keys); block_kv falls
    back to the shard length when it does not divide it."""
    if k_shard.shape[2] % block_kv:
        block_kv = k_shard.shape[2]
    return (*quantize_kv_blocks(k_shard, block_kv), *quantize_kv_blocks(v_shard, block_kv))


def ring_step(q: torch.Tensor, *, idx: int, n: int, kv_shard_len: int, int8: bool,
              causal: bool, sm_scale: Optional[float], window: Optional[int],
              logit_softcap: Optional[float], attention_sinks: int) -> Callable:
    """The compute of rank `idx`'s ring steps: partial(step, *block) ->
    (o, lse), one kernel launch of the rank's q rows against the K/V block
    that came from source_rank(idx, step, n), at global offsets. `block` is
    (k, v), or for int8 the four tensors of quantize_shard (whose scales
    imply the quant block). The ring merges each partial into an f32
    accumulator with merge_two_partials."""
    q_offset = idx * q.shape[2]
    kw = dict(sm_scale=sm_scale, causal=causal, save_residuals=True, window=window,
              logit_softcap=logit_softcap, attention_sinks=attention_sinks)
    if not int8:
        kernel = flash_attention
    elif q.shape[-1] <= 64:
        kernel = flash_attention_int8_t_prequant
    else:
        def kernel(q, k_i8, k_sc, v_i8, v_sc, **kw):
            return flash_attention_int8_prequant(
                q, k_i8, k_sc, v_i8, v_sc, block_kv=k_i8.shape[2] // k_sc.shape[-1], **kw)

    def partial(step, *block):
        kv_offset = source_rank(idx, step, n) * kv_shard_len
        return kernel(q, *block, q_offset=q_offset, kv_offset=kv_offset, **kw)
    return partial


def _host_staged(group, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether a send / recv of `tensors` over `group` goes through host
    buffers: CUDA tensors on a gloo group (module docstring)."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group if group is not None else dist.group.WORLD) == "gloo")


def _rotate(block: Sequence[torch.Tensor], group, idx: int, n: int) -> Callable:
    """Send each tensor of `block` to the right neighbour and receive the
    left one's into fresh buffers; returns finish(), which waits and gives
    the received block (on block's device: staged through host buffers on a
    gloo group, where the transfer no longer overlaps the compute)."""
    world = group if group is not None else dist.group.WORLD
    right = dist.get_global_rank(world, (idx + 1) % n)
    left = dist.get_global_rank(world, (idx - 1) % n)
    staged = _host_staged(group, block)
    sent = [t.contiguous().cpu() for t in block] if staged else list(block)
    received = [torch.empty_like(t) for t in sent]
    ops = ([dist.P2POp(dist.isend, t, right, group, tag) for tag, t in enumerate(sent)]
           + [dist.P2POp(dist.irecv, r, left, group, tag) for tag, r in enumerate(received)])
    requests = dist.batch_isend_irecv(ops)

    def finish():
        for r in requests:
            r.wait()
        return [r.to(t.device) for r, t in zip(received, block)] if staged else received
    return finish


def gather_shards(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x stacked in rank order: [group size, *x.shape], one
    all_gather."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _run_ring(q: torch.Tensor, block, group, partial) -> torch.Tensor:
    """n - 1 steps, each issuing the next block's rotation before its
    compute, then the last step peeled off (no n-th rotation); the partials
    merge into an f32 accumulator."""
    idx, n = _rank_and_size(group)
    block = [t.contiguous() for t in block]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32, device=q.device)
    for step in range(n - 1):
        finish = _rotate(block, group, idx, n)
        o, lse = merge_two_partials(o, lse, *partial(step, *block))
        block = finish()
    o, _ = merge_two_partials(o, lse, *partial(n - 1, *block))
    return o.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k_shard: torch.Tensor,
    v_shard: torch.Tensor,
    *,
    group=None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
) -> torch.Tensor:
    """Ring attention over a sequence-sharded group. q: [b, h, q_shard, d],
    this rank's rows (global offset rank x q_shard); k/v: [b, h_kv,
    kv_shard, d], this rank's shard. window, logit_softcap and
    attention_sinks act on global positions; a step whose block lies
    wholly outside every row's view gives lse = -inf and drops out of the
    merge. Returns this rank's [b, h, q_shard, d] rows in q's dtype."""
    refuse_grad(NO_GRAD_ACROSS_RANKS, q, k_shard, v_shard)
    idx, n = _rank_and_size(group)
    partial = ring_step(q, idx=idx, n=n, kv_shard_len=k_shard.shape[2], int8=False,
                        causal=causal, sm_scale=sm_scale, window=window,
                        logit_softcap=logit_softcap, attention_sinks=attention_sinks)
    return _run_ring(q, (k_shard, v_shard), group, partial)


def ring_attention_int8(
    q: torch.Tensor,
    k_shard: torch.Tensor,
    v_shard: torch.Tensor,
    *,
    group=None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_kv: int = 512,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
) -> torch.Tensor:
    """INT8 ring attention: each rank quantizes its K/V shard once
    (quantize_shard, one scale per (head, block_kv keys)), then the int8
    payloads and their scales rotate (about a quarter of f32 K/V's bytes)
    and every step runs the prequant INT8 kernel at global offsets. Same
    calling convention as ring_attention. The JAX package differentiates it
    by a straight-through VJP; here it refuses grad (ROADMAP.md queue 1
    item 8)."""
    refuse_grad(NO_GRAD_ACROSS_RANKS, q, k_shard, v_shard)
    idx, n = _rank_and_size(group)
    partial = ring_step(q, idx=idx, n=n, kv_shard_len=k_shard.shape[2], int8=True,
                        causal=causal, sm_scale=sm_scale, window=window,
                        logit_softcap=logit_softcap, attention_sinks=attention_sinks)
    return _run_ring(q, quantize_shard(k_shard, v_shard, block_kv), group, partial)
