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
of one mesh axis (`mesh.get_group("cp")`), None for the default group.

Gradients (the convention of `parallel/combine.py`): the float entries
differentiate through the flash kernel's backward (`save_residuals=True`
with offsets: the lse cotangent is folded into the dK/dV and dQ kernels)
and through `merge_two_partials`. The rotation is an autograd function
whose backward sends each gradient block to the left neighbour, as
ppermute transposes; context parallelism's replicated q enters through
`copy_to_group`, so its gradient is all-reduced. The INT8 ring is JAX's
straight-through function: its backward is the float ring's at the
dequantized K/V (`_RingInt8`). Every rank issues its backward's
collectives and point-to-point calls in the same order, as autograd runs
the same graph on each.

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

from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
from quantizedmha_tpu_torch.ops.flash_attention_int8 import (
    flash_attention_int8_prequant,
    flash_attention_int8_t_prequant,
)
from quantizedmha_tpu_torch.ops.quantize import dequantize_kv_blocks, quantize_kv_blocks
from quantizedmha_tpu_torch.parallel.combine import (
    copy_to_group,
    merge_partial_attention,
    merge_two_partials,
)

# The rotation's shift: forward to the right (+1); its backward sends the
# gradient the other way.
_FORWARD_SHIFT = 1
_BACKWARD_SHIFT = -1


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
    the whole [b, h, q_len, d] output. Differentiable: q's gradient is
    all-reduced over the group (every rank holds it whole), k/v's is this
    rank's shard."""
    idx, n = _rank_and_size(group)
    q = copy_to_group(q, group)
    kv_shard_len = k_shard.shape[2]
    total = seq_len if seq_len is not None else kv_shard_len * n
    o, lse = flash_attention(
        q, k_shard, v_shard, sm_scale=sm_scale, causal=causal, save_residuals=True,
        q_offset=total - q.shape[2], kv_offset=idx * kv_shard_len,
        window=window, logit_softcap=logit_softcap, attention_sinks=attention_sinks)
    return merge_partial_attention(o, lse, group)


def _shard_block(k_shard: torch.Tensor, block_kv: int) -> int:
    """block_kv, or the shard length when it does not divide the shard."""
    return block_kv if k_shard.shape[2] % block_kv == 0 else k_shard.shape[2]


def quantize_shard(k_shard: torch.Tensor, v_shard: torch.Tensor, block_kv: int):
    """A rank's K/V shard quantized once for the INT8 ring: (k_i8, k_scales,
    v_i8, v_scales), one scale per (head, block_kv keys); block_kv falls
    back to the shard length when it does not divide it."""
    block_kv = _shard_block(k_shard, block_kv)
    return (*quantize_kv_blocks(k_shard, block_kv), *quantize_kv_blocks(v_shard, block_kv))


def _ste_residuals(k_shard: torch.Tensor, v_shard: torch.Tensor, block_kv: int):
    """The K/V at which the INT8 ring's straight-through backward runs the
    float ring's: the shard quantized as quantize_shard quantizes it, then
    dequantized, in the shard's dtype (JAX ring.py's f_fwd)."""
    block_kv = _shard_block(k_shard, block_kv)
    return tuple(dequantize_kv_blocks(*quantize_kv_blocks(x, block_kv), block_kv).to(x.dtype)
                 for x in (k_shard, v_shard))


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


def _exchange(block: Sequence[torch.Tensor], group, idx: int, n: int,
              shift: int) -> Callable:
    """Send each tensor of `block` to the rank `shift` places on and receive
    the rank `shift` places back's into fresh buffers; returns finish(),
    which waits and gives the received block (on block's device: staged
    through host buffers on a gloo group, where the transfer no longer
    overlaps the compute)."""
    world = group if group is not None else dist.group.WORLD
    to = dist.get_global_rank(world, (idx + shift) % n)
    frm = dist.get_global_rank(world, (idx - shift) % n)
    staged = _host_staged(group, block)
    sent = [t.detach().contiguous().cpu() if staged else t.detach().contiguous()
            for t in block]
    received = [torch.empty_like(t) for t in sent]
    ops = ([dist.P2POp(dist.isend, t, to, group, tag) for tag, t in enumerate(sent)]
           + [dist.P2POp(dist.irecv, r, frm, group, tag) for tag, r in enumerate(received)])
    requests = dist.batch_isend_irecv(ops)

    def finish():
        for r in requests:
            r.wait()
        return [r.to(t.device) for r, t in zip(received, block)] if staged else received
    return finish


class _Rotated(torch.autograd.Function):
    """The received block of a rotation as a function of the sent one: the
    forward hands over the buffers the rotation filled; the backward sends
    each gradient block back the other way (ppermute's transpose)."""

    @staticmethod
    def forward(ctx, comm, received, *sent):
        ctx.comm = comm
        return tuple(received)

    @staticmethod
    def backward(ctx, *grads):
        group, idx, n = ctx.comm
        back = _exchange(grads, group, idx, n, _BACKWARD_SHIFT)()
        return (None, None, *back)


def _rotate(block: Sequence[torch.Tensor], group, idx: int, n: int) -> Callable:
    """Send each tensor of `block` to the right neighbour and receive the
    left one's; returns finish(), which waits and gives the received block.
    When a block tensor requires grad (and grad is enabled) the received
    block is differentiable: its gradient goes back to the left."""
    finish = _exchange(block, group, idx, n, _FORWARD_SHIFT)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in block)):
        return finish
    return lambda: list(_Rotated.apply((group, idx, n), finish(), *block))


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
    merge. Returns this rank's [b, h, q_shard, d] rows in q's dtype.
    Differentiable in q, k and v: each rank's gradients are its shards of
    the global loss's (module docstring)."""
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
    calling convention as ring_attention.

    Differentiable by JAX's straight-through VJP (`_RingInt8`): the
    backward is ring_attention's at the dequantized K/V (d/dk of
    round(k/s)·s taken as the identity), which rotates float blocks."""
    kw = dict(group=group, causal=causal, sm_scale=sm_scale, window=window,
              logit_softcap=logit_softcap, attention_sinks=attention_sinks)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_shard, v_shard)):
        return _RingInt8.apply(q, k_shard, v_shard, block_kv, kw)
    return _ring_int8_forward(q, k_shard, v_shard, block_kv, kw)


def _ring_int8_forward(q, k_shard, v_shard, block_kv, kw):
    idx, n = _rank_and_size(kw["group"])
    partial = ring_step(q, idx=idx, n=n, kv_shard_len=k_shard.shape[2], int8=True,
                        **{k: v for k, v in kw.items() if k != "group"})
    return _run_ring(q, quantize_shard(k_shard, v_shard, block_kv), kw["group"], partial)


class _RingInt8(torch.autograd.Function):
    """ring_attention_int8 with JAX's straight-through VJP (JAX ring.py's
    custom_vjp): the forward is the INT8 ring (grad is off inside it, so
    the INT8 kernel's refusal does not fire) and saves q and the shards'
    dequantized K/V; the backward runs ring_attention's forward and
    backward at those values, the output gradient cast to q's dtype."""

    @staticmethod
    def forward(ctx, q, k_shard, v_shard, block_kv, kw):
        ctx.kw = kw
        ctx.save_for_backward(q, *_ste_residuals(k_shard, v_shard, block_kv))
        return _ring_int8_forward(q, k_shard, v_shard, block_kv, kw)

    @staticmethod
    def backward(ctx, g):
        q, k_deq, v_deq = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = ring_attention(q, k_deq, v_deq, **ctx.kw)
        dq, dk, dv = torch.autograd.grad(out, (q, k_deq, v_deq), g.to(q.dtype))
        return dq, dk, dv, None, None
