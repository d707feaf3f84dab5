"""Pipeline parallelism (GPipe) over a "pp" process group (counterpart of
quantizedmha_tpu/parallel/pipeline.py).

The decoder layers are cut into contiguous stages, one a rank of the
group (`shard_layers`); the batch is cut into microbatches, and each stage
runs the real GPipe schedule: it receives microbatch m from the stage
before it, runs its layers, and sends m on as soon as it is done, so
stage s works on m while stage s + 1 works on m - 1. The last stage's
outputs are broadcast to every rank, so each returns the logits whole, as
the JAX package's psum replicates them. (The JAX package runs every stage
through the same SPMD tick, computing on stale buffers in the bubble and
masking the result: a TPU device with no counterpart here. Each
microbatch's arithmetic is the same.)

Gradients (the convention of `parallel/combine.py`: every rank
back-propagates the global loss). The hand-offs are autograd functions: a
send's backward receives the gradient from the next stage, a receive's
backward sends it back; the broadcast's backward gives the last stage its
outputs' gradient and every other stage the empty tokens its sends
returned, which start their backward. Autograd runs each stage's graph
from the latest microbatch back, so the gradients' sends and receives
pair up across stages (m = M - 1 first). The embedding's output enters
through `copy_to_group`, so every stage holds the embedding's whole
gradient (only stage 0's layers read it); the final norm and lm_head run
on every rank and have their whole gradients there.

On a gloo group, CUDA tensors are sent and received through host buffers
(gloo's send and recv take host pointers only: `parallel/ring.py`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quantizedmha_tpu_torch.parallel.combine import copy_to_group
from quantizedmha_tpu_torch.parallel.ring import _host_staged


def _group_of(group_or_mesh, axis: str):
    if isinstance(group_or_mesh, DeviceMesh):
        return group_or_mesh.get_group(axis)
    return group_or_mesh


def _stage(group) -> Tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, rank: int) -> int:
    return dist.get_global_rank(group if group is not None else dist.group.WORLD, rank)


def _send(x: torch.Tensor, group, to: int, tag: int):
    """Start sending x to stage `to`; returns the work and the buffer that
    must stay alive until it is done."""
    buf = x.detach().contiguous()
    if _host_staged(group, [buf]):
        buf = buf.cpu()
    return dist.isend(buf, _global(group, to), group=group, tag=tag), buf


def _recv(shape, dtype, device, group, frm: int, tag: int) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype, device=device)
    staged = _host_staged(group, [buf])
    host = torch.empty(shape, dtype=dtype) if staged else buf
    dist.recv(host, _global(group, frm), group=group, tag=tag)
    return host.to(device) if staged else buf


class _SendOn(torch.autograd.Function):
    """Send microbatch `tag`'s activation to the next stage; returns an
    empty token (the works to wait on go into `pending`). Backward:
    receive the activation's gradient from the next stage."""

    @staticmethod
    def forward(ctx, comm, pending, x):
        group, to, tag = comm
        ctx.comm, ctx.meta = comm, (x.shape, x.dtype, x.device)
        pending.append(_send(x, group, to, tag))
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _token):
        group, to, tag = ctx.comm
        return None, None, _recv(*ctx.meta, group, to, tag)


class _RecvFrom(torch.autograd.Function):
    """Receive microbatch `tag`'s activation from the previous stage (the
    anchor, an empty tensor that requires grad, puts it on the graph).
    Backward: send its gradient back to that stage."""

    @staticmethod
    def forward(ctx, comm, meta, anchor):
        group, frm, tag = comm
        ctx.comm = comm
        return _recv(*meta, group, frm, tag)

    @staticmethod
    def backward(ctx, g):
        group, frm, tag = ctx.comm
        work, _buf = _send(g, group, frm, tag)
        work.wait()
        return None, None, None


class _FromLastStage(torch.autograd.Function):
    """The last stage's outputs broadcast to every stage. Backward: the last
    stage's gradient for its outputs; on the other stages, empty gradients
    for the tokens of their sends (which start their backward) and zeros
    for the stage input x (whose copy_to_group must run on every stage)."""

    @staticmethod
    def forward(ctx, comm, out, x, *tokens):
        group, last = comm
        ctx.is_last = dist.get_rank(group) == last
        ctx.x_meta, ctx.n_tokens = (x.shape, x.dtype, x.device), len(tokens)
        buf = out.detach().clone() if ctx.is_last else torch.empty(
            x.shape, dtype=x.dtype, device=x.device)
        dist.broadcast(buf, _global(group, last), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        if ctx.is_last:
            return None, g, None
        shape, dtype, device = ctx.x_meta
        return (None, None, torch.zeros(shape, dtype=dtype, device=device),
                *(g.new_empty(0) for _ in range(ctx.n_tokens)))


def shard_layers(layers: Dict[str, Any], group_or_mesh, axis: str = "pp") -> Dict[str, Any]:
    """This stage's contiguous slice of each layer-stacked leaf (a tensor or
    a list of per-layer tensors, cut on its leading dim into as many parts
    as the group has stages)."""
    stage, n = _stage(_group_of(group_or_mesh, axis))
    out = {}
    for k, v in layers.items():
        L = len(v)
        if L % n:
            raise ValueError(f"{L} layers not divisible by {n} stages")
        per = L // n
        out[k] = v[stage * per:(stage + 1) * per]
    return out


def pipeline_apply(stage_fn: Callable, layers: Dict[str, Any], x_micro: torch.Tensor,
                   group_or_mesh, *, axis: str = "pp") -> torch.Tensor:
    """Run stage_fn(local layers, x) as a GPipe pipeline over microbatches.

    layers: this stage's layers (shard_layers); x_micro: [n_micro, mb, ...]
    microbatched activations, the same on every rank (stage 0 reads them).
    Returns [n_micro, mb, ...] on every rank (the last stage's outputs,
    broadcast); differentiable on every stage (module docstring)."""
    group = _group_of(group_or_mesh, axis)
    stage, n = _stage(group)
    last = n - 1
    x_micro = copy_to_group(x_micro, group)
    anchor = x_micro.new_empty(0).requires_grad_()
    outs, tokens, pending = [], [], []
    for m in range(x_micro.shape[0]):
        if stage == 0:
            x = x_micro[m]
        else:
            x = _RecvFrom.apply((group, stage - 1, m), (x_micro.shape[1:], x_micro.dtype,
                                                         x_micro.device), anchor)
        y = stage_fn(layers, x)
        if stage == last:
            outs.append(y)
        else:
            tokens.append(_SendOn.apply((group, stage + 1, m), pending, y))
    for work, _buf in pending:
        work.wait()
    out = torch.stack(outs) if stage == last else x_micro.new_empty(0)
    return _FromLastStage.apply((group, last), out, x_micro, *tokens)


def _stage_windows(cfg, n_stages: int) -> Tuple[Optional[int], ...]:
    """The stage-local window pattern, the same on every stage (JAX's check
    and words: a pattern that differs between stages raises)."""
    windows = cfg.layer_windows
    L_local = cfg.num_layers // n_stages
    local_windows = windows[:L_local]
    if windows != local_windows * n_stages:
        raise ValueError(
            f"window_pattern {windows} is not identical across {n_stages} "
            f"pipeline stages of {L_local} layers — PP needs a stage-"
            "uniform pattern (use TP/ring for this family, or pick a "
            "stage count whose per-stage slice repeats)")
    return local_windows


def pipeline_llama_forward(cfg, params: Dict[str, Any], tokens: torch.Tensor,
                           group_or_mesh, *, n_microbatches: int,
                           axis: str = "pp") -> torch.Tensor:
    """Llama forward with the decoder layers pipelined over `axis` (a
    DeviceMesh's axis, or a process group). tokens: [batch, seq], batch
    divisible by n_microbatches, the same on every rank. params["layers"]:
    the whole model's layer stacks (each stage takes its slice) or this
    stage's (shard_layers); the embedding, final norm and lm_head are
    whole on every rank. Returns the logits [batch, seq, vocab] f32 on
    every rank. Raises as the JAX package does on a batch the microbatches
    do not divide, layers the stages do not divide, and a window pattern
    that differs between stages."""
    # models.llama imports this package (its mesh): imported at call time.
    from quantizedmha_tpu_torch.models.llama import (
        decoder_layer,
        embed_tokens,
        final_logits,
        layer_params,
        rms_norm,
    )
    group = _group_of(group_or_mesh, axis)
    b, s = tokens.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
    n_stages = dist.get_world_size(group)
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {n_stages} stages")
    local_windows = _stage_windows(cfg, n_stages)
    layers = params["layers"]
    if len(next(iter(layers.values()))) == cfg.num_layers:
        layers = shard_layers(layers, group)

    def stage_fn(layers_local, xb):
        for i, window in enumerate(local_windows):
            xb = decoder_layer(cfg, layer_params(layers_local, i), xb, window=window)
        return xb

    x = embed_tokens(cfg, params, tokens)
    x_micro = x.reshape(n_microbatches, b // n_microbatches, s, -1)
    out = pipeline_apply(stage_fn, layers, x_micro, group)
    x = out.reshape(b, s, -1)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x, params["lm_head"])
