"""Exact merging of partial attention results, and the two autograd
functions that carry gradients across ranks (counterpart of
quantizedmha_tpu/parallel/combine.py).

Each partial holds an attention output already normalized by its own
softmax sum and the log-sum-exp of its scores; partials over disjoint key
sets merge exactly, as the online softmax merges key tiles. The mixed KV
cache and ring attention merge two partials in one process
(`merge_two_partials`); context parallelism merges one partial a rank
across a process group (`merge_partial_attention`).

Gradients across ranks. torch.distributed's collectives and point-to-point
calls are not tracked by autograd, so every collective on a differentiable
path is a `torch.autograd.Function` whose backward runs the transposed
collective. The convention, for every entry of `parallel/` and for
`models.llama.sgd_train_step` on a mesh: each rank back-propagates the
*global* loss, and its gradients are its shard of the gradient of that
loss taken through the JAX package's shard_map / GSPMD version. A value
that every rank holds whole (replicated) has the whole gradient on every
rank, and the ranks agree. Megatron's pair gives this:

  * `copy_to_group` ("copy into the group"): identity forward, all-reduce
    SUM of the gradient backward. A replicated input enters rank-local
    work through it (q of context parallelism, the input of a
    column-parallel product): each rank's gradient is its part of the sum.
  * `reduce_from_group` ("reduce from the group"): all-reduce SUM forward,
    identity backward. Rank-local partial sums leave through it (the
    merge's [w | o·w], a row-parallel product's output): every rank
    computes the same replicated function of the sum, so each holds the
    sum's whole gradient already.

The ring's rotation (`ring._rotate`, a send right and a receive from the
left) transposes to the inverse permutation: its backward sends each
gradient block to the left. An all-reduce MAX taken of detached values
(the merge's shift) is a constant, as JAX's stop_gradient makes it.
Both functions clone before reducing in place, so no tensor that autograd
saved is overwritten.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; the gradient all-reduced (SUM) over `group`
    backward. Outside autograd (no grad needed) it returns x and issues
    nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToGroup.apply(x, group)
    return x


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce SUM over `group` forward (into a fresh tensor: x is left
    as it was); the gradient passed through unchanged backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return _all_reduce_sum(x, group)


def merge_two_partials(o_a: torch.Tensor, lse_a: torch.Tensor, o_b: torch.Tensor,
                       lse_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """o_*: [..., q, d] normalized by their own l; lse_*: [..., q].

    Computes in f32 and returns (o in o_a's dtype, lse f32). A partial with
    lse = -inf drops out exactly; a row that is -inf in both gives o = 0
    and lse = -inf. Differentiable: the log of a row's sum is taken of 1
    where the row is -inf in both, so no such row sends NaN back."""
    lse_a, lse_b = lse_a.float(), lse_b.float()
    m = torch.maximum(lse_a, lse_b)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    neg_inf = torch.full_like(m, float("-inf"))
    w_a = torch.exp(torch.where(torch.isfinite(lse_a), lse_a - m_safe, neg_inf))
    w_b = torch.exp(torch.where(torch.isfinite(lse_b), lse_b - m_safe, neg_inf))
    denom = w_a + w_b
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    lse = torch.where(finite, m_safe + torch.log(denom_safe), neg_inf)
    o = (o_a.float() * (w_a / denom_safe)[..., None]
         + o_b.float() * (w_b / denom_safe)[..., None])
    return o.to(o_a.dtype), lse


def merge_partial_attention(o_local: torch.Tensor, lse_local: torch.Tensor,
                            group=None) -> torch.Tensor:
    """Merge one partial attention output a rank across `group` (JAX's
    axis_name; None is the default group). o_local: [..., q, d] normalized
    by its own l; lse_local: [..., q]. Every rank gets the merged output in
    o_local's dtype. Two collectives: an all-reduce MAX of the detached f32
    lse (a constant under autograd), then one all-reduce SUM of a single
    f32 buffer holding [w | o·w] (JAX's one tuple-psum) through
    `reduce_from_group`. Differentiable in o_local and lse_local."""
    lse = lse_local.float()
    m = lse.detach().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    w = torch.exp(torch.where(torch.isfinite(lse), lse - m_safe,
                              torch.full_like(lse, float("-inf"))))
    packed = torch.cat([w[..., None], o_local.float() * w[..., None]], dim=-1)
    packed = reduce_from_group(packed, group)
    l_global, o_global = packed[..., 0], packed[..., 1:]
    l_safe = torch.where(l_global == 0.0, torch.ones_like(l_global), l_global)
    return (o_global / l_safe[..., None]).to(o_local.dtype)
