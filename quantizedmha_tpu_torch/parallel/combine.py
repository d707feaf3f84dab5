"""Exact merging of partial attention results (counterpart of
quantizedmha_tpu/parallel/combine.py).

Each partial holds an attention output already normalized by its own
softmax sum and the log-sum-exp of its scores; partials over disjoint key
sets merge exactly, as the online softmax merges key tiles. The mixed KV
cache and ring attention merge two partials in one process
(`merge_two_partials`); context parallelism merges one partial a rank
across a process group (`merge_partial_attention`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from quantizedmha_tpu_torch.ops._autograd import refuse_grad

# torch.distributed's collectives and point-to-point calls are not tracked
# by autograd: a gradient through them would be silently wrong, so the
# cross-rank entries refuse it (JAX differentiates them).
NO_GRAD_ACROSS_RANKS = (
    "gradients across ranks are not ported yet (torch.distributed's "
    "collectives are not tracked by autograd; ROADMAP.md queue 1 item 8, "
    "gradients across ranks)")


def merge_two_partials(o_a: torch.Tensor, lse_a: torch.Tensor, o_b: torch.Tensor,
                       lse_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """o_*: [..., q, d] normalized by their own l; lse_*: [..., q].

    Computes in f32 and returns (o in o_a's dtype, lse f32). A partial with
    lse = -inf drops out exactly; a row that is -inf in both gives o = 0
    and lse = -inf."""
    lse_a, lse_b = lse_a.float(), lse_b.float()
    m = torch.maximum(lse_a, lse_b)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    neg_inf = torch.full_like(m, float("-inf"))
    w_a = torch.exp(torch.where(torch.isfinite(lse_a), lse_a - m_safe, neg_inf))
    w_b = torch.exp(torch.where(torch.isfinite(lse_b), lse_b - m_safe, neg_inf))
    denom = w_a + w_b
    lse = torch.where(finite, m_safe + torch.log(denom), neg_inf)
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o_a.float() * (w_a / denom_safe)[..., None]
         + o_b.float() * (w_b / denom_safe)[..., None])
    return o.to(o_a.dtype), lse


def merge_partial_attention(o_local: torch.Tensor, lse_local: torch.Tensor,
                            group=None) -> torch.Tensor:
    """Merge one partial attention output a rank across `group` (JAX's
    axis_name; None is the default group). o_local: [..., q, d] normalized
    by its own l; lse_local: [..., q]. Every rank gets the merged output in
    o_local's dtype. Two collectives: an all-reduce MAX of the detached f32
    lse, then one all-reduce SUM of a single f32 buffer holding [w | o·w]
    (JAX's one tuple-psum). Refuses grad (NO_GRAD_ACROSS_RANKS)."""
    refuse_grad(NO_GRAD_ACROSS_RANKS, o_local, lse_local)
    lse = lse_local.float()
    m = lse.detach().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    w = torch.exp(torch.where(torch.isfinite(lse), lse - m_safe,
                              torch.full_like(lse, float("-inf"))))
    packed = torch.cat([w[..., None], o_local.float() * w[..., None]], dim=-1)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    l_global, o_global = packed[..., 0], packed[..., 1:]
    l_safe = torch.where(l_global == 0.0, torch.ones_like(l_global), l_global)
    return (o_global / l_safe[..., None]).to(o_local.dtype)
