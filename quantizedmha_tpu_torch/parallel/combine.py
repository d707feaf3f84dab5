"""Exact merging of partial attention results (counterpart of
quantizedmha_tpu/parallel/combine.py:merge_two_partials).

Each partial holds an attention output already normalized by its own
softmax sum and the log-sum-exp of its scores; two partials over disjoint
key sets merge exactly, as the online softmax merges key tiles. The mixed
KV cache merges its INT8 and INT4 partials this way. The cross-device
collective (`merge_partial_attention`) belongs to the multi-GPU slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
