"""Unfused 3-stage MHA baseline (counterpart of quantizedmha_tpu/ops/unfused.py).

The twin of the reference study's `unfused` kernel: S = QKᵀ, a row
softmax and P·V as three separate products that materialize the whole
score matrix in device memory, the roofline anchor the fused kernels are
measured against. The JAX version is plain XLA, not a Pallas kernel, so
this is plain PyTorch, in f32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch


def unfused_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """q, k, v: [batch, heads, seq, head_dim]. Materializes S and P."""
    if causal and q.shape[2] > k.shape[2]:
        # A fully masked row would come out as uniform attention: refuse,
        # as the fused kernels' callers do.
        raise ValueError("causal attention requires q_len <= kv_len")
    torch.backends.cuda.matmul.allow_tf32 = False
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        q_len, kv_len = s.shape[-2], s.shape[-1]
        qi = torch.arange(q_len, device=s.device)[:, None] + (kv_len - q_len)
        ki = torch.arange(kv_len, device=s.device)[None, :]
        s = torch.where(ki <= qi, s, torch.finfo(torch.float32).min)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return (p @ v.float()).to(q.dtype)
