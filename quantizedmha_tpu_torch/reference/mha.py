"""Golden multi-head attention in plain PyTorch (counterpart of
quantizedmha_tpu/reference/mha.py).

RoPE keeps the reference's INTERLEAVED pairing: elements (2i, 2i+1) are
rotated by pos * theta^(-2i/d) — not the rotate-half form common in
PyTorch code. The goldens compute in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantizedmha_tpu_torch.ops.quantize import true_div


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=device) * 2.0
        / head_dim)


def apply_rope(x: torch.Tensor, theta: float = 10000.0,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary position embedding over the last two dims [seq, head_dim].

    x: [..., seq, head_dim]; head_dim even. positions: optional [seq] ints
    (defaults to arange(seq)) or, for per-sequence positions, a tensor
    broadcastable to x's leading dims plus [seq].
    """
    *lead, seq, hd = x.shape
    if hd % 2:
        raise ValueError("head_dim must be even for RoPE")
    x32 = x.float()
    xe = x32[..., 0::2]
    xo = x32[..., 1::2]
    freqs = rope_freqs(hd, theta, x.device)
    if positions is None:
        positions = torch.arange(seq, device=x.device)
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    re = xe * cos - xo * sin
    ro = xe * sin + xo * cos
    out = torch.stack([re, ro], dim=-1).reshape(*lead, seq, hd)
    return out.to(x.dtype)


def mha_reference_shaped(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    use_rope: bool = False,
    rope_theta: float = 10000.0,
) -> torch.Tensor:
    """Full-materialization golden MHA over [..., seq, head_dim]."""
    if use_rope:
        q = apply_rope(q, rope_theta)
        k = apply_rope(k, rope_theta)
    head_dim = q.shape[-1]
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        q_len, kv_len = s.shape[-2], s.shape[-1]
        qi = torch.arange(q_len, device=s.device)[:, None] + (kv_len - q_len)
        ki = torch.arange(kv_len, device=s.device)[None, :]
        s = torch.where(ki <= qi, s, torch.finfo(torch.float32).min)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...qk,...kd->...qd", p, v.float())
    return o.to(q.dtype)


def mha_masked_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Golden for masked-variant attention over [batch, heads, seq, d]:
    end-aligned causal, sliding window ((q_pos - kv_pos) < window) with
    attention sinks, and logit soft-cap (cap * tanh(s / cap) on the scaled
    logits, before masking). GQA k/v are expanded here."""
    n_rep = q.shape[1] // k.shape[1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(true_div(s, softcap))
    q_len, kv_len = s.shape[-2], s.shape[-1]
    qi = torch.arange(q_len, device=s.device)[:, None] + (kv_len - q_len)
    ki = torch.arange(kv_len, device=s.device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=s.device)
    if causal:
        mask &= ki <= qi
        if window is not None:
            in_win = (qi - ki) < window
            if sinks:
                in_win |= ki < sinks
            mask &= in_win
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
