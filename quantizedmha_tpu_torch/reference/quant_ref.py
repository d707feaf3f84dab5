"""Fake-quantized INT8 attention golden (counterpart of
quantizedmha_tpu/reference/quant_ref.py:mha_int8_reference).

The fused int8 kernel's algorithm materialized tile by tile: Q quantized
per row, K/V per [block_kv, head_dim] tile, S = Qq·Kqᵀ in exact integers,
online softmax in f32 with ln(p_static_scale) folded into the max, P
rounded to int8 (pv_dtype="int8") or cast to bf16 (pv_dtype="bf16", l
summing that same bf16 P when summode="mxu"), and the accumulator rescaled
per kv block. Integer products are taken in float64, where they are exact.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from quantizedmha_tpu_torch.ops.quantize import true_div


def quantize_int8_tile(
    x: torch.Tensor, *, axis=(-2, -1), scale_clamp: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric max-abs int8 quantization with keepdims scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = true_div(torch.clamp(amax, min=scale_clamp), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def mha_int8_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_q: int = 256,
    block_kv: int = 256,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    p_static_scale: float = 127.0,
    scale_clamp: float = 1e-8,
    pv_dtype: str = "int8",
    summode: str = "vpu",
) -> torch.Tensor:
    """Blocked fake-quant INT8 attention golden over [..., seq, head_dim]."""
    *lead, q_len, head_dim = q.shape
    kv_len = k.shape[-2]
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    block_q = min(block_q, q_len)
    block_kv = min(block_kv, kv_len)
    if q_len % block_q or kv_len % block_kv:
        raise ValueError("seq lengths must be multiples of the blocks")
    neg_big = -0.7 * float(torch.finfo(torch.float32).max)
    ln_p = math.log(p_static_scale)
    out = torch.zeros((*lead, q_len, head_dim), dtype=torch.float32,
                      device=q.device)
    for qi in range(q_len // block_q):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        q_q, s_q = quantize_int8_tile(q[..., qs, :], axis=(-1,),
                                      scale_clamp=scale_clamp)
        m = torch.full((*lead, block_q, 1), float("-inf"), device=q.device)
        l = torch.zeros((*lead, block_q, 1), device=q.device)
        acc = torch.zeros((*lead, block_q, head_dim), device=q.device)
        for ki in range(kv_len // block_kv):
            ks = slice(ki * block_kv, (ki + 1) * block_kv)
            k_q, s_k = quantize_int8_tile(k[..., ks, :], scale_clamp=scale_clamp)
            v_q, s_v = quantize_int8_tile(v[..., ks, :], scale_clamp=scale_clamp)
            s_int = (q_q.double() @ k_q.double().transpose(-1, -2)).float()
            s = s_int * (s_q * s_k * scale)
            if causal:
                qpos = (torch.arange(block_q, device=q.device)[:, None]
                        + qi * block_q + (kv_len - q_len))
                kpos = torch.arange(block_kv, device=q.device)[None, :] + ki * block_kv
                s = torch.where(kpos <= qpos, s, neg_big)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - (m_next - ln_p))
            if pv_dtype == "bf16":
                pb = p.to(torch.bfloat16).float()
                l_p = pb if summode == "mxu" else p
                l = alpha * l + l_p.sum(dim=-1, keepdim=True)
                o = pb @ v_q.float()
            else:
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                p_q = torch.clamp(torch.round(p), -127, 127)
                o = (p_q.double() @ v_q.double()).float()
            acc = alpha * acc + o * s_v
            m = m_next
        l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
        out[..., qs, :] = acc * l_inv
    return out.to(q.dtype)
