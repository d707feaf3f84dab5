"""Paged-KV decode attention: q_len = 1, GQA, INT8 KV cache (counterpart
of quantizedmha_tpu/ops/decode.py:paged_decode_attention).

k/v live in pages [num_kv_heads, num_pages, page_size, head_dim] int8 with
one symmetric max-abs scale per (kv_head, page); block tables
[batch, max_pages] map each sequence's logical pages to physical ones. On
a CUDA tensor the call launches `csrc/paged_decode.cu` (one kernel for any
num_kv_heads >= 1, standing for both `_decode_kernel_hfold` and
`_decode_kernel`); on a CPU tensor it runs `_paged_decode_plain`, the same
page walk step by step. The JAX package's TPU grid knobs (fold_kv_heads,
pages_per_step, seqs_per_step, scales_prerowed) have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    validate_masking,
)
from quantizedmha_tpu_torch.ops.quantize import true_div

PAGED_DECODE = cuda_lib.CudaKernel(
    "paged_decode", "paged_decode",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_HEAD_DIMS = (32, 64, 128)


def _paged_decode_plain(q, k_pages, v_pages, k_scales, v_scales, lengths,
                        block_tables, *, sm_scale, window, softcap, sinks,
                        save_residuals):
    """The kernel's page walk in PyTorch, vectorized over sequences and
    heads: per logical page i, f32 scores (q*sm_scale)·k * k_scale, masks,
    online softmax, acc = acc*alpha + (p·v) * v_scale. Pages holding no
    visible position leave a sequence's state untouched, as the kernel
    skips them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, D = q.shape
    Hkv, _, P, _ = k_pages.shape
    G = Hq // Hkv
    dev = q.device
    lengths = lengths.long()
    qg = q.float().reshape(B, Hkv, G, D) * sm_scale
    m = torch.full((B, Hkv, G, 1), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, 1), device=dev)
    acc = torch.zeros((B, Hkv, G, D), device=dev)
    heads = torch.arange(Hkv, device=dev)
    n_pages = min(int(((lengths.max() + P - 1) // P).item()), block_tables.shape[1])
    for i in range(n_pages):
        base = i * P
        run = base < lengths                                     # [B]
        if window is not None:
            in_win = base + P > lengths - window
            if sinks:
                in_win = in_win | (base < sinks)
            run = run & in_win
        page = block_tables[:, i].long()                         # [B]
        kp = k_pages[:, page].float().transpose(0, 1)            # [B, Hkv, P, D]
        vp = v_pages[:, page].float().transpose(0, 1)
        ks = k_scales[heads[None, :], page[:, None]][..., None, None]  # [B, Hkv, 1, 1]
        vs = v_scales[heads[None, :], page[:, None]][..., None, None]
        s = (qg @ kp.transpose(-1, -2)) * ks                     # [B, Hkv, G, P]
        if softcap is not None:
            s = softcap * torch.tanh(true_div(s, softcap))
        pos = base + torch.arange(P, device=dev)
        valid = pos[None, :] < lengths[:, None]                  # [B, P]
        if window is not None:
            vis = pos[None, :] >= (lengths - window)[:, None]
            if sinks:
                vis = vis | (pos[None, :] < sinks)
            valid = valid & vis
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        alpha = torch.exp(m - m_next)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + (p @ vp) * vs
        sel = run[:, None, None, None]
        m = torch.where(sel, m_next, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel, acc_new, acc)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    o = (acc * l_inv).reshape(B, Hq, D).to(q.dtype)
    if not save_residuals:
        return o
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")),
                      m + torch.log(torch.clamp(l, min=1e-38)))
    return o, lse.reshape(B, Hq)


def _paged_decode_launch(q, k_pages, v_pages, k_scales, v_scales, lengths,
                         block_tables, *, sm_scale, window, softcap, sinks,
                         save_residuals):
    """Checked operands of one kernel launch: (kernel, ctypes args, outputs)."""
    B, Hq, D = q.shape
    Hkv, num_pages, P, _ = k_pages.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA paged decode takes head_dim in {_HEAD_DIMS}, got {D}")
    if P % 16:
        raise ValueError(f"page_size must be a multiple of 16, got {P}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError("k/v pages must be int8")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    k_scales = k_scales.float().contiguous()
    v_scales = v_scales.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    block_tables = block_tables.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
           if save_residuals else None)
    ptr = cuda_lib.ptr
    args = (ptr(q), ptr(k_pages, 16), ptr(v_pages, 16), ptr(k_scales), ptr(v_scales),
            ptr(lengths), ptr(block_tables), ptr(o), ptr(lse),
            B, Hq, Hkv, num_pages, P, block_tables.shape[1], D,
            sm_scale, int(softcap is not None), float(softcap or 0.0),
            -1 if window is None else int(window), int(sinks),
            DEFAULT_MASK_VALUE, int(q.dtype == torch.bfloat16),
            cuda_lib.stream_of(q))
    # The operand tensors ride along so they outlive every launch of args.
    keep = (q, k_pages, v_pages, k_scales, v_scales, lengths, block_tables)
    return PAGED_DECODE, args, (o, lse), keep


def _paged_decode_cuda(*operands, save_residuals, **kw):
    kernel, args, (o, lse), _ = _paged_decode_launch(
        *operands, save_residuals=save_residuals, **kw)
    kernel(*args)
    return (o, lse) if save_residuals else o


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    save_residuals: bool = False,
    layer: Optional[int] = None,
):
    """Single-token attention against a paged INT8 KV cache.

    q:            [batch, num_q_heads, head_dim] (the new token's queries)
    k/v_pages:    [num_kv_heads, num_pages, page_size, head_dim] int8, or
                  layer-stacked [num_layers, ...] with `layer` selecting one
    k/v_scales:   [num_kv_heads, num_pages] f32 (or [num_layers, ...])
    lengths:      [batch] int — context length per sequence, the pending
                  token included
    block_tables: [batch, max_pages] int — physical page ids
    Returns [batch, num_q_heads, head_dim] in q's dtype; with
    save_residuals, (out, lse [batch, num_q_heads] f32), lse = m + log l
    over the scaled logits (-inf for an empty row).
    """
    if k_pages.ndim == 5:
        if layer is None:
            raise ValueError("layer-stacked pools (ndim 5) need the `layer` index")
        k_pages, v_pages = k_pages[layer], v_pages[layer]
        k_scales, v_scales = k_scales[layer], v_scales[layer]
    elif layer is not None:
        raise ValueError("`layer` is only meaningful for 5-D stacked pools")
    # Decode is causal by construction: sinks without a window must raise.
    validate_masking(True, window, attention_sinks)
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads = k_pages.shape[0]
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q heads {num_q_heads} not a multiple of kv heads {num_kv_heads}")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    fn = _paged_decode_cuda if q.is_cuda else _paged_decode_plain
    return fn(q, k_pages, v_pages, k_scales, v_scales, lengths, block_tables,
              sm_scale=scale, window=window, softcap=logit_softcap,
              sinks=attention_sinks, save_residuals=save_residuals)
