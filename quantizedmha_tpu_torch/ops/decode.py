"""Paged-KV decode attention: q_len = 1, GQA, over the INT8 KV cache or the
nibble-packed INT4 one (counterpart of quantizedmha_tpu/ops/decode.py:
paged_decode_attention and paged_decode_attention_int4).

k/v live in pages [num_kv_heads, num_pages, page_size, head_dim] int8 with
one symmetric max-abs scale per (kv_head, page), or [..., head_dim // 2]
nibble-packed (byte j: element j low, element j + head_dim/2 high) with
one scale per (kv_head, page, sub-tile); block tables [batch, max_pages]
map each sequence's logical pages to physical ones. On a CUDA tensor the
call launches `csrc/paged_decode.cu` (one kernel template for both page
formats; the INT8 one stands for both `_decode_kernel_hfold` and
`_decode_kernel`, any num_kv_heads >= 1); on a CPU tensor it runs the
plain version, the same page walk step by step. The JAX package's TPU
grid knobs (fold_kv_heads, pages_per_step, seqs_per_step, scales_prerowed)
have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops._autograd import refuse_grad
from quantizedmha_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    validate_masking,
)
from quantizedmha_tpu_torch.ops.quantize import true_div, unpack_int4_halves

PAGED_DECODE = cuda_lib.CudaKernel(
    "paged_decode", "paged_decode",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
PAGED_DECODE_INT4 = cuda_lib.CudaKernel(
    "paged_decode", "paged_decode_int4",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_HEAD_DIMS = (32, 64, 128)
# The paged decode kernels have no backward, in the JAX package as here:
# jax.grad through its paged_decode_attention(_int4) raises.
_NO_GRAD = ("paged decode attention is not differentiable (jax.grad through the "
            "JAX package's paged_decode_attention fails too)")


def _decode_walk(q, num_kv_heads, lengths, block_tables, page_size, load_page, *, sm_scale,
                 window, softcap, sinks, save_residuals):
    """The kernel's page walk in PyTorch, vectorized over sequences and
    heads: per logical page i, f32 scores (q*sm_scale)·k * k_scale, masks,
    online softmax, acc = acc*alpha + P·V with the V scales. Pages holding
    no visible position leave a sequence's state untouched, as the kernel
    skips them. load_page(page ids [B]) -> (k [B, Hkv, P, D] f32, k scales
    broadcasting to [B, Hkv, 1, P], pv(p) -> [B, Hkv, G, D])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, D = q.shape
    Hkv, P = num_kv_heads, page_size
    dev = q.device
    lengths = lengths.long()
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D) * sm_scale
    m = torch.full((B, Hkv, Hq // Hkv, 1), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    n_pages = min(int(((lengths.max() + P - 1) // P).item()), block_tables.shape[1])
    for i in range(n_pages):
        base = i * P
        run = base < lengths                                     # [B]
        if window is not None:
            in_win = base + P > lengths - window
            if sinks:
                in_win = in_win | (base < sinks)
            run = run & in_win
        k, ks, pv = load_page(block_tables[:, i].long())
        s = (qg @ k.transpose(-1, -2)) * ks                      # [B, Hkv, G, P]
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
        acc_new = acc * alpha + pv(p)
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


def _paged_decode_plain(q, k_pages, v_pages, k_scales, v_scales, lengths,
                        block_tables, **kw):
    """The INT8 kernel's walk: one K and V scale per (head, page); the V
    scale multiplies each page's P·V."""
    heads = torch.arange(k_pages.shape[0], device=q.device)

    def load(page):
        kp = k_pages[:, page].float().transpose(0, 1)            # [B, Hkv, P, D]
        vp = v_pages[:, page].float().transpose(0, 1)
        ks = k_scales[heads[None, :], page[:, None]][..., None, None]  # [B, Hkv, 1, 1]
        vs = v_scales[heads[None, :], page[:, None]][..., None, None]
        return kp, ks, lambda p: (p @ vp) * vs
    return _decode_walk(q, k_pages.shape[0], lengths, block_tables, k_pages.shape[2], load,
                        **kw)


def int4_scales(head_dim, k_pages, k_scales, v_scales):
    """JAX's checks of nibble-packed pages [Hkv, num_pages, page_size,
    head_dim // 2] and their scales; returns the scales as [Hkv, num_pages,
    subs] (2-D scales are one sub-tile a page)."""
    page_size, half = k_pages.shape[2:]
    if k_scales.ndim == 2:
        k_scales = k_scales[..., None]
    if v_scales.ndim == 2:
        v_scales = v_scales[..., None]
    subs = k_scales.shape[-1]
    if page_size % subs:
        raise ValueError(f"page_size {page_size} not a multiple of scale sub-tiles {subs}")
    if v_scales.shape[-1] != subs:
        raise ValueError("k_scales and v_scales must agree on sub-tiles")
    if half * 2 != head_dim:
        raise ValueError(f"packed pages last dim {half} != head_dim // 2 ({head_dim // 2})")
    return k_scales, v_scales


def _int4_page(pages, scales, heads, page):
    """One logical page of every sequence from nibble-packed pages:
    (values [B, Hkv, P, D] f32, per-key scales [B, Hkv, 1, P]); the
    sub-tile scale of key t is scales[h, page, t // (P / subs)]."""
    P, subs = pages.shape[2], scales.shape[-1]
    vals = torch.cat(unpack_int4_halves(pages[:, page]), dim=-1).float().transpose(0, 1)
    cols = scales[heads[None, :], page[:, None]]                  # [B, Hkv, subs]
    return vals, cols.repeat_interleave(P // subs, dim=-1)[:, :, None, :]


def _paged_decode_int4_plain(q, k_pages, v_pages, k_scales, v_scales, lengths,
                             block_tables, **kw):
    """The INT4 kernel's walk: scores and P·V over the unpacked halves,
    the per-key sub-tile K scale on the scores, the V scale folded into P
    (scales [Hkv, num_pages, subs])."""
    heads = torch.arange(k_pages.shape[0], device=q.device)

    def load(page):
        kp, ks = _int4_page(k_pages, k_scales, heads, page)
        vp, vs = _int4_page(v_pages, v_scales, heads, page)
        return kp, ks, lambda p: (p * vs) @ vp
    return _decode_walk(q, k_pages.shape[0], lengths, block_tables, k_pages.shape[2], load,
                        **kw)


def _paged_decode_launch(q, k_pages, v_pages, k_scales, v_scales, lengths,
                         block_tables, *, sm_scale, window, softcap, sinks,
                         save_residuals, int4=False):
    """Checked operands of one kernel launch: (kernel, ctypes args,
    outputs, operands). int4: nibble-packed pages [Hkv, num_pages, P, D/2]
    with scales [Hkv, num_pages, subs]."""
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
    dims = (B, Hq, Hkv, num_pages, P, block_tables.shape[1], D)
    if int4:
        dims += (k_scales.shape[-1],)
    args = (ptr(q), ptr(k_pages, 16), ptr(v_pages, 16), ptr(k_scales), ptr(v_scales),
            ptr(lengths), ptr(block_tables), ptr(o), ptr(lse), *dims,
            sm_scale, int(softcap is not None), float(softcap or 0.0),
            -1 if window is None else int(window), int(sinks),
            DEFAULT_MASK_VALUE, int(q.dtype == torch.bfloat16),
            cuda_lib.stream_of(q))
    # The operand tensors ride along so they outlive every launch of args.
    keep = (q, k_pages, v_pages, k_scales, v_scales, lengths, block_tables)
    return PAGED_DECODE_INT4 if int4 else PAGED_DECODE, args, (o, lse), keep


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
    over the scaled logits (-inf for an empty row). Not differentiable:
    raises NotImplementedError when q requires grad.
    """
    refuse_grad(_NO_GRAD, q)
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


def paged_decode_attention_int4(
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
):
    """Single-token attention against a nibble-packed INT4 paged KV cache:
    half the bytes of the INT8 cache on the bandwidth-bound decode path.

    k/v_pages: [num_kv_heads, num_pages, page_size, head_dim // 2] int8 in
    ops.quantize.quantize_kv_blocks_int4's deinterleaved layout; k/v_scales:
    [num_kv_heads, num_pages] (one scale a page) or [num_kv_heads,
    num_pages, subs] (sub-page scale tiles: key t of a page takes sub-tile
    t // (page_size / subs)). Everything else, save_residuals included,
    matches paged_decode_attention; a row with length 0 gives o = 0 and
    lse = -inf."""
    refuse_grad(_NO_GRAD, q)
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads = k_pages.shape[0]
    k_scales, v_scales = int4_scales(head_dim, k_pages, k_scales, v_scales)
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q heads {num_q_heads} not a multiple of kv heads {num_kv_heads}")
    validate_masking(True, window, attention_sinks)
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    kw = dict(sm_scale=scale, window=window, softcap=logit_softcap, sinks=attention_sinks,
              save_residuals=save_residuals)
    operands = (q, k_pages, v_pages, k_scales, v_scales, lengths, block_tables)
    if q.is_cuda:
        return _paged_decode_cuda(*operands, int4=True, **kw)
    return _paged_decode_int4_plain(*operands, **kw)
