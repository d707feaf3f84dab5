"""Paged multi-token (q_len > 1) causal attention over the INT8 paged KV
cache (counterpart of quantizedmha_tpu/ops/paged_prefill.py).

A prefill chunk's or a prefix-cache suffix's queries attend straight from
the pages, with per-sequence global offsets (`q_starts`) and visible
context (`lengths`); nothing gathers the block table into a dense K/V. On a
CUDA tensor the call launches `csrc/paged_prefill.cu` (TPU kernel
`_prefill_kernel`); on a CPU tensor it runs `_paged_prefill_plain`, the
same page walk step by step, in f32 throughout: s = (q · sm_scale) ·
k_int8 · k_scale, pv = (p · v_int8) · v_scale, as the JAX kernel computes
them on the CPU. `paged_prefill_attention_int4` is the same over
nibble-packed INT4 pages with per-sub-tile scales (TPU kernel
`_prefill_kernel_int4`, the same CUDA source): the INT4 partial of a chunk
over the mixed KV cache, whose q_starts may be negative.

The kernel's route follows q's dtype. bf16 q (every serving path) runs on
the tensor cores (wgmma): s = (q_bf16 · k) in f32 accumulation times
sm_scale · k_scale[key], exact products since int8, int4 and bf16 q are all
bf16 values; P enters P·V rounded to bf16 once with each key's V scale
folded in, bf16(p · v_scale[key]), as the TPU's Precision.DEFAULT dots
round it. That rounding moves an output element by at most 2^-8 ·
sum_j p_j |v_j| / l from the plain version; l sums the f32 p, so lse only
sees the summation order. The bound of the heaviest serving chunk (2048
rows at 4096 of context, Llama-3-8B heads) is its bf16 operations, 0.174
ms on an H100. f32 q runs true f32 FMAs on the CUDA cores, the plain
version up to the summation order, at every head dim (at 256, Gemma-2
served in f32, V's f32 tile takes K's place once a tile's scores are done,
so that the raw page stages still fit in shared memory).

A bf16 launch whose grid would leave the card short of blocks (speculative
verify: a few sequences of k + 1 rows) cuts each sequence's key walk into
the splits of `prefill_splits`, contiguous ranges of whole pages and key
tiles, each walked from zero state by blocks of their own; the kernel's
merge, in the same C entry, then combines a row's splits by lse in split
order, as the paged decode does. The plain version cuts the same splits
and merges them by the same rule (ops/decode._merge_splits).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops._autograd import refuse_grad
from quantizedmha_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, validate_masking
from quantizedmha_tpu_torch.ops.decode import _int4_page, _merge_splits, int4_scales
from quantizedmha_tpu_torch.ops.quantize import true_div

PAGED_PREFILL = cuda_lib.CudaKernel(
    "paged_prefill", "paged_prefill",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
PAGED_PREFILL_INT4 = cuda_lib.CudaKernel(
    "paged_prefill", "paged_prefill_int4",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_HEAD_DIMS = (32, 64, 128, 256)  # 256: Gemma-2, bf16 and f32 q
_MAX_GROUP = 64  # the kernel holds a whole GQA group in its 64 q rows
# The paged prefill kernels have no backward, in the JAX package as here:
# jax.grad through its paged_prefill_attention(_int4) raises.
_NO_GRAD = ("paged prefill attention is not differentiable (jax.grad through the "
            "JAX package's paged_prefill_attention fails too)")
# prefill_splits leaves a grid of FILL_BLOCKS or more as it is (a block
# resident on each of the H100's 132 SMs), and cuts a smaller one's key
# walks to aim at SPLIT_TARGET_BLOCKS blocks, seven waves of one block an
# SM (the sweep at verify's shapes that chose it: harness/paged_prefill_ab.py
# --split-targets, PERF.md); a split is a whole number of the kernel's
# 64-key tiles (BK in csrc/paged_prefill.cu).
FILL_BLOCKS = 132
SPLIT_TARGET_BLOCKS = 7 * 132
_TILE_KEYS = 64
# Launches of each entry that took the split key walk (S > 1), beside the
# entries' own launch counts; a serving run resets and reads it.
split_launches = {"paged_prefill": 0, "paged_prefill_int4": 0}


def bf16_block_rows(head_dim: int) -> int:
    """q rows of one bf16 block: Bf16Block<D>::BROWS in
    csrc/paged_prefill.cu (one consumer warpgroup of 64 rows at d=256, two
    otherwise)."""
    return 64 if head_dim == 256 else 128


@functools.lru_cache(maxsize=None)
def prefill_splits(batch: int, num_kv_heads: int, q_len: int, group: int, head_dim: int,
                   max_pages: int, page_size: int, q_dtype: torch.dtype,
                   target_blocks: int = SPLIT_TARGET_BLOCKS) -> Tuple[int, int]:
    """(S, pages_per_split) of the bf16 kernel's split key walk: split s
    walks the logical pages [s * pages_per_split, (s + 1) *
    pages_per_split) of each sequence's block table (max_pages slots wide).
    A pure function of the shapes: no device query and no look at the
    lengths, so a launch needs no host sync and the plain version cuts the
    same splits. S = 1 for f32 q and wherever the unsplit grid, batch x kv
    heads x ceil(q_len / (block rows / group)) blocks, already fills the
    card (FILL_BLOCKS); otherwise the table is cut into about target_blocks
    / that many ranges, each a whole number of pages and of 64-key tiles."""
    if q_dtype != torch.bfloat16:
        return 1, max_pages
    rows = max(bf16_block_rows(head_dim) // group, 1)
    blocks = batch * num_kv_heads * -(-q_len // rows)
    if blocks >= FILL_BLOCKS:
        return 1, max_pages
    unit = math.lcm(page_size, _TILE_KEYS) // page_size  # pages of a tile-aligned range
    want = -(-target_blocks // max(blocks, 1))
    per = -(-max(-(-max_pages // want), 1) // unit) * unit
    if per >= max_pages:
        return 1, max_pages
    return -(-max_pages // per), per


def _prefill_walk(q, num_kv_heads, lengths, q_starts, block_tables, page_size, load_page,
                  *, sm_scale, window, softcap, sinks, save_residuals, splits=None):
    """The kernel's page walk in PyTorch, vectorized over sequences and kv
    heads with each GQA group's q heads flattened into one row operand.
    Each split of `splits` (default prefill_splits of the shapes) walks its
    logical pages from zero state: per page f32 scores, softcap, masks
    (kpos <= qpos, kpos < length, the window and sinks), the online softmax
    with dead rows zeroed, acc = acc·alpha + P·V with the V scales. A page
    no row of a sequence can see leaves that sequence's state untouched, as
    the kernels skip it. Then the splits are merged (decode._merge_splits;
    one split gives acc / l). load_page(page ids [B]) -> (k [B, Hkv, P, D]
    f32, k scales broadcasting to [B, Hkv, 1, P], pv(p) -> [B, Hkv, G*C,
    D])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, C, D = q.shape
    Hkv, P = num_kv_heads, page_size
    G = Hq // Hkv
    dev = q.device
    max_pages = block_tables.shape[1]
    n_splits, per = splits or prefill_splits(B, Hkv, C, G, D, max_pages, P, q.dtype)
    lengths, q_starts = lengths.long(), q_starts.long()
    qg = q.float().reshape(B, Hkv, G * C, D) * sm_scale
    qpos = (q_starts[:, None] + torch.arange(C, device=dev)).repeat(1, G)  # [B, G*C]
    last_q = q_starts + C - 1
    n_pages = min(int(((lengths.max() + P - 1) // P).item()), max_pages)
    states = []
    for split in range(n_splits):
        states.append(_walk_pages(qg, range(split * per, min((split + 1) * per, n_pages)),
                                  lengths, q_starts, last_q, qpos, block_tables, P, load_page,
                                  window=window, softcap=softcap, sinks=sinks))
    return _merge_splits(states, q.dtype, (B, Hq, C, D), save_residuals)


def _walk_pages(qg, pages, lengths, q_starts, last_q, qpos, block_tables, P, load_page, *,
                window, softcap, sinks):
    """One split of _prefill_walk from zero state over its logical pages:
    (m, l, acc) [B, Hkv, G*C, 1 | 1 | D]."""
    B, Hkv, rows, D = qg.shape
    dev = qg.device
    m = torch.full((B, Hkv, rows, 1), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, rows, 1), device=dev)
    acc = torch.zeros((B, Hkv, rows, D), device=dev)
    for i in pages:
        base = i * P
        run = (base <= last_q) & (base < lengths)                     # [B]
        if window is not None:
            in_win = base + P - 1 > q_starts - window
            if sinks:
                in_win = in_win | (base < sinks)
            run = run & in_win
        k, ks, pv = load_page(block_tables[:, i].long())
        s = (qg @ k.transpose(-1, -2)) * ks                           # [B, Hkv, G*C, P]
        if softcap is not None:
            s = softcap * torch.tanh(true_div(s, softcap))
        kpos = base + torch.arange(P, device=dev)
        valid = ((kpos[None, None, :] <= qpos[:, :, None])
                 & (kpos[None, None, :] < lengths[:, None, None]))    # [B, G*C, P]
        if window is not None:
            in_win = kpos[None, None, :] > qpos[:, :, None] - window
            if sinks:
                in_win = in_win | (kpos < sinks)[None, None, :]
            valid = valid & in_win
        s = torch.where(valid[:, None], s, torch.full_like(s, DEFAULT_MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        p = torch.where(m_next > DEFAULT_MASK_VALUE * 0.5, p, torch.zeros_like(p))
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + pv(p)
        sel = run[:, None, None, None]
        m = torch.where(sel, m_next, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel, acc_new, acc)
    return m, l, acc


def _paged_prefill_plain(q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts,
                         block_tables, **kw):
    """The INT8 kernel's walk: one K and V scale per (head, page); the V
    scale multiplies each page's P·V."""
    heads = torch.arange(k_pages.shape[0], device=q.device)

    def load(page):
        kp = k_pages[:, page].float().transpose(0, 1)                 # [B, Hkv, P, D]
        vp = v_pages[:, page].float().transpose(0, 1)
        ks = k_scales[heads[None, :], page[:, None]][..., None, None]  # [B, Hkv, 1, 1]
        vs = v_scales[heads[None, :], page[:, None]][..., None, None]
        return kp, ks, lambda p: (p @ vp) * vs
    return _prefill_walk(q, k_pages.shape[0], lengths, q_starts, block_tables,
                         k_pages.shape[2], load, **kw)


def _paged_prefill_int4_plain(q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts,
                              block_tables, **kw):
    """The INT4 kernel's walk: scores and P·V over the unpacked halves,
    per-key sub-tile scales, the V scale folded into P (scales [Hkv,
    num_pages, subs])."""
    heads = torch.arange(k_pages.shape[0], device=q.device)

    def load(page):
        kp, ks = _int4_page(k_pages, k_scales, heads, page)
        vp, vs = _int4_page(v_pages, v_scales, heads, page)
        return kp, ks, lambda p: (p * vs) @ vp
    return _prefill_walk(q, k_pages.shape[0], lengths, q_starts, block_tables,
                         k_pages.shape[2], load, **kw)


def _paged_prefill_launch(q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts,
                          block_tables, *, sm_scale, window, softcap, sinks,
                          save_residuals, int4=False, splits=None):
    """Checked operands of one kernel launch: (kernel, ctypes args,
    outputs, operands and scratch). int4: nibble-packed pages [Hkv,
    num_pages, P, D/2] with scales [Hkv, num_pages, subs]. splits: (S,
    pages_per_split), default prefill_splits of the shapes."""
    B, Hq, C, D = q.shape
    Hkv, num_pages, P, _ = k_pages.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA paged prefill takes head_dim in {_HEAD_DIMS}, got {D}")
    if Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"the CUDA paged prefill takes GQA groups up to {_MAX_GROUP}, "
                         f"got {Hq // Hkv}")
    if int4 and P % 16:
        raise ValueError(f"the CUDA INT4 paged prefill takes page sizes that are "
                         f"multiples of 16, got {P}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError("k/v pages must be int8")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    k_scales = k_scales.float().contiguous()
    v_scales = v_scales.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    q_starts = q_starts.to(torch.int32).contiguous()
    block_tables = block_tables.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((B, Hq, C), dtype=torch.float32, device=q.device)
           if save_residuals else None)
    max_pages = block_tables.shape[1]
    n_splits, per = splits or prefill_splits(B, Hkv, C, Hq // Hkv, D, max_pages, P, q.dtype)
    # The splits' f32 scratch, one allocation: unnormalised sums [S, B, Hq,
    # C, D], then m and l [2, S, B, Hq, C].
    ptr = cuda_lib.ptr
    scratch = part = ml = None
    if n_splits > 1:
        rows = n_splits * B * Hq * C
        scratch = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
        part = ptr(scratch, 16)
        ml = part + rows * D * 4
    dims = (B, Hq, Hkv, C, num_pages, P, max_pages, D)
    if int4:
        dims += (k_scales.shape[-1],)
    args = (ptr(q, 16), ptr(k_pages, 16), ptr(v_pages, 16), ptr(k_scales), ptr(v_scales),
            ptr(lengths), ptr(q_starts), ptr(block_tables), ptr(o, 16), ptr(lse), part, ml,
            *dims, n_splits, per, sm_scale, int(softcap is not None), float(softcap or 0.0),
            -1 if window is None else int(window), int(sinks),
            DEFAULT_MASK_VALUE, DEFAULT_MASK_VALUE * 0.5, int(q.dtype == torch.bfloat16),
            cuda_lib.stream_of(q))
    # The operand and scratch tensors ride along so they outlive every
    # launch of args.
    keep = (q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts, block_tables, scratch)
    return PAGED_PREFILL_INT4 if int4 else PAGED_PREFILL, args, (o, lse), keep


def _paged_prefill_cuda(*operands, save_residuals, **kw):
    kernel, args, (o, lse), keep = _paged_prefill_launch(
        *operands, save_residuals=save_residuals, **kw)
    kernel(*args)
    if keep[-1] is not None:  # the splits' scratch: S > 1
        split_launches[kernel.symbol] += 1
    return (o, lse) if save_residuals else o


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    q_starts: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_q: int = 256,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    save_residuals: bool = False,
):
    """Multi-token causal attention straight from the paged INT8 cache.

    q:            [batch, num_q_heads, q_len, head_dim] f32/bf16 — a prefill
                  chunk's queries (post-RoPE)
    k/v_pages:    [num_kv_heads, num_pages, page_size, head_dim] int8
    k/v_scales:   [num_kv_heads, num_pages] f32
    lengths:      [batch] int — TOTAL visible context (prefix + this chunk)
    q_starts:     [batch] int — global position of each sequence's q row 0
    block_tables: [batch, max_pages] int
    Returns [batch, num_q_heads, q_len, head_dim] in q's dtype; with
    save_residuals, also lse [batch, num_q_heads, q_len] f32 (m + log l
    over the scaled logits, -inf for a row with no visible position).
    block_q is accepted for signature parity; it has no numerical effect.
    Not differentiable: raises NotImplementedError when q requires grad.
    """
    refuse_grad(_NO_GRAD, q)
    del block_q
    validate_masking(True, window, attention_sinks)
    num_q_heads, head_dim = q.shape[1], q.shape[3]
    num_kv_heads = k_pages.shape[0]
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q heads {num_q_heads} not a multiple of kv heads {num_kv_heads}")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    fn = _paged_prefill_cuda if q.is_cuda else _paged_prefill_plain
    return fn(q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts, block_tables,
              sm_scale=scale, window=window, softcap=logit_softcap,
              sinks=attention_sinks, save_residuals=save_residuals)


def paged_prefill_attention_int4(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    q_starts: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_q: int = 256,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    save_residuals: bool = False,
):
    """paged_prefill_attention over a nibble-packed INT4 cache.

    k/v_pages: [num_kv_heads, num_pages, page_size, head_dim // 2] int8 in
    ops.quantize.quantize_kv_blocks_int4's deinterleaved layout; k/v_scales:
    [num_kv_heads, num_pages] or [num_kv_heads, num_pages, subs]. q_starts
    may be negative: rows at negative positions see nothing and give o = 0,
    lse = -inf. Everything else matches paged_prefill_attention."""
    refuse_grad(_NO_GRAD, q)
    del block_q
    validate_masking(True, window, attention_sinks)
    num_q_heads, head_dim = q.shape[1], q.shape[3]
    num_kv_heads = k_pages.shape[0]
    k_scales, v_scales = int4_scales(head_dim, k_pages, k_scales, v_scales)
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q heads {num_q_heads} not a multiple of kv heads {num_kv_heads}")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    kw = dict(sm_scale=scale, window=window, softcap=logit_softcap, sinks=attention_sinks,
              save_residuals=save_residuals)
    operands = (q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts, block_tables)
    if q.is_cuda:
        return _paged_prefill_cuda(*operands, int4=True, **kw)
    return _paged_prefill_int4_plain(*operands, **kw)
