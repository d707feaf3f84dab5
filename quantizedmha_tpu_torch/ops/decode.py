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
plain version, the same algorithm step by step: each sequence's page walk
cut into the splits of `decode_splits`, each split walked from zero state,
the splits merged by lse in order. The JAX package's TPU grid knobs
(fold_kv_heads, pages_per_step, seqs_per_step, scales_prerowed) have no
counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
PAGED_DECODE_INT4 = cuda_lib.CudaKernel(
    "paged_decode", "paged_decode_int4",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_HEAD_DIMS = (32, 64, 128, 256)
# The paged decode kernels have no backward, in the JAX package as here:
# jax.grad through its paged_decode_attention(_int4) raises.
_NO_GRAD = ("paged decode attention is not differentiable (jax.grad through the "
            "JAX package's paged_decode_attention fails too)")
# decode_splits aims at four blocks for each of the H100's 132 SMs, and
# gives a split at least 64 keys, over which its fixed cost (q, its
# partial, its share of the merge) is spread.
_TARGET_BLOCKS = 4 * 132
_MIN_SPLIT_KEYS = 64


@functools.lru_cache(maxsize=None)
def decode_splits(batch: int, num_kv_heads: int, max_pages: int,
                  page_size: int) -> Tuple[int, int]:
    """(S, pages_per_split) of the flash-decoding split: split s walks the
    logical pages [s * pages_per_split, (s + 1) * pages_per_split) of each
    sequence's block table (max_pages slots wide). A pure function of the
    shapes: no device query and no look at the lengths, so the kernel's
    launch and the plain version cut the same splits. Every split holds at
    least one page; S = 1 for a one-page table."""
    want = -(-_TARGET_BLOCKS // max(batch * num_kv_heads, 1))
    per = max(-(-max_pages // want), -(-_MIN_SPLIT_KEYS // page_size))
    per = max(min(per, max_pages), 1)
    return max(-(-max_pages // per), 1), per


def _merge_splits(states, q_dtype, shape, save_residuals):
    """The kernels' merge of one row's splits (paged decode and paged
    prefill), in split order: M the largest m; a split that ran weighs w =
    exp(m - M) (a split with m = -inf held no visible page: it is skipped,
    its sums never read); o = sum w acc / sum w l (an l of 0 gives o = 0)
    and lse = M + log(sum w l) (-inf when 0). states: (m, l, acc) a split,
    m and l [..., 1], acc [..., D]; o takes `shape`, lse shape[:-1]."""
    inf = float("-inf")
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        ran = m != inf
        w = torch.exp(m - mx)
        l_sum = torch.where(ran, l_sum + w * l, l_sum)
        acc = torch.where(ran, acc + w * a, acc)
    l_inv = torch.where(l_sum == 0.0, torch.ones_like(l_sum), 1.0 / l_sum)
    o = (acc * l_inv).reshape(shape).to(q_dtype)
    if not save_residuals:
        return o
    lse = torch.where(l_sum == 0.0, torch.full_like(l_sum, inf),
                      mx + torch.log(torch.clamp(l_sum, min=1e-38)))
    return o, lse.reshape(shape[:-1])


def _decode_walk(q, num_kv_heads, lengths, block_tables, page_size, load_page, *, sm_scale,
                 window, softcap, sinks, save_residuals, splits=None):
    """The kernel's algorithm in PyTorch, vectorized over sequences and
    heads. Each split of `splits` (default decode_splits of the shapes)
    walks its logical pages from zero state: per page f32 scores
    (q*sm_scale)·k * k_scale, softcap, masks, online softmax, acc =
    acc*alpha + P·V with the V scales; pages holding no visible position
    leave a sequence's state untouched, as the kernel skips them. Then the
    splits are merged (_merge_splits). load_page(page ids [B]) -> (k [B,
    Hkv, P, D] f32, k scales broadcasting to [B, Hkv, 1, P], pv(p) -> [B,
    Hkv, G, D])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, D = q.shape
    Hkv, P = num_kv_heads, page_size
    dev = q.device
    lengths = lengths.long()
    max_pages = block_tables.shape[1]
    n_splits, per = splits or decode_splits(B, Hkv, max_pages, P)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D) * sm_scale
    n_pages = min(int(((lengths.max() + P - 1) // P).item()), max_pages)
    states = []
    for s in range(n_splits):
        m = torch.full((B, Hkv, Hq // Hkv, 1), float("-inf"), device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qg)
        for i in range(s * per, min((s + 1) * per, n_pages)):
            base = i * P
            run = base < lengths                                     # [B]
            if window is not None:
                in_win = base + P > lengths - window
                if sinks:
                    in_win = in_win | (base < sinks)
                run = run & in_win
            k, ks, pv = load_page(block_tables[:, i].long())
            sc = (qg @ k.transpose(-1, -2)) * ks                     # [B, Hkv, G, P]
            if softcap is not None:
                sc = softcap * torch.tanh(true_div(sc, softcap))
            pos = base + torch.arange(P, device=dev)
            valid = pos[None, :] < lengths[:, None]                  # [B, P]
            if window is not None:
                vis = pos[None, :] >= (lengths - window)[:, None]
                if sinks:
                    vis = vis | (pos[None, :] < sinks)
                valid = valid & vis
            sc = torch.where(valid[:, None, None, :], sc,
                             torch.full_like(sc, DEFAULT_MASK_VALUE))
            m_next = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_next)
            alpha = torch.exp(m - m_next)
            l_new = alpha * l + p.sum(dim=-1, keepdim=True)
            acc_new = acc * alpha + pv(p)
            sel = run[:, None, None, None]
            m = torch.where(sel, m_next, m)
            l = torch.where(sel, l_new, l)
            acc = torch.where(sel, acc_new, acc)
        states.append((m, l, acc))
    return _merge_splits(states, q.dtype, (B, Hq, D), save_residuals)


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
    outputs, operands and scratch). int4: nibble-packed pages [Hkv, num_pages, P, D/2]
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
    # The splits' f32 scratch, one allocation: unnormalised sums [S, B, Hq,
    # D], then m and l [2, S, B, Hq].
    n_splits, per = decode_splits(B, Hkv, block_tables.shape[1], P)
    ptr = cuda_lib.ptr
    scratch = part = ml = None
    if n_splits > 1:
        scratch = torch.empty(n_splits * B * Hq * (D + 2), dtype=torch.float32, device=q.device)
        part = ptr(scratch)
        ml = part + n_splits * B * Hq * D * 4
    dims = (B, Hq, Hkv, num_pages, P, block_tables.shape[1], D)
    if int4:
        dims += (k_scales.shape[-1],)
    args = (ptr(q), ptr(k_pages, 16), ptr(v_pages, 16), ptr(k_scales), ptr(v_scales),
            ptr(lengths), ptr(block_tables), ptr(o), ptr(lse), part, ml, *dims,
            n_splits, per, sm_scale, int(softcap is not None), float(softcap or 0.0),
            -1 if window is None else int(window), int(sinks),
            DEFAULT_MASK_VALUE, int(q.dtype == torch.bfloat16),
            cuda_lib.stream_of(q))
    # The operand and scratch tensors ride along so they outlive every
    # launch of args.
    keep = (q, k_pages, v_pages, k_scales, v_scales, lengths, block_tables, scratch)
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
