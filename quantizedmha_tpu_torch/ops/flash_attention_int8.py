"""Fused INT8 attention forward (counterpart of
quantizedmha_tpu/ops/flash_attention_int8.py).

Per (q row, kv quant block): S = Qq·Kqᵀ in integers with Q quantized per
row and K/V per (head, block); dequantize, optional softcap and masks;
online softmax in f32 with ln(p_static_scale) folded into the running max
so P' lies in (0, p_static_scale]; then one of three numerics modes:

  * mode 0, "int8" P with summode "vpu" (the standard orientation's
    default, `_int8_fwd_kernel` in the JAX package, and
    `_int8_fwd_kernel_t` with pv_dtype "int8"): P = round(P'), int8·int8
    P·V in int32, l sums the f32 P'.
  * mode 1, "bf16" P with summode "mxu" (the transposed orientation's
    default, `_int8_fwd_kernel_t`): P' cast to bf16, bf16·int8 P·V in f32,
    l sums the same bf16 P' (the ones row of its product).
  * mode 2, "bf16" P with summode "vpu" (`_int8_fwd_kernel` with pv_dtype
    "bf16", and `_int8_fwd_kernel_t` with summode "vpu"): P·V as mode 1's,
    l sums the f32 P' as mode 0's.

On a CUDA tensor every entry point launches the hand-written kernel in
`csrc/flash_int8_fwd.cu`; on a CPU tensor it runs `_flash_int8_plain`, the
same algorithm step by step in PyTorch. The JAX package's choice between
its two kernel orientations (flash_attention_int8's `transposed` route)
survives here as the choice of numerics mode; the layout is the same.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops._autograd import refuse_grad
from quantizedmha_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    _offsets,
    block_should_run,
    pick_blocks,
    validate_masking,
)
from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks, true_div

_MODES = {("int8", "vpu"): 0, ("bf16", "mxu"): 1, ("bf16", "vpu"): 2}

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
         + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_float]
         + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
         + [ctypes.c_void_p])
# One launch counter per numerics mode (the module docstring's modes 0,
# 1 and 2): int8 P, bf16 P with l over the bf16 P', bf16 P with l over
# the f32 P'.
FLASH_INT8_P = cuda_lib.CudaKernel("flash_int8_fwd", "flash_int8_fwd", _ARGS)
FLASH_BF16_P = cuda_lib.CudaKernel("flash_int8_fwd", "flash_int8_fwd", _ARGS)
FLASH_BF16_P_F32L = cuda_lib.CudaKernel("flash_int8_fwd", "flash_int8_fwd", _ARGS)
_KERNEL_OF_MODE = {0: FLASH_INT8_P, 1: FLASH_BF16_P, 2: FLASH_BF16_P_F32L}
_HEAD_DIMS = (32, 64, 128, 256)


def _flash_int8_plain_state(q, k_i8, k_scales, v_i8, v_scales, offsets, *, sm_scale,
                            causal, kv_len, block_kv, scale_clamp, p_scale, window,
                            softcap, sinks, mode):
    """The kernel's algorithm, step by step, over whole tensors: per-row Q
    quantization, then the online softmax at exactly block_kv granularity.
    Integer products are taken in float64 (exact); the bf16-P products
    (modes 1 and 2) in float32 with TF32 off (bf16·int8 products are exact
    in f32). l sums, per quant block, the f32 P' (modes 0 and 2) or its
    bf16 rounding (mode 1). A block
    masked for every row of every sequence is skipped, as the kernel skips
    it (block_should_run over the batch's widest position ranges).
    Returns the final state: acc [B, H, Sq, D], m and l [B, H, Sq, 1]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Sq, D = q.shape
    Hkv, Skv = k_i8.shape[1], k_i8.shape[2]
    group = H // Hkv
    nkv = Skv // block_kv
    dev = q.device
    ln_p = math.log(p_scale)
    qf = q.float()
    sq = true_div(torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=scale_clamp), 127.0)
    q_int = torch.clamp(torch.round(qf / sq), -127, 127).double()
    k_rep = k_i8.repeat_interleave(group, dim=1)
    v_rep = v_i8.repeat_interleave(group, dim=1)
    ks_rep = k_scales.repeat_interleave(group, dim=1)  # [B, H, nkv]
    vs_rep = v_scales.repeat_interleave(group, dim=1)
    qpos = (torch.arange(Sq, device=dev)[None, :]
            + offsets[:, 0:1].long())[:, None, :, None]     # [B, 1, Sq, 1]
    m = torch.full((B, H, Sq, 1), float("-inf"), device=dev)
    l = torch.zeros((B, H, Sq, 1), device=dev)
    acc = torch.zeros((B, H, Sq, D), device=dev)
    first_q = int(offsets[:, 0].min())
    last_q = int(offsets[:, 0].max()) + Sq - 1
    kv_lo, kv_hi = int(offsets[:, 1].min()), int(offsets[:, 1].max())
    for j in range(nkv):
        if not block_should_run(causal, window, sinks, first_q, last_q,
                                kv_lo + j * block_kv, kv_hi + (j + 1) * block_kv - 1):
            continue
        kb = slice(j * block_kv, (j + 1) * block_kv)
        s_int = (q_int @ k_rep[:, :, kb].double().transpose(-1, -2)).float()
        s = s_int * (sq * (ks_rep[:, :, j] * sm_scale)[:, :, None, None])
        if softcap is not None:
            s = softcap * torch.tanh(true_div(s, softcap))
        kloc = torch.arange(j * block_kv, (j + 1) * block_kv, device=dev)
        kpos = (kloc[None, :] + offsets[:, 1:2].long())[:, None, None, :]
        valid = torch.ones_like(s, dtype=torch.bool)
        if causal:
            valid = valid & (kpos <= qpos)
            if window is not None:
                in_win = (qpos - kpos) < window
                if sinks:
                    in_win = in_win | (kpos < sinks)
                valid = valid & in_win
        if kv_len < Skv:
            valid = valid & (kloc < kv_len)
        s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - (m_next - ln_p))
        p = torch.where(m_next > DEFAULT_MASK_VALUE * 0.5, p, torch.zeros_like(p))
        if mode == 0:
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = (torch.round(p).double() @ v_rep[:, :, kb].double()).float()
        else:
            pb = p.to(torch.bfloat16).float()
            l = alpha * l + (pb if mode == 1 else p).sum(dim=-1, keepdim=True)
            pv = pb @ v_rep[:, :, kb].float()
        acc = acc * alpha + pv * vs_rep[:, :, j][:, :, None, None]
        m = m_next
    return acc, m, l


def _flash_int8_plain(q, *operands, save_residuals, p_scale, **kw):
    """Plain version of the kernel: o (and lse with save_residuals) from
    the final state of _flash_int8_plain_state."""
    acc, m, l = _flash_int8_plain_state(q, *operands, p_scale=p_scale, **kw)
    ln_p = math.log(p_scale)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    o = (acc * l_inv).to(q.dtype)
    if not save_residuals:
        return o
    lse = torch.where(l > 0.0, m + torch.log(l) - ln_p,
                      torch.full_like(l, float("-inf")))
    return o, lse[..., 0]


def _flash_int8_launch(q, k_i8, k_scales, v_i8, v_scales, offsets, *, sm_scale,
                       causal, kv_len, block_kv, scale_clamp, p_scale, window,
                       softcap, sinks, mode, save_residuals):
    """Checked operands of one kernel launch: (kernel, ctypes args, outputs)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k_i8.shape[1], k_i8.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA int8 attention takes head_dim in {_HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise ValueError("k/v must be int8")
    q = q.contiguous()
    k_i8, v_i8 = k_i8.contiguous(), v_i8.contiguous()
    k_scales = k_scales.float().contiguous()
    v_scales = v_scales.float().contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if save_residuals else None)
    ptr = cuda_lib.ptr
    args = (ptr(q), ptr(k_i8, 16), ptr(v_i8, 16), ptr(k_scales), ptr(v_scales),
            ptr(offsets), ptr(o), ptr(lse),
            B, H, Hkv, Sq, Skv, Skv // block_kv, D, kv_len,
            sm_scale, scale_clamp, math.log(p_scale),
            int(softcap is not None), float(softcap or 0.0),
            int(causal), -1 if window is None else int(window), int(sinks),
            int(kv_len < Skv), DEFAULT_MASK_VALUE, DEFAULT_MASK_VALUE * 0.5,
            mode, int(q.dtype == torch.bfloat16), cuda_lib.stream_of(q))
    # The operand tensors ride along so they outlive every launch of args.
    keep = (q, k_i8, v_i8, k_scales, v_scales, offsets)
    return _KERNEL_OF_MODE[mode], args, (o, lse), keep


def _flash_int8_cuda(*operands, save_residuals, **kw):
    kernel, args, (o, lse), _ = _flash_int8_launch(
        *operands, save_residuals=save_residuals, **kw)
    kernel(*args)
    return (o, lse) if save_residuals else o


# The INT8 attention has no backward, in the JAX package as here: jax.grad
# through its flash_attention_int8 fails (an AssertionError in its Pallas
# lowering), so every INT8 entry point refuses an input that requires grad.
_NO_GRAD = ("the INT8 flash attention is not differentiable (jax.grad through "
            "the JAX package's flash_attention_int8 fails too): use "
            "attention_impl='flash' or 'reference' to train")


def _prequant(q, k_i8, k_scales, v_i8, v_scales, *, kv_len, sm_scale, causal,
              block_kv, scale_clamp, p_static_scale, q_offset, kv_offset,
              save_residuals, window, logit_softcap, attention_sinks,
              pv_dtype, summode):
    refuse_grad(_NO_GRAD, q, k_scales, v_scales)
    validate_masking(causal, window, attention_sinks)
    if (pv_dtype, summode) not in _MODES:
        raise ValueError(f"unsupported pv_dtype/summode {pv_dtype!r}/{summode!r}")
    batch, heads, q_len, head_dim = q.shape
    kv_len_p = k_i8.shape[2]
    kv_len = kv_len if kv_len is not None else kv_len_p
    kv_heads = k_i8.shape[1]
    if heads % kv_heads:
        raise ValueError(f"q heads {heads} not a multiple of kv heads {kv_heads}")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    nkv = k_scales.shape[-1]
    block_kv = kv_len_p // nkv if block_kv is None else min(block_kv, kv_len_p)
    # Hard errors: a block-size mismatch would dequantize every block with
    # the WRONG scale.
    if kv_len_p % block_kv:
        raise ValueError(f"cache length {kv_len_p} not a multiple of "
                         f"block_kv {block_kv}")
    if nkv != kv_len_p // block_kv:
        raise ValueError(
            f"k_scales has {nkv} blocks but the cache implies "
            f"{kv_len_p // block_kv} at block_kv={block_kv}")
    if causal and q_offset is None and q_len > kv_len:
        raise ValueError("causal attention requires q_len <= kv_len")
    if q_offset is None:
        q_offset = kv_len - q_len
    if kv_offset is None:
        kv_offset = 0
    offsets = _offsets(q_offset, kv_offset, batch, q.device)
    fn = _flash_int8_cuda if q.is_cuda else _flash_int8_plain
    return fn(q, k_i8, k_scales, v_i8, v_scales, offsets, sm_scale=scale,
              causal=causal, kv_len=kv_len, block_kv=block_kv,
              scale_clamp=scale_clamp, p_scale=p_static_scale, window=window,
              softcap=logit_softcap, sinks=attention_sinks,
              mode=_MODES[(pv_dtype, summode)], save_residuals=save_residuals)


def flash_attention_int8_prequant(
    q: torch.Tensor,
    k_i8: torch.Tensor,
    k_scales: torch.Tensor,
    v_i8: torch.Tensor,
    v_scales: torch.Tensor,
    *,
    kv_len: Optional[int] = None,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale_clamp: float = 1e-8,
    p_static_scale: float = 127.0,
    q_offset=None,
    kv_offset=None,
    save_residuals: bool = False,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    pv_dtype: str = "int8",
):
    """Fused INT8 attention over pre-quantized K/V (the INT8 KV-cache path).

    q: [batch, heads, q_len, head_dim] f32/bf16. k_i8, v_i8: [batch,
    kv_heads, kv_len_padded, head_dim] int8, kv_heads dividing heads (GQA:
    q head h reads kv head h // group, nothing is repeated in memory);
    k_scales, v_scales: [batch, kv_heads, nkv] f32, one per block_kv block.
    kv_len: true (unpadded) kv length. q_offset/kv_offset: global positions
    for causal masking (ints or [batch] tensors), default end-aligned.
    block_q is accepted for signature parity; it has no numerical effect.
    pv_dtype: "int8" (mode 0) or "bf16" (mode 2: bf16 P with l over the
    f32 P', as the JAX package's standard kernel computes it).
    Returns o (q's dtype), plus lse [batch, heads, q_len] with
    save_residuals.
    """
    del block_q
    return _prequant(
        q, k_i8, k_scales, v_i8, v_scales, kv_len=kv_len, sm_scale=sm_scale,
        causal=causal, block_kv=block_kv, scale_clamp=scale_clamp,
        p_static_scale=p_static_scale, q_offset=q_offset, kv_offset=kv_offset,
        save_residuals=save_residuals, window=window,
        logit_softcap=logit_softcap, attention_sinks=attention_sinks,
        pv_dtype=pv_dtype, summode="vpu")


def pick_blocks_t(
    q_len: int,
    kv_len: int,
    head_dim: int = 64,
    *,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
):
    """(block_q, block_kv) of the transposed route: block_kv keeps the JAX
    package's default of 512, a numerics parameter (quant block and
    softmax step); block_q, as in pick_blocks, is the whole q_len unless
    given. head_dim is accepted for signature parity."""
    del head_dim
    return min(block_q or q_len, q_len), min(block_kv or 512, kv_len)


def flash_attention_int8_t_prequant(
    q: torch.Tensor,
    k_i8: torch.Tensor,
    k_scales: torch.Tensor,
    v_i8: torch.Tensor,
    v_scales: torch.Tensor,
    *,
    kv_len: Optional[int] = None,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
    scale_clamp: float = 1e-8,
    p_static_scale: float = 127.0,
    q_offset=None,
    kv_offset=None,
    save_residuals: bool = False,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    pv_dtype: str = "bf16",
    summode: Optional[str] = None,
):
    """The transposed route's numerics over PRE-quantized K/V: bf16 P by
    default, l summing that bf16 P (summode "mxu", mode 1) or the f32 P'
    (summode "vpu", mode 2); pv_dtype "int8" is mode 0. Same arguments as
    flash_attention_int8_prequant; block_kv is implied by k_scales."""
    del block_q
    if summode is None:
        summode = "mxu" if pv_dtype == "bf16" else "vpu"
    if summode not in ("vpu", "mxu"):
        raise ValueError(f"summode must be 'vpu' or 'mxu', got {summode!r}")
    if summode == "mxu" and pv_dtype != "bf16":
        raise ValueError("summode='mxu' requires pv_dtype='bf16'")
    nkv = k_scales.shape[-1]
    if k_i8.shape[2] % nkv:
        raise ValueError(f"cache length {k_i8.shape[2]} not divisible into "
                         f"{nkv} scale blocks")
    return _prequant(
        q, k_i8, k_scales, v_i8, v_scales, kv_len=kv_len, sm_scale=sm_scale,
        causal=causal, block_kv=None, scale_clamp=scale_clamp,
        p_static_scale=p_static_scale, q_offset=q_offset, kv_offset=kv_offset,
        save_residuals=save_residuals, window=window,
        logit_softcap=logit_softcap, attention_sinks=attention_sinks,
        pv_dtype=pv_dtype, summode=summode)


def _quantize_padded(k, v, block_kv, scale_clamp):
    kv_pad = (-k.shape[2]) % block_kv
    if kv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, kv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, kv_pad))
    k_i8, k_scales = quantize_kv_blocks(k, block_kv, scale_clamp=scale_clamp)
    v_i8, v_scales = quantize_kv_blocks(v, block_kv, scale_clamp=scale_clamp)
    return k_i8, k_scales, v_i8, v_scales


def flash_attention_int8_t(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale_clamp: float = 1e-8,
    p_static_scale: float = 127.0,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    pv_dtype: str = "bf16",
    summode: Optional[str] = None,
) -> torch.Tensor:
    """Quantize K/V per block_kv block (default 512), then run the
    transposed route's numerics (bf16 P by default)."""
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    refuse_grad(_NO_GRAD, q, k, v)
    validate_masking(causal, window, attention_sinks)
    q_len, kv_len = q.shape[2], k.shape[2]
    if causal and q_len > kv_len:
        raise ValueError("causal attention requires q_len <= kv_len")
    _, block_kv_eff = pick_blocks_t(q_len, kv_len, q.shape[-1],
                                    block_q=block_q, block_kv=block_kv)
    k_i8, k_scales, v_i8, v_scales = _quantize_padded(k, v, block_kv_eff, scale_clamp)
    return flash_attention_int8_t_prequant(
        q, k_i8, k_scales, v_i8, v_scales,
        kv_len=kv_len, sm_scale=sm_scale, causal=causal,
        scale_clamp=scale_clamp, p_static_scale=p_static_scale,
        window=window, logit_softcap=logit_softcap,
        attention_sinks=attention_sinks, pv_dtype=pv_dtype, summode=summode)


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale_clamp: float = 1e-8,
    p_static_scale: float = 127.0,
    transposed: Optional[bool] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    pv_dtype: Optional[str] = None,
    summode: Optional[str] = None,
) -> torch.Tensor:
    """Fused INT8-quantized attention forward.

    q, k, v: [batch, heads, seq, head_dim] float32/bfloat16 in, q's dtype
    out. K/V are block-quantized in an O(S*D) prepass. GQA: k/v may carry
    fewer heads than q. The route follows the JAX package
    (flash_attention_int8.py:956): head_dim <= 64, or head_dim <= 128 and
    not causal, takes the transposed route (`_int8_fwd_kernel_t`, block_kv
    512): bf16 P with summode "mxu" (mode 1) or "vpu" (mode 2), or int8 P
    (mode 0); otherwise the standard route (`_int8_fwd_kernel`, block_kv
    1024 by pick_blocks): int8 P (mode 0) or, with pv_dtype "bf16", mode 2.
    `transposed` forces a route at any head dim. Not differentiable
    (refuse_grad).
    """
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    refuse_grad(_NO_GRAD, q, k, v)
    validate_masking(causal, window, attention_sinks)
    q_len, kv_len, head_dim = q.shape[2], k.shape[2], q.shape[-1]
    if transposed is None:
        transposed = head_dim <= 64 or (head_dim <= 128 and not causal)
    if transposed:
        return flash_attention_int8_t(
            q, k, v, sm_scale=sm_scale, causal=causal,
            block_q=block_q, block_kv=block_kv,
            scale_clamp=scale_clamp, p_static_scale=p_static_scale,
            window=window, logit_softcap=logit_softcap,
            attention_sinks=attention_sinks,
            pv_dtype=pv_dtype if pv_dtype is not None else "bf16",
            summode=summode)
    if summode not in (None, "vpu"):
        raise ValueError("summode='mxu' belongs to the transposed route")
    _, block_kv_eff = pick_blocks(q_len, kv_len, head_dim,
                                  block_q=block_q, block_kv=block_kv)
    k_i8, k_scales, v_i8, v_scales = _quantize_padded(k, v, block_kv_eff, scale_clamp)
    return flash_attention_int8_prequant(
        q, k_i8, k_scales, v_i8, v_scales,
        kv_len=kv_len, sm_scale=sm_scale, causal=causal,
        block_kv=block_kv_eff, scale_clamp=scale_clamp,
        p_static_scale=p_static_scale,
        window=window, logit_softcap=logit_softcap,
        attention_sinks=attention_sinks,
        pv_dtype=pv_dtype if pv_dtype is not None else "int8")
