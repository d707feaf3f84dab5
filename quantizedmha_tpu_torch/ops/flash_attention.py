"""FlashAttention-2 forward and backward in f32 or bf16, and the masking
and block helpers every attention entry point shares (counterpart of
quantizedmha_tpu/ops/flash_attention.py).

On a CUDA tensor `flash_attention` launches the hand-written kernel in
`csrc/flash_fwd.cu` (TPU kernel `_fwd_kernel`); on a CPU tensor it runs
`_flash_fwd_plain`, the same online softmax step by step in PyTorch at the
JAX package's kv step (block_kv, default 1024). In bf16 the kernel runs on
Hopper's wgmma: a block holds 192 rows (128 at head_dim 32), all q heads
of a kv head's group times rows / group positions, so each K/V tile is
read once for the whole group; a producer warpgroup copies the K/V tiles
into a ring of shared-memory stages and the consumer warpgroups, 64 rows
each, run both products and the online softmax, 64 keys a step. The
numerics are the plain version's (Q scaled in bf16, f32 scores, P rounded
to bf16 for P·V, l the f32 sum) up to summation order, the step at which
each P is rounded, and the SFU's 2^x. In f32 the kernel runs on the tensor
cores too, as the TPU's Precision.HIGHEST runs on its matrix unit: a split
pass writes Q (scaled in f32), K and V as three bf16 planes each (a = a0 +
a1 + a2 exactly), each product is the sum of six bf16 products (a0b0,
a0b1, a1b0, a0b2, a1b1, a2b0), and P is split the same way for P·V; the
terms left out are at most 2^-24·|a||b|. At head_dim 256 (Gemma-2 served
in f32) three bf16 planes of a tile do not fit, so the f32 kernel runs true
f32 FMAs on the CUDA cores instead (`csrc/f32_tile.cuh`'s tile step, a block
of 64 rows of one q head, f32 tiles of Q, K and V straight from the
tensors: no split pass and no planes scratch). The TPU grid's shrunk windowed kv
dimension and its ones-column l sum (`summode="mxu"`) are TPU
devices with no counterpart: the only sum mode is "vpu" (l sums the f32
P). Under autograd the call is a `torch.autograd.Function` whose backward
is `csrc/flash_bwd.cu`'s dK/dV and dQ kernels (TPU `_bwd_dkv_kernel`,
`_bwd_dq_kernel`) on a CUDA tensor and `_flash_bwd_plain` on a CPU one. In
bf16 the backward runs on the tensor cores with P and dS rounded to bf16
as the operands of dV, dK and dQ (the TPU's Precision.DEFAULT); in f32 it
runs every product as a true f32 FMA on the CUDA cores (Precision.HIGHEST).
Both take head_dim 256 (Gemma-2's training path, in bf16 and in f32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops.quantize import true_div

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# q, k, v, offsets, o, lse, the f32 route's planes, then the sizes and masks.
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
         + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
# One launch counter per input dtype: bf16 in one wgmma pass, f32 in six bf16
# wgmma passes after its split pass (one launch of the C entry, counted
# once) at head_dim <= 128 and in true f32 FMAs on the CUDA cores at 256;
# both stand for `_fwd_kernel`.
FLASH_FWD_BF16 = cuda_lib.CudaKernel("flash_fwd", "flash_fwd", _ARGS)
FLASH_FWD_F32 = cuda_lib.CudaKernel("flash_fwd", "flash_fwd", _ARGS)
# head_dim 256 (Gemma-2): the forward and the backward in bf16 and f32.
_HEAD_DIMS = (32, 64, 128, 256)


def validate_masking(causal: bool, window, sinks: int) -> None:
    """One validation contract for every attention entry point: a masking
    knob one kernel would drop silently must raise everywhere."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sinks and window is None:
        raise ValueError("attention_sinks require a window")


def block_should_run(causal: bool, window, sinks: int,
                     first_q, last_q, first_kv, last_kv):
    """Block-level skip: run unless the block is wholly above the causal
    diagonal or wholly behind the window (sink blocks always considered).
    Positions are GLOBAL. Skipping such a block changes no output bit: all
    its scores are masked, so it adds p = 0 and never raises a row max."""
    if not causal:
        return True
    run = last_q >= first_kv
    if window is not None:
        in_window = (first_q - last_kv) < window
        if sinks:
            in_window |= first_kv < sinks
        run &= in_window
    return run


def pick_blocks(
    q_len: int,
    kv_len: int,
    head_dim: int,
    *,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
):
    """(block_q, block_kv) of the standard route. block_kv keeps the JAX
    package's default of 1024 because it fixes the numerics (the K/V quant
    block of the int8 kernels and the online-softmax step of every one);
    block_q has no numerical effect and the TPU's VMEM caps on it do not
    apply, so it is the whole q_len unless given. head_dim is accepted for
    signature parity."""
    del head_dim
    return min(block_q or q_len, q_len), min(block_kv or 1024, kv_len)


def _offsets(q_offset, kv_offset, batch: int, device) -> torch.Tensor:
    """Per-sequence (q_off, kv_off) global positions, [batch, 2] int32."""
    def col(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device).expand(batch)
    return torch.stack([col(q_offset), col(kv_offset)], dim=1).contiguous()


def scaled_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Q times sm_scale in Q's own dtype, as the TPU kernel folds it: in
    bf16 the scale is rounded to bf16 first, then the product."""
    return q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)


def _flash_fwd_plain(q, k, v, offsets, *, sm_scale, causal, block_kv, window,
                     softcap, sinks, save_residuals):
    """The TPU kernel's algorithm over whole tensors: Q scaled in its dtype,
    f32 scores (TF32 off), softcap, masks at global positions, then the
    online softmax stepping exactly block_kv keys at a time, P cast to V's
    dtype for P·V while l sums the f32 P. A block masked for every row of
    every sequence is skipped, as the kernels skip it (no bit changes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    dev = q.device
    qs = scaled_q(q, sm_scale).float().reshape(B, Hkv, group, Sq, D)
    kf = k.float()[:, :, None]
    vf = v[:, :, None]
    qpos = (torch.arange(Sq, device=dev)[None, :]
            + offsets[:, 0:1].long())[:, None, None, :, None]   # [B, 1, 1, Sq, 1]
    m = torch.full((B, Hkv, group, Sq, 1), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, group, Sq, 1), device=dev)
    acc = torch.zeros((B, Hkv, group, Sq, D), device=dev)
    first_q = int(offsets[:, 0].min())
    last_q = int(offsets[:, 0].max()) + Sq - 1
    kv_lo, kv_hi = int(offsets[:, 1].min()), int(offsets[:, 1].max())
    for j0 in range(0, Skv, block_kv):
        j1 = min(j0 + block_kv, Skv)
        if not block_should_run(causal, window, sinks, first_q, last_q,
                                kv_lo + j0, kv_hi + j1 - 1):
            continue
        s = qs @ kf[..., j0:j1, :].transpose(-1, -2)
        if softcap is not None:
            s = softcap * torch.tanh(true_div(s, softcap))
        if causal:
            kpos = (torch.arange(j0, j1, device=dev)[None, :]
                    + offsets[:, 1:2].long())[:, None, None, None, :]
            valid = kpos <= qpos
            if window is not None:
                in_win = (qpos - kpos) < window
                if sinks:
                    in_win = in_win | (kpos < sinks)
                valid = valid & in_win
            s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        p = torch.where(m_next > DEFAULT_MASK_VALUE * 0.5, p, torch.zeros_like(p))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = p.to(v.dtype).float() @ vf[..., j0:j1, :].float()
        acc = acc * alpha + pv
        m = m_next
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    o = (acc * l_inv).to(q.dtype).reshape(B, H, Sq, D)
    if not save_residuals:
        return o
    lse = torch.where(l > 0.0, m + torch.log(l), torch.full_like(l, float("-inf")))
    return o, lse[..., 0].reshape(B, H, Sq)


def _flash_fwd_launch(q, k, v, offsets, *, sm_scale, causal, block_kv, window,
                      softcap, sinks, save_residuals):
    """Checked operands of one kernel launch: (kernel, ctypes args,
    outputs, operands). block_kv is the plain version's step; the kernel
    picks its own tiles. The f32 route's scratch, Q's, K's and V's three
    bf16 planes each, is the last operand (None in bf16 and at head_dim
    256, whose f32 kernel reads the f32 tensors)."""
    del block_kv
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA flash attention takes head_dim in {_HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bf16 = q.dtype == torch.bfloat16
    # The kernel multiplies by the scale in q's dtype: round it there first.
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if save_residuals else None)
    planes = (None if bf16 or D == 256 else
              torch.empty(3 * (q.numel() + k.numel() + v.numel()), dtype=torch.bfloat16,
                          device=q.device))
    ptr = cuda_lib.ptr
    args = (ptr(q, 16), ptr(k, 16), ptr(v, 16), ptr(offsets), ptr(o, 16), ptr(lse),
            ptr(planes, 16), B, H, Hkv, Sq, Skv, D, scale, int(softcap is not None), float(softcap or 0.0),
            int(causal), -1 if window is None else int(window), int(sinks),
            DEFAULT_MASK_VALUE, DEFAULT_MASK_VALUE * 0.5, int(bf16),
            cuda_lib.stream_of(q))
    kernel = FLASH_FWD_BF16 if bf16 else FLASH_FWD_F32
    return kernel, args, (o, lse), (q, k, v, offsets, planes)


def _flash_fwd_cuda(*operands, save_residuals, **kw):
    kernel, args, (o, lse), _ = _flash_fwd_launch(
        *operands, save_residuals=save_residuals, **kw)
    kernel(*args)
    return (o, lse) if save_residuals else o


# ---------------------------------------------------------------------------
# Backward: P = exp(S·scale − lse); di = rowsum(dO·O) − dlse;
#   dV = PᵀdO; dS = P(dO·Vᵀ − di)·scale; dQ = dS·K; dK = dSᵀQ.


def _bwd_reference(sm_scale, causal, q, k, v, o, lse, do):
    """Full-materialization oracle of the backward (equal head counts,
    end-aligned causal mask), in f32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qf, kf, vf, dof, of = (x.float() for x in (q, k, v, do, o))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    q_len, kv_len = s.shape[-2], s.shape[-1]
    if causal:
        qi = torch.arange(q_len, device=s.device)[:, None] + (kv_len - q_len)
        ki = torch.arange(kv_len, device=s.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    di = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - di) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_di(o, do, dlse):
    """The di prepass: rowsum(dO·O) in f32 [B, H, Sq], minus dlse when given
    (the lse cotangent folds in as di − dlse)."""
    di = (do.float() * o.float()).sum(dim=-1)
    return di if dlse is None else di - dlse.float()


def _bwd_pairs(qh, kh, vh, doh, lse, di, q_pos, k_pos, *, sm_scale, causal, window,
               softcap, sinks, operand_dtype=None):
    """(p, dp, ds) of one kv head's group, f32 [B, G, Sq, Skv], from q and
    dO rows [B, G, Sq, D], K and V rows [B, Skv, D], lse and di [B, G, Sq]
    and global positions q_pos [B, Sq], k_pos [B, Skv]: the masks of
    `_mk_mask`, p exactly 0 where masked (never exp(+inf)·0 on a row whose
    lse is -inf), softcap's 1 − tanh² chain factor on ds, computed from the
    f32 p. With operand_dtype (bf16) p and ds come back rounded to it and
    widened to f32 again, as they enter the second products dV = PᵀdO,
    dK = dSᵀQ and dQ = dS·K (the TPU's Precision.DEFAULT: one bf16 pass)."""
    s = qh.float() @ kh.float()[:, None].transpose(-1, -2) * sm_scale
    th = None
    if softcap is not None:
        th = torch.tanh(true_div(s, softcap))
        s = softcap * th
    p = torch.exp(s - lse[..., None])
    if causal:
        qp, kp = q_pos[:, None, :, None], k_pos[:, None, None, :]
        valid = kp <= qp
        if window is not None:
            in_win = (qp - kp) < window
            if sinks:
                in_win = in_win | (kp < sinks)
            valid = valid & in_win
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = doh.float() @ vh.float()[:, None].transpose(-1, -2)
    ds = p * (dp - di[..., None]) * sm_scale
    if th is not None:
        ds = ds * (1.0 - th * th)
    if operand_dtype is not None:
        p, ds = p.to(operand_dtype).float(), ds.to(operand_dtype).float()
    return p, dp, ds


def _bwd_positions(offsets, sq, skv):
    """Global q and kv positions, [B, Sq] and [B, Skv], from [B, 2] offsets."""
    dev = offsets.device
    q_pos = torch.arange(sq, device=dev)[None, :] + offsets[:, 0:1].long()
    k_pos = torch.arange(skv, device=dev)[None, :] + offsets[:, 1:2].long()
    return q_pos, k_pos


def _bwd_sums(q, k, v, o, lse, do, offsets, dlse=None, *, sm_scale, causal, window,
              softcap, sinks):
    """The two backward kernels' algorithm over whole tensors, one kv head's
    GQA group at a time: (dq, dk, dv) as f32 sums, dK and dV summed over
    the group. f32 inputs: f32 throughout (TF32 off). bf16 inputs: S, dP, p
    and ds in f32, then p and ds rounded to bf16 as the operands of the
    three second products, which run in f32 on the widened values (TF32
    off; never a bf16 GEMM, whose reduction may drop below f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    operand_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else None
    di = _bwd_di(o, do, dlse)
    q_pos, k_pos = _bwd_positions(offsets, Sq, Skv)
    dq = torch.empty(q.shape, device=q.device)
    dk, dv = torch.empty(k.shape, device=k.device), torch.empty(v.shape, device=v.device)
    for h in range(Hkv):
        grp = slice(h * G, (h + 1) * G)
        qh, doh = q[:, grp], do[:, grp]
        p, _, ds = _bwd_pairs(qh, k[:, h], v[:, h], doh, lse[:, grp], di[:, grp], q_pos, k_pos,
                              sm_scale=sm_scale, causal=causal, window=window,
                              softcap=softcap, sinks=sinks, operand_dtype=operand_dtype)
        dv[:, h] = torch.einsum("bgqk,bgqd->bkd", p, doh.float())
        dk[:, h] = torch.einsum("bgqk,bgqd->bkd", ds, qh.float())
        dq[:, grp] = ds @ k[:, h].float()[:, None]
    return dq, dk, dv


def _flash_bwd_plain(q, k, v, o, lse, do, offsets, dlse=None, **kw):
    """`_bwd_sums` cast once to the inputs' dtypes, as the kernels store."""
    dq, dk, dv = _bwd_sums(q, k, v, o, lse, do, offsets, dlse, **kw)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# q, k, v, dO, lse, di, dlse, offsets, then dk, dv (flash_bwd_dq: dq alone).
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
# Rows 6 and 7 of the kernel table; each entry takes f32 or bf16.
FLASH_BWD_DKV = cuda_lib.CudaKernel("flash_bwd", "flash_bwd_dkv", _BWD_ARGS)
FLASH_BWD_DQ = cuda_lib.CudaKernel(
    "flash_bwd", "flash_bwd_dq", [ctypes.c_void_p] * 9 + _BWD_ARGS[10:])


def _flash_bwd_launch(q, k, v, o, lse, do, offsets, dlse=None, *, sm_scale, causal, window,
                      softcap, sinks):
    """Checked operands of the two backward launches: ([(kernel, ctypes
    args) for dK/dV, then dQ], (dq, dk, dv), operands). The di prepass runs
    here; the dlse fold runs in the kernels. The args hold raw pointers:
    the caller keeps `operands` alive until the launches are done."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA flash backward takes head_dim in {_HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if any(x.dtype != q.dtype for x in (k, v, do)):
        raise ValueError("q, k, v and the output gradient must share a dtype")
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    lse = lse.float().contiguous()
    di = _bwd_di(o, do, None).contiguous()
    dlse = None if dlse is None else dlse.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptr = cuda_lib.ptr
    ins = (ptr(q, 16), ptr(k, 16), ptr(v, 16), ptr(do, 16), ptr(lse), ptr(di), ptr(dlse),
           ptr(offsets))
    tail = (B, H, Hkv, Sq, Skv, D, float(sm_scale), int(softcap is not None),
            float(softcap or 0.0), int(causal), -1 if window is None else int(window),
            int(sinks), int(q.dtype == torch.bfloat16), cuda_lib.stream_of(q))
    launches = [(FLASH_BWD_DKV, ins + (ptr(dk, 16), ptr(dv, 16)) + tail),
                (FLASH_BWD_DQ, ins + (ptr(dq, 16),) + tail)]
    return launches, (dq, dk, dv), (q, k, v, do, lse, di, dlse, offsets)


def _flash_bwd_cuda(*operands, **kw):
    launches, grads, _operands = _flash_bwd_launch(*operands, **kw)
    for kernel, args in launches:
        kernel(*args)
    return grads


class _FlashAttention(torch.autograd.Function):
    """flash_attention as a differentiable function (JAX's
    `_flash_attention_custom` and `_flash_attention_lse_custom`): the forward
    saves (q, k, v, o, lse, offsets), O(S·d) and no S×S tensor; with
    save_residuals both o and lse are differentiable; the offsets get no
    gradient. The backward is the two CUDA kernels on a CUDA tensor, else
    `_flash_bwd_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, offsets, kw, save_residuals):
        fwd = _flash_fwd_cuda if q.is_cuda else _flash_fwd_plain
        o, lse = fwd(q, k, v, offsets, save_residuals=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse, offsets)
        ctx.kw = {n: kw[n] for n in ("sm_scale", "causal", "window", "softcap", "sinks")}
        ctx.set_materialize_grads(False)
        return (o, lse) if save_residuals else o

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, o, lse, offsets = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        bwd = _flash_bwd_cuda if q.is_cuda else _flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do.to(q.dtype), offsets, dlse, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    save_residuals: bool = False,
    q_offset=None,
    kv_offset=None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
):
    """Fused FlashAttention-2 forward.

    q: [batch, heads, q_len, head_dim]; k, v: [batch, kv_heads, kv_len,
    head_dim], kv_heads dividing heads (GQA/MQA: q head h reads kv head
    h // group, K/V are never repeated in memory); f32 or bf16, output in
    q's dtype. save_residuals=True also returns the log-sum-exp [batch,
    heads, q_len] f32 (-inf on a fully masked row, whose output is 0).
    q_offset/kv_offset are global positions for the causal mask (ints or
    [batch] tensors; they require save_residuals=True); the default is
    end-aligned, q_offset = kv_len - q_len. window, logit_softcap and
    attention_sinks as in the int8 kernels. block_kv sets the plain
    version's online-softmax step (default 1024, as the JAX package);
    block_q has no numerical effect.

    Differentiable in q, k and v (and through lse with save_residuals):
    with grad enabled and an input that requires grad the call goes
    through `_FlashAttention`, whose backward launches the dK/dV and dQ
    kernels of `csrc/flash_bwd.cu` on a CUDA tensor. Otherwise (every
    serving path) it calls the forward directly.
    """
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    validate_masking(causal, window, attention_sinks)
    if not save_residuals and (q_offset is not None or kv_offset is not None):
        raise ValueError("q_offset/kv_offset require save_residuals=True")
    batch, heads, q_len, head_dim = q.shape
    kv_len = k.shape[2]
    if heads % k.shape[1]:
        raise ValueError(f"q heads {heads} not a multiple of kv heads {k.shape[1]}")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    _, block_kv = pick_blocks(q_len, kv_len, head_dim, block_q=block_q, block_kv=block_kv)
    if q_offset is None:
        q_offset = kv_len - q_len
    if kv_offset is None:
        kv_offset = 0
    offsets = _offsets(q_offset, kv_offset, batch, q.device)
    kw = dict(sm_scale=scale, causal=causal, block_kv=block_kv, window=window,
              softcap=logit_softcap, sinks=attention_sinks)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, offsets, kw, save_residuals)
    fn = _flash_fwd_cuda if q.is_cuda else _flash_fwd_plain
    return fn(q, k, v, offsets, save_residuals=save_residuals, **kw)
