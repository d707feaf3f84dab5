#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quantizedmha_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

  build    compile every CUDA source under quantizedmha_tpu_torch/csrc/
           (one nvcc each, in parallel) and report the card.
  kernels  hold each kernel against its plain PyTorch version on the card
           at the main paths' shapes, every element within its stated
           tolerance (err_over_tol <= 1), then on small cases off the main
           paths; kernel / plain / library times (CUDA events) and the
           least time the card could take (bound).
  solve    the reference ABI, solve(kernel="fa_int8") at N=8192,
           d_model=1024, h=32 in float32: time, relative RMS error against
           the float golden, and the constant-input gate (all-ones ->
           exactly 1.0).
  serve    Llama-3-8B width and depth (32 layers), random INT8 (w8a16)
           weights with a bf16 lm_head, flash_int8 prefill and paged INT8
           decode through the continuous-batching engine: 8 requests of
           256-token prompts, 32 new tokens each, greedy.
  serve_w4 "llama3-8b-shape-int4-lmh8": the same model's random weights
           quantized to INT4 (group 128, halves packing, wq|wk|wv and
           w_gate|w_up fused) with an int8 lm_head, served by the serving
           benchmark (harness/serving_bench.run_decode_bench) at batch 1,
           8 and 32: 512-token prompts, 64 new tokens each, decode chunk
           16. Every decode matmul goes through the w4_matmul kernel
           (exactly 4 launches a layer a decode step; 512-row prefills
           take the dequantize-then-matmul lowering). A 64-token prefill
           is held against the dequantized weights as plain bf16 tensors.

Launch counts: every kernel wrapper counts its launches; the counts are
zeroed just before each main path (solve, serve, each serve_w4 batch)
runs and read just after, and a kernel of that path that never launched
fails the run. The last
lines are the kernels summary, the card's name and power limit, and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback

# Peaks of one H100 SXM (NVIDIA data sheet, dense): bytes/s, int8 op/s,
# bf16 flop/s, fp32 (non-tensor) flop/s, and exponentials/s on the SFUs
# (132 SMs x 16 per clock x 1.98 GHz boost).
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
EXP_PER_S = 132 * 16 * 1.98e9
REFERENCE_L4_MS = 7.70  # the reference study's fa_tc_int8_b on an NVIDIA L4
SOLVE_REL_RMS_TOL = 0.03  # int8 solve vs the float golden (phase_solve)

PHASES = ("build", "kernels", "solve", "serve", "serve_w4")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the larger of the bytes time and the busiest
    unit's operations time (int8 and bf16 products share the tensor cores)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = max(ops.get("int8", 0) / INT8_OPS + ops.get("bf16", 0) / BF16_FLOPS,
                ops.get("fp32", 0) / FP32_FLOPS, ops.get("exp", 0) / EXP_PER_S)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def err_over_tol(got, want, tol) -> float:
    """max |got - want| / tol over the elements (tol broadcasts); equal
    values, infinities included, count 0 and a NaN counts inf. The check
    passes at <= 1."""
    import torch
    got, want = got.double(), want.double()
    ratio = torch.where(got == want, torch.zeros_like(got), (got - want).abs() / tol)
    return float(torch.nan_to_num(ratio, nan=float("inf")).max())


def flash_tolerances(o_plain, lse_plain, l, v_i8, v_scales, block_kv, mode):
    """Per-element tolerances of the flash kernel's output and lse (None
    when not saved) against its plain version, from the plain version's
    final P' sum per row (l: [B, H, Sq, 1]).

    The kernel's P' = exp2(fma(...)) sits a few f32 ulps from the plain
    version's exp(s - shift), so a P' within those ulps of a rounding
    boundary can round the other way: an int8 P by one unit, a bf16 P by
    one bf16 ulp (<= 0.5, as P' <= 127). One flip of key j moves the row's
    output by at most max|v| / l (int8 P: P·V moves by |v_j|; bf16 P: P·V
    and l move together, by at most 0.5 |v_j - o|), where max|v| is taken
    over the row's (batch, kv head) and l is the row's final P' sum; two
    flips are allowed. 1e-5 max|v| covers the f32 summation order and the
    ulps of P' itself; a bf16 output adds one bf16 ulp of |o|. lse moves by at most
    0.5 / l a flip in the bf16 P mode (l sums the rounded P), otherwise only
    by f32 rounding."""
    import torch
    from quantizedmha_tpu_torch.ops.quantize import dequantize_kv_blocks
    group = o_plain.shape[1] // v_i8.shape[1]
    vmax = dequantize_kv_blocks(v_i8, v_scales, block_kv).abs().amax(dim=(-2, -1))
    vmax = vmax.repeat_interleave(group, dim=1)[:, :, None, None].double()
    l = l.double()
    inv_l = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    flip = vmax * (2.0 * inv_l + 1e-5)
    tol_o = flip
    if o_plain.dtype == torch.bfloat16:
        tol_o = flip + 2.0**-7 * (o_plain.double().abs() + flip)
    if lse_plain is None:
        return tol_o, None
    tol_lse = ((inv_l[..., 0] if mode == 1 else 0.0) + 1e-5
               + 1e-6 * torch.nan_to_num(lse_plain.double().abs(), posinf=0.0))
    return tol_o, tol_lse


def w4_tolerance(x, w, ref, *, golden=False):
    """Per-element tolerance of a w4a16 product against `ref`: the plain
    version, or with golden=True x.float() @ dequantize_weight4(w) in f32.
    Kernel and plain version both round w = q*s to x's dtype once and sum
    x*w in f32, so they differ by the f32 summation order (1e-5 of
    sum_k |x_k w_k|) and, for a bf16 output, one bf16 ulp (2^-7 |ref|);
    f32's ulp lies inside the first term. The golden keeps w unrounded: a
    bf16 x adds one bf16 rounding of each weight, 2^-8 sum_k |x_k w_k|."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import dequantize_weight4
    bf16 = x.dtype == torch.bfloat16
    sum_abs = x.float().abs() @ dequantize_weight4(w).abs()
    tol = (1e-5 + (2.0**-8 if golden and bf16 else 0.0)) * sum_abs.double()
    if bf16:
        tol = tol + 2.0**-7 * ref.double().abs()
    return tol


def decode_tolerance(o_plain, v_pages, v_scales):
    """Per-element tolerance of the decode kernel against its plain version:
    both compute in f32 and differ only in summation order (1e-5 of the kv
    head's max|v|); a bf16 output adds one bf16 ulp of |o|."""
    import torch
    group = o_plain.shape[1] // v_pages.shape[0]
    vmax = (v_pages.float().abs().amax(dim=(-2, -1)) * v_scales).amax(dim=-1)  # [Hkv]
    tol = 1e-5 * vmax.repeat_interleave(group)[None, :, None].double()
    if o_plain.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * o_plain.double().abs()
    return tol


# ---------------------------------------------------------------------------


def phase_build(st):
    from quantizedmha_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    secs = time.perf_counter() - t0
    regs = {}
    for name, log in logs.items():
        used = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        regs[name] = {"max_registers": max(used, default=None),
                      "max_spill_store_bytes": max(spills, default=None)}
    st["gpu"] = gpu_line()
    emit({"phase": "build", "ok": True, "seconds": round(secs, 2),
          "ptxas": regs, "gpu": st["gpu"]})


def _flash_case(name, route_mode, q, k, v, block_kv, causal, *, replaces, library):
    """Kernel vs plain at one shape; returns the kernels-line entry."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    B, H, S, D = q.shape
    k_i8, ks = quantize_kv_blocks(k, block_kv)
    v_i8, vs = quantize_kv_blocks(v, block_kv)
    offsets = fa8._offsets(0, 0, B, q.device)  # q_len == kv_len: end-aligned
    kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=S, block_kv=block_kv,
              scale_clamp=1e-8, p_scale=127.0, window=None, softcap=None,
              sinks=0, mode=route_mode, save_residuals=False)
    # (_operands keeps the tensors behind args' raw pointers alive)
    kernel, args, (out, _), _operands = fa8._flash_int8_launch(
        q, k_i8, ks, v_i8, vs, offsets, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    plain = fa8._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, **kw)
    _, _, l = fa8._flash_int8_plain_state(
        q, k_i8, ks, v_i8, vs, offsets,
        **{k: x for k, x in kw.items() if k != "save_residuals"})
    tol, _ = flash_tolerances(plain, None, l, v_i8, vs, block_kv, route_mode)
    ratio = err_over_tol(out, plain, tol)
    ms = cuda_ms(lambda: kernel(*args), iters=20)
    plain_ms = cuda_ms(lambda: fa8._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, **kw),
                       iters=2, warmup=1)
    lib_ms = None
    if library:
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(qb, kb, vb, is_causal=causal,
                                      enable_gqa=kb.shape[1] != qb.shape[1]), iters=20)
    pairs = S * (S + 1) // 2 if causal else S * S
    Hkv = k.shape[1]
    nbytes = (q.numel() * q.element_size() * 2 + 2 * k_i8.numel()
              + 2 * ks.numel() * 4)
    matmul = 2 * B * H * pairs * D  # one of the two products, flops or ops
    ops = {"int8": matmul * (2 if route_mode == 0 else 1),
           "bf16": 0 if route_mode == 0 else matmul, "exp": B * H * pairs}
    bms, by = bound(nbytes, ops)
    return {"name": name, "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/flash_int8_fwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "err_over_tol": ratio, "tol_range": [tol.min().item(), tol.max().item()],
            "ok": ratio <= 1.0,
            "shape": {"B": B, "Hq": H, "Hkv": Hkv, "S": S, "D": D,
                      "causal": causal, "block_kv": block_kv, "q": str(q.dtype)},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def _decode_case(name, Hkv, *, replaces, seed):
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, Hq, D, P = 8, 32, 128, 128
    lengths = torch.randint(257, 301, (B,), generator=g, device="cuda", dtype=torch.int32)
    max_pages = 4
    num_pages = B * max_pages + 1
    perm = torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages] + 1
    tables = perm.reshape(B, max_pages).to(torch.int32)
    k_pages = torch.randint(-127, 128, (Hkv, num_pages, P, D), generator=g,
                            device="cuda", dtype=torch.int8)
    v_pages = torch.randint(-127, 128, (Hkv, num_pages, P, D), generator=g,
                            device="cuda", dtype=torch.int8)
    k_scales = torch.rand((Hkv, num_pages), generator=g, device="cuda") * 0.02 + 0.005
    v_scales = torch.rand((Hkv, num_pages), generator=g, device="cuda") * 0.02 + 0.005
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    kw = dict(sm_scale=D**-0.5, window=None, softcap=None, sinks=0, save_residuals=False)
    operands = (q, k_pages, v_pages, k_scales, v_scales, lengths, tables)
    kernel, args, (out, _), _operands = dec._paged_decode_launch(*operands, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    plain = dec._paged_decode_plain(*operands, **kw)
    tol = decode_tolerance(plain, v_pages, v_scales)
    ratio = err_over_tol(out, plain, tol)
    ms = cuda_ms(lambda: kernel(*args), iters=50)
    plain_ms = cuda_ms(lambda: dec._paged_decode_plain(*operands, **kw), iters=3, warmup=1)
    ctx = int(lengths.sum().item())
    nbytes = (q.numel() * 2 * 2 + 2 * ctx * Hkv * D
              + 2 * B * Hkv * max_pages * 4 + B * 4 + tables.numel() * 4)
    bms, by = bound(nbytes, {"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq})
    return {"name": name, "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_decode.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "err_over_tol": ratio, "tol_range": [tol.min().item(), tol.max().item()],
            "ok": ratio <= 1.0,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "page": P,
                      "lengths": lengths.tolist()},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


# Small shapes off the main paths, so that every branch of the two kernels
# is held against its plain version: ragged q tiles, quant blocks that are
# not a multiple of the kernel's 64-wide tile, a padded cache (kv tail
# mask), per-sequence offsets, GQA/MQA, window + sinks, softcap, both
# numerics modes at every head dim, both q dtypes and lse.
#   (B, H, Hkv, Sq, Skv, kv_len, D, block_kv, causal, window, sinks,
#    softcap, mode, bf16 q, q_offset or None for end-aligned)
FLASH_COVERAGE = (
    (2, 4, 2, 100, 192, 192, 32, 64, False, None, 0, None, 1, False, None),
    (2, 4, 2, 100, 192, 192, 64, 96, True, None, 0, None, 0, True, None),
    (1, 4, 1, 130, 256, 200, 128, 128, True, None, 0, None, 0, False, None),
    (1, 4, 2, 96, 192, 192, 128, 64, True, 40, 4, 30.0, 0, True, None),
    (1, 4, 4, 64, 320, 320, 32, 160, True, 50, 0, None, 0, False, None),
    (1, 8, 2, 77, 77, 77, 64, 77, True, None, 0, None, 1, True, None),
    (1, 2, 2, 200, 384, 384, 128, 384, False, None, 0, None, 1, False, None),
    (2, 4, 2, 64, 128, 128, 64, 64, True, None, 0, None, 0, False, (10, 50)),
    (1, 4, 2, 80, 160, 160, 32, 32, True, 24, 2, 20.0, 1, False, None),
)
#   (B, Hq, Hkv, D, page, window, sinks, softcap, bf16 q)
DECODE_COVERAGE = (
    (3, 8, 2, 32, 16, None, 0, None, False),
    (3, 4, 4, 64, 32, 20, 3, 50.0, True),
    (2, 8, 1, 128, 16, 7, 0, None, False),
)


def _coverage():
    """Every FLASH_COVERAGE / DECODE_COVERAGE case, kernel against plain on
    the card with output and lse checked; returns the summary entry, with
    each case's [output, lse] error over its tolerance."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    g = torch.Generator(device="cuda").manual_seed(5)
    ratios, failed = {}, []
    for i, (B, H, Hkv, Sq, Skv, kv_len, D, bkv, causal, window, sinks, cap, mode,
            qbf16, q_off) in enumerate(FLASH_COVERAGE):
        dt = torch.bfloat16 if qbf16 else torch.float32
        q = (torch.randn((B, H, Sq, D), generator=g, device="cuda") * 2).to(dt)
        kv = torch.randn((2, B, Hkv, Skv, D), generator=g, device="cuda").to(dt)
        k_i8, ks = quantize_kv_blocks(kv[0], bkv)
        v_i8, vs = quantize_kv_blocks(kv[1], bkv)
        qo = kv_len - Sq if q_off is None else torch.tensor(q_off, device="cuda")
        offsets = fa8._offsets(qo, 0, B, q.device)
        kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=kv_len, block_kv=bkv,
                  scale_clamp=1e-8, p_scale=127.0, window=window, softcap=cap,
                  sinks=sinks, mode=mode, save_residuals=True)
        kernel, args, (out, lse), _operands = fa8._flash_int8_launch(
            q, k_i8, ks, v_i8, vs, offsets, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        p_out, p_lse = fa8._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            q, k_i8, ks, v_i8, vs, offsets,
            **{k: x for k, x in kw.items() if k != "save_residuals"})
        tol, lse_tol = flash_tolerances(p_out, p_lse, l, v_i8, vs, bkv, mode)
        ratios[f"flash{i}"] = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
        if max(ratios[f"flash{i}"]) > 1.0:
            failed.append(f"flash{i}")
    for i, (B, Hq, Hkv, D, P, window, sinks, cap, qbf16) in enumerate(DECODE_COVERAGE):
        max_pages = 6
        num_pages = B * max_pages + 1
        lengths = torch.randint(1, P * max_pages + 1, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        tables = (torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages]
                  + 1).reshape(B, max_pages).to(torch.int32)
        k_pages, v_pages = torch.randint(-127, 128, (2, Hkv, num_pages, P, D), generator=g,
                                         device="cuda", dtype=torch.int8)
        k_scales, v_scales = torch.rand((2, Hkv, num_pages), generator=g, device="cuda") * 0.05
        dt = torch.bfloat16 if qbf16 else torch.float32
        q = torch.randn((B, Hq, D), generator=g, device="cuda").to(dt)
        kw = dict(sm_scale=D**-0.5, window=window, softcap=cap, sinks=sinks,
                  save_residuals=True)
        operands = (q, k_pages, v_pages, k_scales, v_scales, lengths, tables)
        kernel, args, (out, lse), _operands = dec._paged_decode_launch(*operands, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        p_out, p_lse = dec._paged_decode_plain(*operands, **kw)
        # lse: f32 on both sides, summation order only.
        lse_tol = 1e-5 + 1e-6 * torch.nan_to_num(p_lse.double().abs(), posinf=0.0)
        ratios[f"decode{i}"] = [
            err_over_tol(out, p_out, decode_tolerance(p_out, v_pages, v_scales)),
            err_over_tol(lse, p_lse, lse_tol)]
        if max(ratios[f"decode{i}"]) > 1.0:
            failed.append(f"decode{i}")
    return {"flash_cases": len(FLASH_COVERAGE), "decode_cases": len(DECODE_COVERAGE),
            "err_over_tol": ratios, "failed": failed, "ok": not failed}


# The four fused w4a16 matmuls of one Llama-3-8B decoder layer (serve_w4):
# (name, in, out), group 128, halves packing, bf16 x at the serve_w4 batches.
W4_MAIN = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gateup", 4096, 28672),
           ("w_down", 14336, 4096))
W4_BATCHES = (8, 1, 32)  # the first is the entry's headline
# Off the main path: pairs packing, f32 x, groups 32/64, R = 5, 17 and 64,
# out widths with a tail (and not a multiple of 8: byte-wise loads), a
# layer > 0 of a 3-layer stack.
#   (R, in, out, group, packing, f32 x, stacked layer or None)
W4_COVERAGE = (
    (5, 1024, 1000, 64, "pairs", False, None),
    (64, 2048, 768, 128, "halves", False, None),
    (3, 512, 333, 32, "pairs", True, None),
    (2, 768, 520, 64, "halves", True, 2),
    (1, 14336, 264, 128, "pairs", False, 1),
    (17, 256, 96, 32, "halves", False, None),
)


def _int4pack_library(x, w, golden):
    """torch._weight_int4pack_mm on the same weights in its layout (q + 8
    unsigned, [out, in/2] bytes with the even input row in the high nibble,
    bf16 scales, zero point 0; it computes (q' - 8) * s + z): (ms, its
    relative RMS error against the f32 golden, why there is no time). The
    port never calls it: it is the yardstick beside the kernel."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import unpack_weight4
    try:
        q = (unpack_weight4(w).to(torch.int32) + 8).t().contiguous()
        wpk = torch._convert_weight_to_int4pack(((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([w.scale, torch.zeros_like(w.scale)], dim=-1).to(torch.bfloat16)

        def fn():
            return torch._weight_int4pack_mm(x, wpk, w.group, sz.contiguous())
        got = fn()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError, TypeError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    rel = ((got.float() - golden).norm() / golden.norm()).item()
    return cuda_ms(fn, iters=50), rel, None


def _w4_case(x, w, layer=None, *, timed):
    """One w4_matmul case on the card: the wrapper's output (launched twice:
    the two must be bitwise equal) against the plain version and the f32
    golden; with timed, kernel / plain / library times and the bound."""
    import torch
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    from quantizedmha_tpu_torch.quant.weights import dequantize_weight4
    view = w if layer is None else w.layer(layer)
    kw = dict(group=w.group, packing=w.packing)
    out = w4.w4_matmul(x, w.packed, w.scale, layer=layer, **kw)
    again = w4.w4_matmul(x, w.packed, w.scale, layer=layer, **kw)
    torch.cuda.synchronize()
    plain = w4._w4_matmul_plain(x, view.packed, view.scale, **kw)
    golden = x.float() @ dequantize_weight4(view)
    R, in_dim = x.shape
    n = view.out_features
    ratio = err_over_tol(out, plain, w4_tolerance(x, view, plain))
    golden_ratio = err_over_tol(out, golden, w4_tolerance(x, view, golden, golden=True))
    bitwise = bool(torch.equal(out, again))
    e = {"rows": R, "in": in_dim, "out": n, "group": w.group, "packing": w.packing,
         "x": str(x.dtype), "layer": layer,
         "splits": w4.split_k(R, in_dim // 2, n)[1],
         "max_abs_err": (out.float() - plain.float()).abs().max().item(),
         "err_over_tol": ratio, "golden_err_over_tol": golden_ratio,
         "bitwise_repeat": bitwise, "ok": ratio <= 1.0 and golden_ratio <= 1.0 and bitwise}
    if timed:
        kernel, args, _, _operands = w4._w4_matmul_launch(x, view.packed, view.scale, **kw)
        e["ms"] = cuda_ms(lambda: kernel(*args), iters=50)
        # The whole wrapper (checks, allocations, ctypes call) on the host
        # clock, 50 calls and one sync: where it exceeds ms, the decode
        # step's host loop, not the kernel, sets this matmul's pace.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            w4.w4_matmul(x, w.packed, w.scale, layer=layer, **kw)
        torch.cuda.synchronize()
        e["wrapper_ms"] = (time.perf_counter() - t0) * 1e3 / 50
        e["plain_ms"] = cuda_ms(lambda: w4._w4_matmul_plain(x, view.packed, view.scale, **kw),
                                iters=3, warmup=1)
        e["nbytes"] = (view.packed.numel() + view.scale.numel() * 4
                       + (R * in_dim + R * n) * x.element_size())
        e["ops"] = {"bf16" if x.dtype == torch.bfloat16 else "fp32": 2 * R * in_dim * n}
        e["bound_ms"], e["bound_by"] = bound(e["nbytes"], e["ops"])
        e["library_ms"], e["library_rel_rms_err"], e["library_note"] = \
            _int4pack_library(x, view, golden)
    return e


def _w4_kernels(g):
    """The w4_matmul entry of the kernels line. Its ms, plain_ms, bound_ms
    and library_ms are sums over the four fused matmuls of one layer at
    R = 8 (a decode step runs them once per layer); `shapes` holds each
    matmul at R = 8, 1 and 32, `coverage` the cases off the main path."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import quantize_weight4
    shapes = []
    for name, in_dim, n in W4_MAIN:
        w = quantize_weight4(torch.randn((in_dim, n), generator=g, device="cuda") * in_dim**-0.5,
                             group=128, packing="halves")
        for R in W4_BATCHES:
            x = torch.randn((R, in_dim), generator=g, device="cuda").to(torch.bfloat16)
            shapes.append({"matmul": name, **_w4_case(x, w, timed=True)})
        del w
    coverage = []
    for R, in_dim, n, group, packing, f32, layer in W4_COVERAGE:
        shape = (in_dim, n) if layer is None else (3, in_dim, n)
        w = quantize_weight4(torch.randn(shape, generator=g, device="cuda"), group=group,
                             packing=packing)
        x = torch.randn((R, in_dim), generator=g, device="cuda")
        coverage.append(_w4_case(x if f32 else x.to(torch.bfloat16), w, layer, timed=False))
    main = [e for e in shapes if e["rows"] == W4_BATCHES[0]]
    ops = {}
    for e in main:
        for k, v in e["ops"].items():
            ops[k] = ops.get(k, 0) + v
    bms, by = bound(sum(e["nbytes"] for e in main), ops)
    lib = [e["library_ms"] for e in main]
    return {"name": "w4_matmul", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/w4_matmul.cu",
            "replaces": "quantizedmha_tpu/ops/w4_matmul.py:62",
            "also_replaces": "quantizedmha_tpu/ops/w4_matmul.py:46", "launches": None,
            "max_abs_err": max(e["max_abs_err"] for e in main),
            "err_over_tol": max(e["err_over_tol"] for e in shapes + coverage),
            "ok": all(e["ok"] for e in shapes + coverage),
            "ms": sum(e["ms"] for e in main), "plain_ms": sum(e["plain_ms"] for e in main),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None if None in lib else sum(lib),
            "library_note": next((e["library_note"] for e in main if e["library_note"]), None),
            "shapes": shapes, "coverage": coverage}


def phase_kernels(st):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    # Prefill attention of the serve path: Llama-3-8B heads, a 256 bucket,
    # bf16 activations, block_kv = min(1024, 256) (pick_blocks).
    qp = torch.randn((1, 32, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
    kp = torch.randn((1, 8, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn((1, 8, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
    # The solve path: N=8192, 32 heads of d=32, float32, block_kv 512.
    qs = torch.randn((1, 32, 8192, 32), generator=g, device="cuda")
    ks = torch.randn((1, 32, 8192, 32), generator=g, device="cuda")
    vs = torch.randn((1, 32, 8192, 32), generator=g, device="cuda")
    cases = [
        _flash_case("flash_int8_fwd[int8_p]", 0, qp, kp, vp, 256, True,
                    replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                    library=True),
        _flash_case("flash_int8_fwd[bf16_p]", 1, qs, ks, vs, 512, False,
                    replaces="quantizedmha_tpu/ops/flash_attention_int8.py:437",
                    library=True),
        _decode_case("paged_decode", 8, seed=2,
                     replaces="quantizedmha_tpu/ops/decode.py:527"),
    ]
    # The same CUDA kernel stands for the per-kv-head grid form used for
    # MQA; the serve path (8 kv heads) never gives it Hkv=1, so that shape
    # is checked and timed here and reported inside the paged_decode entry.
    mqa = _decode_case("paged_decode", 1, seed=3,
                       replaces="quantizedmha_tpu/ops/decode.py:53")
    cases[-1]["also_replaces"] = mqa["replaces"]
    cases[-1]["mqa"] = {k: mqa[k] for k in ("replaces", "max_abs_err", "err_over_tol", "ok",
                                            "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
    cases[-1]["ok"] = cases[-1]["ok"] and mqa["ok"]
    cases.append(_w4_kernels(g))
    st["kernels"] = {c["name"]: c for c in cases}
    ok = all(c["ok"] for c in cases)
    emit({"phase": "kernels", "ok": ok, "kernels": cases})
    # Off the main paths second, so that a failing kernel reports its
    # main-path errors as well.
    coverage = _coverage()
    emit({"phase": "kernels_coverage", **coverage})
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")
    if not coverage["ok"]:
        raise AssertionError("a kernel disagrees with its plain version off the main paths")


def phase_solve(st):
    import torch
    from quantizedmha_tpu_torch import solve
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    N, d_model, h = 8192, 1024, 32
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn((N, d_model), generator=g, device="cuda") for _ in range(3))
    for kern in (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P):
        kern.reset()
    out = solve(q, k, v, d_model, h, kernel="fa_int8")
    torch.cuda.synchronize()
    launches = {"flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches,
                "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches}
    st["launches"].update({"flash_int8_fwd[bf16_p]": launches["flash_int8_fwd[bf16_p]"]})
    ms = cuda_ms(lambda: solve(q, k, v, d_model, h, kernel="fa_int8"), iters=10)
    # Random inputs: the int8 Q/K/V quantization error against the float
    # golden, as the RMS of the error over the RMS of the golden. Each
    # quantizer's step is 1/127 of its block's max|x| (about 1% of the RMS of
    # a normal block), and the plain int8 version lands at 1.4% on these
    # inputs at N=2048, so the limit is 3%: a fault that is off by a few per
    # cent across the output (a wrong V scale, say) exceeds it, while the
    # per-element check against the plain version (kernels phase) holds
    # the kernel itself far tighter.
    ref = solve(q, k, v, d_model, h, kernel="reference")
    rel_rms = ((out - ref).norm() / ref.norm()).item()
    max_abs = (out - ref).abs().max().item()
    finite = bool(torch.isfinite(out).all().item())
    ones = torch.ones((N, d_model), device="cuda")
    const_dev = (solve(ones, ones, ones, d_model, h, kernel="fa_int8") - 1.0).abs().max().item()
    ok = (launches["flash_int8_fwd[bf16_p]"] == 1 and finite and rel_rms <= SOLVE_REL_RMS_TOL
          and tuple(out.shape) == (N, d_model) and const_dev <= 1e-6)
    emit({"phase": "solve", "ok": ok, "ms": ms, "launches": launches,
          "rel_rms_err_vs_reference": rel_rms, "rel_rms_tol": SOLVE_REL_RMS_TOL,
          "max_abs_err_vs_reference": max_abs, "ref_rms": (ref.norm() / N**0.5 / d_model**0.5).item(),
          "ones_max_dev": const_dev, "ones_tol": 1e-6,
          "reference_l4_ms": REFERENCE_L4_MS})
    if not ok:
        raise AssertionError("solve(fa_int8) failed its checks")


def phase_serve(st):
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.quant.weights import quantize_llama_params, weight_bytes
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_llama_params(llama.init_params(cfg, gen, device="cuda"), bits=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    wbytes = weight_bytes(params)

    batch, prompt_len, max_new, chunk, page = 8, 256, 32, 8, 128
    mpps = -(-(prompt_len + max_new + chunk + 1) // page)
    ecfg = EngineConfig(num_pages=batch * mpps + 2, page_size=page, max_batch=batch,
                        max_pages_per_seq=mpps, prefill_buckets=(prompt_len,),
                        max_new_tokens=max_new, decode_chunk=chunk)
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist() for _ in range(batch)]
    # A warm-up request outside the measured run (first cuBLAS/kernel use).
    eng.add_request(prompts[0][:100], max_new=chunk + 1)
    eng.run()
    eng.finished.clear()

    kernels = (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P, dec.PAGED_DECODE)
    for kern in kernels:
        kern.reset()
    admitted0 = eng.metrics.counter("requests_admitted")
    steps0 = eng.metrics.counter("decode_steps")
    rids = [eng.add_request(p, max_new=max_new) for p in prompts]
    t0 = time.perf_counter()
    eng.step()  # 8 admissions (prefills) + the first fused chunk
    first_step_s = time.perf_counter() - t0
    toks0 = eng.metrics.counter("tokens_generated")
    sd0 = eng.metrics.counter("decode_steps")
    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    toks = eng.metrics.counter("tokens_generated") - toks0
    steps = eng.metrics.counter("decode_steps") - sd0

    # Warm TTFT: one fresh request on the drained engine, admission to its
    # first decoded token (prefill + one fused chunk + host turnaround).
    before = eng.metrics.counter("tokens_generated")
    t1 = time.perf_counter()
    eng.add_request(prompts[1], max_new=max_new)
    while eng.metrics.counter("tokens_generated") == before and (eng.queue or eng.active):
        eng.step()
    ttft = time.perf_counter() - t1
    eng.run()
    launches = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches,
                "paged_decode": dec.PAGED_DECODE.launches}
    admitted = eng.metrics.counter("requests_admitted") - admitted0
    decode_steps = eng.metrics.counter("decode_steps") - steps0
    st["launches"].update({"flash_int8_fwd[int8_p]": launches["flash_int8_fwd[int8_p]"],
                           "paged_decode": launches["paged_decode"]})

    lens_ok = all(len(results.get(r, [])) == max_new for r in rids)
    in_vocab = all(0 <= t < cfg.vocab_size for r in rids for t in results.get(r, []))
    want = {"flash_int8_fwd[int8_p]": cfg.num_layers * admitted,
            "paged_decode": cfg.num_layers * decode_steps}
    counts_ok = (launches["flash_int8_fwd[int8_p]"] == want["flash_int8_fwd[int8_p]"]
                 and launches["paged_decode"] == want["paged_decode"]
                 and launches["flash_int8_fwd[bf16_p]"] == 0)

    # Right by the repo's own means: the int8 prefill's last-token logits
    # against the same model with the plain float attention golden
    # (attention_impl="reference"), as the JAX package's engine tests do.
    toks_t = torch.tensor([prompts[2]], dtype=torch.int32, device="cuda")
    logits, _, _ = llama_adapter.prefill_at(cfg, params, toks_t, prompt_len - 1)
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    ref = llama.forward(ref_cfg, params, toks_t)[:, -1]
    finite = bool(torch.isfinite(logits).all().item())
    rel = ((logits - ref).abs().max() / ref.std()).item()
    ok = (lens_ok and in_vocab and counts_ok and not eng.failed and finite
          and rel <= 0.25)
    if st.get("profile"):
        emit({"phase": "serve_profile", **_profile_decode_chunk(eng, prompts, max_new)})
    emit({"phase": "serve", "ok": ok, "model": "llama3_8b", "layers": cfg.num_layers,
          "weights_gb": wbytes / 1e9, "init_s": init_s,
          "requests": batch, "prompt_len": prompt_len, "max_new": max_new,
          "decode_chunk": chunk, "tokens_each": sorted({len(results.get(r, [])) for r in rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "first_step_s": first_step_s, "ttft_warm_s": ttft,
          "decode_tok_s": toks / dt, "decode_ms_per_step": dt * 1e3 / max(steps, 1),
          "measured_tokens": toks, "prefill_logits_rel_err_vs_reference": rel,
          "rel_err_tol": 0.25, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve phase failed its checks")


def _dequantized(params, dtype):
    """params with every QuantizedWeight4 layer stack replaced by its
    dequantized weights as plain `dtype` tensors, one layer at a time."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import QuantizedWeight4, dequantize_weight4
    layers = {}
    for k, v in params["layers"].items():
        if isinstance(v, QuantizedWeight4):
            plain = torch.empty(v.shape, dtype=dtype, device=v.packed.device)
            for i in range(plain.shape[0]):
                plain[i] = dequantize_weight4(v.layer(i)).to(dtype)
            v = plain
        layers[k] = v
    return dict(params, layers=layers)


W4_SERVE = dict(prompt_len=512, max_new=64, chunk=16)  # the JAX bench's defaults
W4_PEAK_HEADROOM_GB = 2.0  # activations and prefill dequant transients


def phase_serve_w4(st):
    """w4a16 serving of "llama3-8b-shape-int4-lmh8" through the benchmark's
    run_decode_bench at batch 1, 8 and 32."""
    import torch
    from quantizedmha_tpu_torch.harness import serving_bench
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    from quantizedmha_tpu_torch.quant.weights import (
        fuse_w4_projections,
        quantize_llama_params,
        weight_bytes,
    )
    from quantizedmha_tpu_torch.serving import llama_adapter

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_llama_params(llama.init_params(cfg, gen, device="cuda"), bits=4,
                                   group=128, packing="halves", lm_head_bits=8)
    params = dict(params, layers=fuse_w4_projections(params["layers"]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    wbytes = weight_bytes(params)

    # A 64-token prefill (R = 64: the kernel's side of _W4_DECODE_ROWS)
    # against the same model with the dequantized weights as plain bf16
    # tensors: the same weights, summed in another order.
    toks = torch.randint(1, cfg.vocab_size, (1, 64), generator=gen, device="cuda",
                         dtype=torch.int32)
    w4.W4_MATMUL.reset()
    logits, _, _ = llama_adapter.prefill_at(cfg, params, toks, 63)
    prefill_launches = w4.W4_MATMUL.launches
    plain = _dequantized(params, cfg.dtype)
    ref = llama.forward(cfg, plain, toks)[:, -1]
    del plain
    torch.cuda.empty_cache()
    rel = ((logits - ref).abs().max() / ref.std()).item()
    finite = bool(torch.isfinite(logits).all().item())

    kernels = {"w4_matmul": w4.W4_MATMUL, "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P, "paged_decode": dec.PAGED_DECODE}
    rows, ok = [], finite and rel <= 0.25 and prefill_launches == 4 * L
    for batch in (1, 8, 32):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for kern in kernels.values():
            kern.reset()
        row = serving_bench.run_decode_bench(cfg, params, batch=batch, **W4_SERVE)
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items()}
        steps = row["decode_steps"]
        want = {"w4_matmul": 4 * L * steps, "flash_int8_fwd[int8_p]": L * (batch + 1),
                "flash_int8_fwd[bf16_p]": 0, "paged_decode": L * steps}
        mpps = -(-(W4_SERVE["prompt_len"] + W4_SERVE["max_new"] + W4_SERVE["chunk"] + 1) // 128)
        cache_gb = (batch * mpps + 2) * L * 2 * cfg.num_kv_heads * (128 * cfg.hd + 4) / 1e9
        extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        row.update(launches=launches, launches_expected=want, cache_gb=cache_gb,
                   peak_extra_gb=extra_gb,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        row_ok = (launches == want and row["requests_failed"] == 0
                  and row["tokens_per_request"] == [W4_SERVE["max_new"]]
                  and extra_gb <= cache_gb + W4_PEAK_HEADROOM_GB)
        row["ok"] = row_ok
        ok = ok and row_ok
        rows.append(row)
        for name, n in launches.items():
            st["launches"][name] = st["launches"].get(name, 0) + n
    if st.get("profile"):
        emit({"phase": "serve_w4_profile", **_profile_w4(cfg, params)})
    emit({"phase": "serve_w4", "ok": ok, "model": "llama3-8b-shape-int4-lmh8",
          "layers": L, "weights_gb": wbytes / 1e9, "init_s": init_s,
          "prefill64_w4_launches": prefill_launches,
          "prefill64_logits_rel_err_vs_bf16_dequant": rel, "rel_err_tol": 0.25,
          "peak_headroom_gb": W4_PEAK_HEADROOM_GB, "sweep": rows})
    if not ok:
        raise AssertionError("serve_w4 phase failed its checks")


def _profile_w4(cfg, params):
    """Profiled full-batch decode chunks of the w4 model at batch 8."""
    import numpy as np
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    batch, page, new = 8, 128, 4 * W4_SERVE["chunk"]
    mpps = -(-(W4_SERVE["prompt_len"] + new + W4_SERVE["chunk"] + 1) // page)
    ecfg = EngineConfig(num_pages=batch * mpps + 2, page_size=page, max_batch=batch,
                        max_pages_per_seq=mpps, prefill_buckets=(W4_SERVE["prompt_len"],),
                        max_new_tokens=new, decode_chunk=W4_SERVE["chunk"])
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, W4_SERVE["prompt_len"]).tolist()
               for _ in range(batch)]
    return _profile_decode_chunk(eng, prompts, new)


def _host_profile(eng, steps):
    """One engine step under cProfile: the host's time a decode step by
    function. `own` ranks own time (a C call such as a torch op is its own
    entry; a ctypes launch counts in its caller), `port` the port's
    functions by cumulative time with their calls a step, `c_share` the
    share of own time spent in C calls. cProfile slows every Python
    call, so its shares, not its times, carry over to an untraced step."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    eng.step()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    total = sum(v[2] for v in stats.values())

    def row(f, v, t):
        fn = f[2] if f[0] == "~" else f"{os.path.basename(f[0])}:{f[1]}({f[2]})"
        return {"fn": fn[:90], "calls": v[1] / steps, "ms": t * 1e3 / steps,
                "share": t / total, "us_per_call": t * 1e6 / max(v[1], 1)}
    own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:16]
    port = sorted(((f, v) for f, v in stats.items() if "quantizedmha_tpu_torch" in f[0]),
                  key=lambda kv: -kv[1][3])[:16]
    return {"wall_ms_per_step": wall * 1e3 / steps, "own_ms_per_step": total * 1e3 / steps,
            "c_share": sum(v[2] for f, v in stats.items() if f[0] == "~") / total,
            "own": [row(f, v, v[2]) for f, v in own],
            "port": [row(f, v, v[3]) for f, v in port]}


def _profile_decode_chunk(eng, prompts, max_new):
    """Where a full-batch decode chunk's time goes. One engine step
    (decode_chunk steps, one host sync) runs untraced, the next under
    torch.profiler, a third under cProfile (`host`); the first two are
    timed on the host clock and with CUDA events. The device kernels of
    the traced window are grouped by name, and its idle share is 1 -
    their busy time / that same window's CUDA-event time (tracing slows
    the host, so this share is an upper bound; the untraced window's
    times stand beside it). Needs four chunks of max_new."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.add_request(p, max_new=max_new)
    eng.step()  # admissions + the first chunk, outside both windows

    def window():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        eng.step()
        end.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, start.elapsed_time(end) / 1e3

    untraced_wall, untraced_events = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall, traced_events = window()
    steps = eng.ecfg.decode_chunk
    host = _host_profile(eng, steps)
    eng.run()
    groups = (("w4_matmul", ("w4_matmul_kernel", "w4_reduce_kernel")),
              ("flash_int8_fwd", "flash_int8"), ("paged_decode", "paged_decode"),
              ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
              ("direct_copy (dtype casts)", "direct_copy"))
    by_name, by_group = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us, n + 1)
        group = next((g for g, keys in groups
                      if any(k in e.name for k in ((keys,) if isinstance(keys, str) else keys))),
                     "other")
        t, n = by_group.get(group, (0.0, 0))
        by_group[group] = (t + us, n + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"chunk_steps": steps,
            "untraced_wall_ms_per_step": untraced_wall * 1e3 / steps,
            "untraced_events_ms_per_step": untraced_events * 1e3 / steps,
            "traced_wall_ms_per_step": traced_wall * 1e3 / steps,
            "traced_events_ms_per_step": traced_events * 1e3 / steps,
            "device_busy_ms_per_step": busy_s * 1e3 / steps,
            "device_idle_share_traced": 1.0 - busy_s / traced_events,
            "groups_per_step": {g: {"ms": t / 1e3 / steps, "launches": n / steps}
                                for g, (t, n) in sorted(by_group.items(),
                                                        key=lambda kv: -kv[1][0])},
            "top_kernels_per_step": [{"kernel": k[:80], "ms": t / 1e3 / steps,
                                      "launches": n / steps} for k, (t, n) in top],
            "host": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also trace one full-batch decode chunk of the serve "
                         "and serve_w4 phases with torch.profiler")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # The package under test is the one beside this script, never a copy
    # installed elsewhere.
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "quantizedmha_tpu_torch", "__init__.py")):
        print("chip_smoke: the port package is missing beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import quantizedmha_tpu_torch  # noqa: F401
    if "build" not in phases:
        phases.insert(0, "build")
    st = {"launches": {}, "profile": args.profile}
    for name in PHASES:
        if name not in phases:
            continue
        try:
            globals()[f"phase_{name}"](st)
        except Exception:
            traceback.print_exc()
            emit({"phase": name, "ok": False})
            return 1
    if "kernels" in st:
        entries = []
        for name, c in st["kernels"].items():
            e = {k: c[k] for k in ("name", "route", "source", "replaces", "max_abs_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            e.update({k: c[k] for k in ("also_replaces", "mqa", "library_note") if k in c})
            if "shapes" in c:
                e["shapes"] = [{k: s[k] for k in ("matmul", "rows", "ms", "wrapper_ms", "plain_ms",
                                                  "bound_ms", "library_ms")} for s in c["shapes"]]
            e["launches"] = st["launches"].get(name, 0)
            entries.append(e)
        emit({"kernels": entries})
        idle = [e["name"] for e in entries if e["launches"] == 0]
        if {"solve", "serve", "serve_w4"} <= set(phases) and idle:
            print(f"chip_smoke: kernels never launched on a main path: {idle}",
                  file=sys.stderr)
            return 1
    print(st["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
