#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quantizedmha_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

  build    compile every CUDA source under quantizedmha_tpu_torch/csrc/
           (one nvcc each, in parallel) and report the card, each kernel's
           registers and spills and each source's serialized wgmma
           (flash_int8_bf16p, flash_int8_int8p: the INT8 flash bf16-P and
           int8-P kernels').
  kernels  hold each kernel against its plain PyTorch version on the card
           at the main paths' shapes, every element within its stated
           tolerance (err_over_tol <= 1), then on small cases off the main
           paths and on the two mixed-cache compositions (INT8 and INT4
           partials merged by lse) against their plain compositions; the
           backward's two kernels at the training step's attention shape
           and on 11 small cases, each pair launched twice (the same bits
           both times, or the check fails), and so is every INT8 flash
           launch (both numerics modes at their main shapes, the int8-P
           one at serve's 256-token, serve_w4's 512-token and the prefill
           bench's 2048-token prefill, and
           every FLASH_COVERAGE case), every float flash launch (the
           f32 route's split planes filled with NaN before its first,
           so that a plane element left unwritten shows; its own
           coverage cases and FLASH_FWD_PIECES, built so that a dropped
           third bf16 piece shows), every bf16 paged prefill launch (INT8 and INT4,
           tensor cores), every paged decode launch (INT8 and INT4:
           split page walks merged by lse) and every w4_matmul launch
           (the four fused 8B matmuls at R = 8, 1, 32 and 64),
           the decode at serve's, serve_flash's and serve_mixed's shapes
           and for MQA, each reporting its splits;
           kernel / plain / library times (CUDA events) and the least time
           the card could take (bound).
  solve    the reference ABI at N=8192, d_model=1024, h=32 in float32:
           solve(kernel="fa_int8"), then the float rungs "fa", "fa_bf16"
           and "unfused": time, relative RMS error against the float
           golden with each rung's limit, and the constant-input gate
           (all-ones -> exactly 1.0).
  harness  the reference driver, `harness.cli.run(["--kernel", "all",
           ...])` at the same workload with a temporary cache and JSON
           report: every rung checked against the float golden, then
           timed by CUDA events. Gates: rc 0, no rung error, every check
           passing, every timed rung's ms > 0, the exact launches of each
           rung's kernel, every share of the speed of light <= 100%, and
           each rung's ms within 0.8-1.25x of the solve phase's (two timers
           of the same work). Runs after solve (--phases adds it).
  serve    Llama-3-8B width and depth (32 layers), random INT8 (w8a16)
           weights with a bf16 lm_head, flash_int8 prefill and paged INT8
           decode through the continuous-batching engine: 8 requests of
           256-token prompts, 32 new tokens each, greedy. Then the serving
           benchmark's prefill (harness/serving_bench.run_prefill_bench):
           2048 random tokens through prefill_at, its ms, TFLOP/s and share
           of the tensor cores' bf16 speed of light (<= 100%), every layer's
           attention through the int8-P kernel (exact launches).
  serve_w4 "llama3-8b-shape-int4-lmh8": the same model's random weights
           quantized to INT4 (group 128, halves packing, wq|wk|wv and
           w_gate|w_up fused) with an int8 lm_head, served by the serving
           benchmark (harness/serving_bench.run_decode_bench) at batch 1,
           8 and 32: 512-token prompts, 64 new tokens each, decode chunk
           16. Every decode matmul goes through the w4_matmul kernel
           (exactly 4 launches a layer a decode step; 512-row prefills
           take the dequantize-then-matmul lowering). A 64-token prefill
           is held against the dequantized weights as plain bf16 tensors.
           With --profile, full-batch decode chunks at batch 8 and 32 run
           under torch.profiler.
  serve_flash  Llama-3-8B as configured (attention_impl="flash", random
           bf16 weights, 32 layers) through the engine with the default
           buckets (128-2048), page 128, prefix caching and interleaved
           prefill: prompts of 256, 700, 1500 and 2000 tokens (float flash
           prefill), 5000 and 7900 (chunked prefill through the paged INT8
           cache, one chunk per engine step), then two prompts sharing the
           7900-token prompt's first 4096 tokens (prefix hits: only their
           suffixes prefill); 32 new tokens each, greedy. Then eight fresh
           2000-token prompts, 72 new tokens each: the engine steps that
           decode all eight for a whole chunk time decode at batch 8.
           Gates: exact launch counts, 2 hits reusing 8192 tokens, the
           2000-token and the chunked 5000-token prefills' last logits
           within 0.25 std of the float attention golden.
  serve_mixed  the same model served from the mixed INT8-sink / INT4-bulk
           paged cache (mixed_kv: boundary 256, 32 INT8 and 512 INT4 pages,
           4 scale sub-tiles a page): prompts of 240, 1000 and 2000 tokens
           (bucketed, written 2 INT8 pages + the rest INT4; the 240-token
           one crosses the boundary while it decodes), 5000 and 7900
           (chunked and interleaved: every chunk runs the INT8 and the INT4
           paged prefill), 32 new tokens each; then eight 2000-token
           prompts, 72 new tokens each, time decode at batch 8 (every step
           runs the INT8 and the INT4 paged decode). Gates: exact launch
           counts, every token, both pools drained, the 5000-token prompt's
           last logits through a fresh mixed cache within 0.25 std of the
           golden whose float attention reads K/V through the same INT8 /
           INT4 quantization; their distance from the float golden, and the
           plain INT8 cache's, printed beside it.
  train    sgd_train_step of LlamaConfig.llama3_8b() as configured (bf16,
           attention_impl="flash", 32 layers, random weights from seed 0)
           on one batch of 2048 random tokens, 4 steps at lr 0.5: every
           forward through the float flash kernel, every backward through
           the dK/dV and dQ kernels of flash_bwd.cu. Gates: exactly 32
           launches a step of each, finite loss and weights, step 0's loss
           equal to loss_fn without grad, the loss falling every step; then
           at the same width cut to 2 layers, every leaf's gradient of one
           step within 2^-4 of its largest entry of the same step through
           the float golden (attention_impl="reference"). Prints the losses,
           ms a step, tokens/s, the share of weights changed, peak memory.
  faults   each line of PLANTED_FAULTS planted in a copy of csrc/, the
           kernel sources that the changed file is part of (flash_fwd.cu,
           paged_prefill.cu, paged_decode.cu, flash_bwd.cu, w4_matmul.cu,
           flash_int8_fwd.cu, their shared f32_tile.cuh, int4.cuh and
           wgmma_s8.cuh) built in parallel and
           bound in turn in place of the committed kernels, their checks
           rerun: every fault must fail them.

Launch counts: every kernel wrapper counts its launches; the counts are
zeroed just before each main path (each solve rung, the harness run,
serve, serve's prefill bench, each serve_w4 batch, serve_flash,
serve_mixed, train's steps) runs and read just after,
and a kernel of that path that never launched fails the run. The last
lines are the kernels summary, the card's name and power limit, and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

REFERENCE_L4_MS = 7.70  # the reference study's fa_tc_int8_b on an NVIDIA L4
SOLVE_REL_RMS_TOL = 0.03  # int8 solve vs the float golden (phase_solve)
PREFILL_BENCH_LEN = 2048  # serving_bench --prefill's prompt (phase_serve)

PHASES = ("build", "kernels", "solve", "harness", "serve", "serve_w4", "serve_flash",
          "serve_mixed", "train", "faults")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    from quantizedmha_tpu_torch.profiling.device_info import power_limit
    line = power_limit(0)
    if line is None:
        raise RuntimeError("nvidia-smi reported no name and power limit")
    return line


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
    unit's operations time (int8 and bf16 products share the tensor cores;
    fp32 is the CUDA cores' float32; exp the SFUs'), at the card's peaks in
    profiling/roofline.py's CHIP_SPECS (an unknown card raises)."""
    from quantizedmha_tpu_torch.profiling.roofline import detect_chip
    spec = detect_chip()
    t_bytes = nbytes / (spec.hbm_gbps * 1e9)
    t_ops = max(ops.get("int8", 0) / (spec.int8_tops * 1e12)
                + ops.get("bf16", 0) / (spec.bf16_tflops * 1e12),
                ops.get("fp32", 0) / (spec.cuda_core_tflops * 1e12),
                ops.get("exp", 0) / spec.exp_per_s)
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


def score_err(q_norm, k_norm, D):
    """Bound of the f32 summation-order difference of one score q·k between
    two orders (the kernel's, the plain version's): (D + 16) ulps of the
    Cauchy-Schwarz bound |q|·|k| on the sum of |q_i k_i|."""
    return (D + 16) * 2.0**-24 * q_norm * k_norm


def flash_fwd_tolerances(q, k, v, o_plain, lse_plain, w_abs, *, sm_scale, softcap):
    """Per-element tolerances of the float flash kernel's output and lse
    against its plain version on the same inputs (lse_plain: the plain
    version's lse, which the f32 terms read).

    bf16. Scores: the two sum Q·K in other orders (the kernel's tensor-core
    order, the plain version's matmul), by at most ds per row (score_err
    over the row's scaled |q| and its kv head's largest |k|; softcap's tanh
    adds ulps of the cap). A score moved by ds moves the row's output by at
    most 4 ds max|v|. P·V and l: f32 summation order, 1e-5 of max|v|. The
    kernel rounds P to bf16 against its running max after each 64-key
    tile, the plain version after each block_kv keys. Each rounding is off
    by at most half an ulp, 2^-8 |p|, so the two rounded P of one key
    differ by at most 2^-7 |p|, and the outputs by at most 2^-7 of sum_j
    p_j |v_j| / l, w_abs (the plain version's output on |v|). A bf16 output
    adds one bf16 ulp (2^-7 |o|). lse: ds + 1e-5 (l's order) + f32 rounding
    of m + log l. The kernel takes each p as 2^(x·log2 e − m·log2 e) on the
    SFU: ex2.approx is within ~2^-22 relative, and the argument's rounding
    moves p by at most |m|·2^-24 relative: under the 1e-5 terms of P·V and
    l while |m| < 100, and under the 1e-6·|lse| term of lse beyond (lse is
    within log Skv of m).

    f32 (six bf16 products a product, u = 2^-24). Scores: the plain
    version's f32 sum over D moves a score by at most D·u of sum_i |q_i
    k_i|; the kernel's products leave out a1b2 + a2b1 + a2b2, at most
    1.02·u·|q_i||k_i| each, and its tensor cores round each k16 step of the
    large product by at most 2 ulps of the sum (D/16 steps: D/8·u; the five
    small products' steps are 2^-7 of that): ds = (9D/8 + 2)·u·|q|·max|k|
    (Cauchy-Schwarz). Scores moved by at most ds move each weight p_j / l by
    a factor within exp(±2 ds), so the output by at most expm1(2 ds)·w_abs.
    P·V and l, as a share c of w_abs: the f32 order of acc and l, 2^-20
    (the kernel adds each tile's P·V, summed from zero on the tensor cores,
    to acc on the CUDA cores); ex2.approx against exp, 2^-22; the argument
    m·log2 e rounded, |m|·2^-24·log2 e, with |m| <= |lse| + log Skv; the
    P·V products left out and o's rounding, 2^-23. lse: ds + c + 2^-22 of
    |lse| + log Skv (m + log l rounded, log's ulps). A P or V whose third
    piece is dropped (up to 2^-17 of each p or v) misses c on rows of few
    keys and small scores; a Q or K whose third piece is dropped moves
    large aligned scores by up to 2^-17 of |q||k|, past ds + 2^-22|lse|
    in lse (FLASH_FWD_PIECES)."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import scaled_q
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    qn = scaled_q(q, sm_scale).double().norm(dim=-1)                        # [B, H, Sq]
    kn = k.double().norm(dim=-1).amax(dim=-1).repeat_interleave(group, dim=1)  # [B, H]
    if q.dtype == torch.float32:
        u = 2.0**-24
        ds = (9 * D / 8 + 2) * u * qn * kn[..., None]
        if softcap is not None:
            ds = ds + 2.0**-22 * softcap
        log_skv = math.log(max(k.shape[2], 1))
        lse_abs = torch.nan_to_num(lse_plain.double().abs(), posinf=0.0)
        c = 2.0**-20 + 2.0**-22 + u * 1.4426950408889634 * (lse_abs + log_skv) + 2.0**-23
        tol_o = (torch.expm1(2.0 * ds) + c)[..., None] * w_abs.double()
        return tol_o, ds + c + 2.0**-22 * (lse_abs + log_skv)
    vmax = v.double().abs().amax(dim=(-2, -1)).repeat_interleave(group, dim=1)
    ds = score_err(qn, kn[..., None], D)
    if softcap is not None:
        ds = ds + 2.0**-22 * softcap
    tol_o = (4.0 * ds + 1e-5)[..., None] * vmax[:, :, None, None]
    tol_o = tol_o + 2.0**-7 * w_abs.double()
    tol_o = tol_o + 2.0**-7 * (o_plain.double().abs() + tol_o)
    tol_lse = ds + 1e-5 + 1e-6 * torch.nan_to_num(lse_plain.double().abs(), posinf=0.0)
    return tol_o, tol_lse


def attention_tolerances(q, kn, vmax, o_plain, lse_plain, *, sm_scale, softcap, w_abs=None):
    """Per-element tolerances of a paged kernel (decode, q [B, Hq, D], or
    prefill, q [B, Hq, C, D]) against its plain version on the same pages.
    Scores: both sum q·k exactly-rounded products in f32 in other orders,
    by at most ds per row (score_err over |q·sm_scale| and kn, the kv head's
    largest dequantized |k|), moving the output by at most 4 ds max|v|; P·V
    and l by 1e-5 of vmax (the kv head's largest dequantized |v|). The bf16
    paged prefill (w_abs given) also rounds each p · v_scale[key] to bf16
    once before P·V, a relative error of at most 2^-8 (round to nearest
    even, 8 significant bits), which moves an output element by at most
    2^-8 of sum_j p_j |v_j| v_scale_j / l: w_abs, the plain walk's output
    on |V| (prefill_w_abs); l sums the unrounded p, so lse keeps its bound.
    A bf16 output adds one ulp. lse: ds + 1e-5 + f32 rounding of m + log l."""
    import torch
    D = q.shape[-1]
    group = q.shape[1] // kn.shape[0]
    shape = (1, -1) + (1,) * (q.dim() - 3)
    qn = (q.double() * sm_scale).norm(dim=-1)                                 # [B, Hq(, C)]
    kn, vmax = (x.double().repeat_interleave(group).reshape(shape) for x in (kn, vmax))
    ds = score_err(qn, kn, D)
    if softcap is not None:
        ds = ds + 2.0**-22 * softcap
    tol_o = ((4.0 * ds + 1e-5) * vmax)[..., None]
    if w_abs is not None:
        tol_o = tol_o + 2.0**-8 * w_abs.double()
    if o_plain.dtype == torch.bfloat16:
        tol_o = tol_o + 2.0**-7 * (o_plain.double().abs() + tol_o)
    tol_lse = ds + 1e-5 + 1e-6 * torch.nan_to_num(lse_plain.double().abs(), posinf=0.0)
    return tol_o, tol_lse


def paged_prefill_tolerances(q, k_pages, v_pages, k_scales, v_scales, o_plain, lse_plain,
                             *, sm_scale, softcap, w_abs=None):
    """attention_tolerances over int8 pages with one scale per (head, page)."""
    kn = (k_pages.double().norm(dim=-1) * k_scales.double()[..., None]).flatten(1).amax(dim=1)
    vmax = (v_pages.double().abs().amax(dim=-1) * v_scales.double()[..., None]).flatten(1).amax(dim=1)
    return attention_tolerances(q, kn, vmax, o_plain, lse_plain, sm_scale=sm_scale,
                                softcap=softcap, w_abs=w_abs)


def int4_tolerances(q, k_pages, v_pages, k_scales, v_scales, o_plain, lse_plain,
                    *, sm_scale, softcap, w_abs=None):
    """attention_tolerances over nibble-packed pages with per-sub-tile
    scales [Hkv, num_pages, subs]."""
    from quantizedmha_tpu_torch.ops.quantize import unpack_int4_halves

    def rows(pages, scales):  # dequantized rows, one kv head at a time: [n, P, D]
        sub = pages.shape[2] // scales.shape[-1]
        for h in range(pages.shape[0]):
            x = torch.cat(unpack_int4_halves(pages[h]), dim=-1).double()
            yield x * scales[h].double().repeat_interleave(sub, dim=-1)[..., None]
    import torch
    kn = torch.stack([r.norm(dim=-1).max() for r in rows(k_pages, k_scales)])
    vmax = torch.stack([r.abs().max() for r in rows(v_pages, v_scales)])
    return attention_tolerances(q, kn, vmax, o_plain, lse_plain, sm_scale=sm_scale,
                                softcap=softcap, w_abs=w_abs)


def prefill_w_abs(q, cache, lengths, q_starts, tables, *, int4=False, sm_scale, window,
                  softcap, sinks, **_):
    """w_abs of the bf16-P term (attention_tolerances): the plain page walk
    (ops/paged_prefill._prefill_walk, q in f32) with |v · v_scale| in place
    of V, taken after unpacking for INT4 pages; None for f32 q, whose kernel
    keeps P in f32."""
    import torch
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.ops.decode import _int4_page
    if q.dtype != torch.bfloat16:
        return None
    k_pages, v_pages, k_scales, v_scales = cache
    heads = torch.arange(k_pages.shape[0], device=q.device)

    def load(page):
        if int4:
            kp, ks = _int4_page(k_pages, k_scales, heads, page)
            vp, vs = _int4_page(v_pages, v_scales, heads, page)
            return kp, ks, lambda p: (p * vs.abs()) @ vp.abs()
        kp = k_pages[:, page].float().transpose(0, 1)                 # [B, Hkv, P, D]
        vp = v_pages[:, page].float().abs().transpose(0, 1)
        ks = k_scales[heads[None, :], page[:, None]][..., None, None]  # [B, Hkv, 1, 1]
        vs = v_scales[heads[None, :], page[:, None]][..., None, None].abs()
        return kp, ks, lambda p: (p @ vp) * vs
    return pp._prefill_walk(q.float(), k_pages.shape[0], lengths, q_starts, tables,
                            k_pages.shape[2], load, sm_scale=sm_scale, window=window,
                            softcap=softcap, sinks=sinks, save_residuals=False)


def merge_tolerance(o, lse_parts, o_parts, tols, lse_tols):
    """Tolerance of a merged output (parallel/combine.merge_two_partials)
    from its two partials' tolerances: o = w_a o_a + w_b o_b with w = exp(
    lse_part - lse), taken from the plain partials. A partial's output
    error moves o by w times it; its lse error moves o by at most w_a w_b
    |o_a - o_b| per unit; the merged bf16 output adds one ulp of |o|."""
    import torch
    (la, lb), (oa, ob) = lse_parts, o_parts
    lse = torch.logaddexp(la.double(), lb.double())
    fin = torch.isfinite(lse)
    wa, wb = (torch.where(fin & torch.isfinite(x), torch.exp(x.double() - lse),
                          torch.zeros_like(lse))[..., None] for x in (la, lb))
    d_lse = (torch.where(torch.isfinite(la), lse_tols[0], 0.0)
             + torch.where(torch.isfinite(lb), lse_tols[1], 0.0))[..., None]
    tol = (wa * tols[0] + wb * tols[1]
           + wa * wb * (oa.double() - ob.double()).abs() * d_lse)
    if o.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * (o.double().abs() + tol)
    return tol


def _sdpa(q, k, v, **kw):
    """(ms, backend) of one F.scaled_dot_product_attention call on these
    inputs: the first of flash, memory-efficient, cuDNN and math attention
    that takes them. The port never calls it: it is the yardstick."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                sdpa(q, k, v, **kw)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            return cuda_ms(lambda: sdpa(q, k, v, **kw), iters=10), backend.name
    return None, None


# ---------------------------------------------------------------------------


def _ptxas_kernels(log):
    """{kernel<template args>: [registers, spill store bytes]} from one
    `nvcc -Xptxas -v` log."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores", entry)
        mangled = entry.split("'")[1] if "'" in entry else ""
        # _ZN <length><identifier>... (namespaces, then the kernel) I<args>E
        pos, name = 3, ""
        while pos < len(mangled) and mangled[pos].isdigit():
            m = re.match(r"\d+", mangled[pos:])
            pos += len(m.group())
            name = mangled[pos:pos + int(m.group())]
            pos += len(name)
        if name and regs and spills:
            args = ",".join(re.findall(r"L[ib](\d+)E", mangled[pos:].split("EE")[0] + "E"))
            out[f"{name}<{args}>"] = [int(regs.group(1)), int(spills.group(1))]
    return out


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
                      "max_spill_store_bytes": max(spills, default=None),
                      "kernels": _ptxas_kernels(log),
                      # ptxas C7514: wgmma serialized (a register hazard in the pipeline)
                      "wgmma_serialized": len(re.findall(r"C7514", log))}
    st["gpu"] = gpu_line()
    # The INT8 flash kernels (bf16 P, int8 P) at each head dim and q dtype:
    # [registers, spill store bytes], and the serialized wgmma of their source.
    fa8 = regs.get("flash_int8_fwd", {})
    bf16p, int8p = ({"kernels": {k: x for k, x in fa8.get("kernels", {}).items()
                                 if k.startswith(name)},
                     "wgmma_serialized": fa8.get("wgmma_serialized")}
                    for name in ("flash_int8_bf16p_kernel", "flash_int8_int8p_kernel"))
    emit({"phase": "build", "ok": True, "seconds": round(secs, 2),
          "flash_int8_bf16p": bf16p, "flash_int8_int8p": int8p, "ptxas": regs,
          "gpu": st["gpu"]})


def _flash_case(name, route_mode, q, k, v, block_kv, causal, *, replaces, library, timed=True):
    """Kernel vs plain at one shape, the kernel launched twice (the same
    bits both times, or the case fails); returns the kernels-line entry
    (without times unless `timed`)."""
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
    same = _same_bits_again(lambda: kernel(*args), [out])
    plain = fa8._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, **kw)
    _, _, l = fa8._flash_int8_plain_state(
        q, k_i8, ks, v_i8, vs, offsets,
        **{k: x for k, x in kw.items() if k != "save_residuals"})
    tol, _ = flash_tolerances(plain, None, l, v_i8, vs, block_kv, route_mode)
    ratio = err_over_tol(out, plain, tol)
    entry = {"name": name, "err_over_tol": ratio, "same_bits_twice": same,
             "ok": ratio <= 1.0 and same}
    if not timed:
        return entry
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
    return {**entry, "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/flash_int8_fwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "tol_range": [tol.min().item(), tol.max().item()],
            "shape": {"B": B, "Hq": H, "Hkv": Hkv, "S": S, "D": D,
                      "causal": causal, "block_kv": block_kv, "q": str(q.dtype)},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def _dense_kv(pages, scales, tables, Hq, dtype=None):
    """The K or V that a paged cache holds for each sequence of `tables`,
    dequantized, as dense [B, Hq, max_pages * P, D] (bf16 unless `dtype`)
    with the kv heads expanded to the q heads (int8 pages with [Hkv, n]
    scales, or nibble-packed pages with [Hkv, n, subs] scales)."""
    import torch
    from quantizedmha_tpu_torch.ops.quantize import unpack_int4_halves
    idx = tables.long()
    x = pages[:, idx]                                                 # [Hkv, B, mp, P, *]
    sc = scales[:, idx]
    if scales.dim() == 3:
        x = torch.cat(unpack_int4_halves(x), dim=-1)
        sc = sc.repeat_interleave(pages.shape[2] // scales.shape[-1], dim=-1)[..., None]
    else:
        sc = sc[..., None, None]
    x = (x.float() * sc).transpose(0, 1)                              # [B, Hkv, mp, P, D]
    B, Hkv = x.shape[:2]
    x = x.reshape(B, Hkv, -1, x.shape[-1]).to(dtype or torch.bfloat16)
    return x.repeat_interleave(Hq // Hkv, dim=1)


def _sdpa_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, tables):
    """(ms, backend) of SDPA in bf16 for one decode step on the same K/V
    dequantized beforehand (untimed), each sequence's length as a mask:
    the yardstick of the paged decode kernels."""
    import torch
    Hq = q.shape[1]
    kd = _dense_kv(k_pages, k_scales, tables, Hq)
    vd = _dense_kv(v_pages, v_scales, tables, Hq)
    mask = (torch.arange(kd.shape[2], device=q.device)[None, :] < lengths[:, None].long())
    out = _sdpa(q[:, :, None].to(torch.bfloat16), kd, vd, attn_mask=mask[:, None, None])
    del kd, vd
    return out


# The INT8 decode's main shapes at batch 8: (kv heads, seed, lengths, table
# slots). serve's decode (8 kv heads, 257-300 tokens of context), the same
# kernel for MQA (rows 3 and 4 are one kernel; no 8B path has one kv head),
# and serve_flash's decode at up to 8192 tokens of context (64 slots).
DECODE_MAIN = {"serve decode": (8, 2, (257, 300), 4), "mqa decode": (1, 3, (257, 300), 4),
               "serve_flash decode": (8, 6, (2048, 8192), 64)}


def _decode_main_inputs(Hkv, *, seed, lengths=(257, 300), max_pages=4):
    """A decode step at batch 8, Llama-3-8B heads, page 128, bf16 q:
    context lengths drawn from the closed range `lengths`, block tables of
    max_pages slots, random int8 pages. Returns the operands of
    ops/decode._paged_decode_launch."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, Hq, D, P = 8, 32, 128, 128
    lengths = torch.randint(lengths[0], lengths[1] + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
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
    return q, k_pages, v_pages, k_scales, v_scales, lengths, tables


def _decode_check(operands, kw):
    """One INT8 decode launch against its plain version, launched twice:
    (output, plain output, err_over_tol (inf when the second launch's
    bits differ), tolerance, launch, same bits)."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    kernel, args, (out, _), _operands = dec._paged_decode_launch(*operands, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = _same_bits_again(lambda: kernel(*args), (out,))
    plain = dec._paged_decode_plain(*operands, **kw)
    tol = decode_tolerance(plain, operands[2], operands[4])
    ratio = err_over_tol(out, plain, tol) if same else float("inf")
    return out, plain, ratio, tol, lambda: kernel(*args), same


def _decode_case(name, Hkv, *, replaces, seed, lengths=(257, 300), max_pages=4):
    """The decode kernel against its plain version at batch 8, Llama-3-8B
    heads, page 128 (_decode_main_inputs); launched twice, and a second
    launch whose bits differ fails the check."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    operands = _decode_main_inputs(Hkv, seed=seed, lengths=lengths, max_pages=max_pages)
    q, k_pages, v_pages, k_scales, v_scales, lengths, tables = operands
    B, Hq, D = q.shape
    P = k_pages.shape[2]
    kw = dict(sm_scale=D**-0.5, window=None, softcap=None, sinks=0, save_residuals=False)
    out, plain, ratio, tol, launch, same = _decode_check(operands, kw)
    ms = cuda_ms(launch, iters=50)
    # The whole entry point (checks, scratch, ctypes call) on the host
    # clock, 50 calls and one sync: the decode step's host loop pays it
    # twice a layer in serve_mixed.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        dec.paged_decode_attention(*operands)
    torch.cuda.synchronize()
    wrapper_ms = (time.perf_counter() - t0) * 1e3 / 50
    plain_ms = cuda_ms(lambda: dec._paged_decode_plain(*operands, **kw), iters=3, warmup=1)
    lib_ms, backend = _sdpa_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, tables)
    ctx = int(lengths.sum().item())
    nbytes = (q.numel() * 2 * 2 + 2 * ctx * Hkv * D
              + 2 * B * Hkv * max_pages * 4 + B * 4 + tables.numel() * 4)
    bms, by = bound(nbytes, {"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq})
    splits = dec.decode_splits(B, Hkv, max_pages, P)
    return {"name": name, "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_decode.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - plain.float()).abs().max().item(),
            "err_over_tol": ratio, "tol_range": [tol.min().item(), tol.max().item()],
            "ok": ratio <= 1.0, "same_bits_twice": same,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "page": P,
                      "max_pages": max_pages, "splits": list(splits),
                      "lengths": lengths.tolist()},
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


def _flash_fwd_check(q, k, v, offsets, *, causal, window=None, sinks=0, softcap=None,
                     save_residuals=True):
    """One float flash launch against its plain version on the card:
    (kernel output, plain output, [output, lse] err_over_tol, tolerance,
    launch, plain call). The kernel runs twice: a second launch whose bits
    differ adds an infinite ratio. The f32 route's planes (scratch the
    split pass fills) hold NaN before the first launch, so that a plane
    element the split pass leaves unwritten and the kernel reads shows."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, causal=causal, block_kv=min(1024, k.shape[2]), window=window,
              softcap=softcap, sinks=sinks, save_residuals=save_residuals)
    kernel, args, (out, lse), operands = fa._flash_fwd_launch(q, k, v, offsets, **kw)
    planes = operands[-1]
    if planes is not None:
        planes.fill_(float("nan"))
    kernel(*args)
    torch.cuda.synchronize()
    same = _same_bits_again(lambda: kernel(*args), [x for x in (out, lse) if x is not None])
    p_out, p_lse = fa._flash_fwd_plain(q, k, v, offsets, **dict(kw, save_residuals=True))
    w_abs = fa._flash_fwd_plain(q, k, v.abs(), offsets, **dict(kw, save_residuals=False))
    tol, lse_tol = flash_fwd_tolerances(q, k, v, p_out, p_lse, w_abs, sm_scale=sm,
                                        softcap=softcap)
    ratios = [err_over_tol(out, p_out, tol)]
    if save_residuals:
        ratios.append(err_over_tol(lse, p_lse, lse_tol))
    if not same:
        ratios.append(float("inf"))
    return (out, p_out, ratios, tol, lambda: kernel(*args),
            lambda: fa._flash_fwd_plain(q, k, v, offsets, **kw))


def _visible_pairs(sq, skv, causal):
    """(q, kv) pairs an end-aligned causal (or full) attention computes."""
    if not causal:
        return sq * skv
    return sum(min(skv, skv - sq + i + 1) for i in range(sq) if skv - sq + i + 1 > 0)


def _flash_fwd_case(name, q, k, v, causal, *, replaces, label):
    """The float flash kernel at one main-path shape (end-aligned, no
    window): check (the same bits twice), kernel / plain / SDPA times, the
    bound. SDPA runs on the same inputs: for f32 inputs in f32 (the first
    backend that takes them, memory-efficient attention, with TF32 off), the
    same function as the f32 route, and beside it in bf16 (the library's
    fast path, `library_bf16`). The f32 route's bound counts its six bf16
    passes a product on the tensor cores."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, S, D = q.shape
    Skv = k.shape[2]
    offsets = _offsets(Skv - S, 0, B, q.device)
    out, p_out, ratios, tol, launch, plain = _flash_fwd_check(q, k, v, offsets, causal=causal,
                                                              save_residuals=False)
    ms = cuda_ms(launch, iters=10)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    lib_ms, backend = _sdpa(qb, kb, vb, is_causal=causal, enable_gqa=kb.shape[1] != qb.shape[1])
    library_bf16 = None
    if q.dtype == torch.float32:
        library_bf16 = {"ms": lib_ms, "backend": backend}
        torch.backends.cuda.matmul.allow_tf32 = False
        lib_ms, backend = _sdpa(q, k, v, is_causal=causal, enable_gqa=k.shape[1] != q.shape[1])
    pairs = B * H * _visible_pairs(S, Skv, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    passes = 1 if q.dtype == torch.bfloat16 else 6
    bms, by = bound(nbytes, {"bf16": passes * 4 * pairs * D, "exp": pairs})
    return {"name": name, "route": "cuda", "source": "quantizedmha_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": None, "label": label,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": ratios[0], "tol_range": [tol.min().item(), tol.max().item()],
            "same_bits_twice": len(ratios) == 1,
            "ok": max(ratios) <= 1.0,
            "shape": {"B": B, "Hq": H, "Hkv": k.shape[1], "Sq": S, "Skv": Skv, "D": D,
                      "causal": causal, "dtype": str(q.dtype)},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend,
            **({"library_bf16": library_bf16, "allow_tf32": False} if library_bf16 else {})}


def _paged_cache(g, Hkv, num_pages, P, D):
    """Random int8 pages and per-(head, page) scales on the card."""
    import torch
    k_pages, v_pages = torch.randint(-127, 128, (2, Hkv, num_pages, P, D), generator=g,
                                     device="cuda", dtype=torch.int8)
    k_scales, v_scales = torch.rand((2, Hkv, num_pages), generator=g, device="cuda") * 0.02 + 0.005
    return k_pages, v_pages, k_scales, v_scales


def _same_bits_again(launch, outs):
    """Run launch() once more on the same inputs: whether every output
    tensor it writes comes out with the same bits."""
    import torch
    first = [x.clone() for x in outs]
    launch()
    torch.cuda.synchronize()
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(first, outs))


def _paged_prefill_check(q, cache, lengths, q_starts, tables, *, window=None, sinks=0,
                         softcap=None):
    """One paged prefill launch (with lse) against its plain version:
    (kernel output, plain output, [output, lse] err_over_tol, tolerance,
    launch, plain call). A bf16 launch runs twice: a second launch whose
    bits differ adds an infinite ratio."""
    import torch
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, window=window, softcap=softcap, sinks=sinks, save_residuals=True)
    operands = (q, *cache, lengths, q_starts, tables)
    kernel, args, (out, lse), _operands = pp._paged_prefill_launch(*operands, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = q.dtype != torch.bfloat16 or _same_bits_again(lambda: kernel(*args), (out, lse))
    p_out, p_lse = pp._paged_prefill_plain(*operands, **kw)
    w_abs = prefill_w_abs(q, cache, lengths, q_starts, tables, **kw)
    tol, lse_tol = paged_prefill_tolerances(q, *cache, p_out, p_lse, sm_scale=sm,
                                            softcap=softcap, w_abs=w_abs)
    ratios = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
    if not same:
        ratios.append(float("inf"))
    return (out, p_out, ratios, tol, lambda: kernel(*args),
            lambda: pp._paged_prefill_plain(*operands, **kw))


# The serve_flash path's heaviest chunk shape: a 2048-row chunk at 4096 of
# context (lengths 6144), Llama-3-8B heads, page 128, bf16 q.
PAGED_MAIN = dict(Hq=32, Hkv=8, D=128, P=128, C=2048, q_start=4096)


def _paged_main_inputs(g):
    """(q, cache, lengths, q_starts, tables) at PAGED_MAIN."""
    import torch
    Hq, Hkv, D, P, C, q0 = (PAGED_MAIN[x] for x in ("Hq", "Hkv", "D", "P", "C", "q_start"))
    n_pages = (q0 + C) // P
    cache = _paged_cache(g, Hkv, n_pages + 1, P, D)
    tables = (torch.randperm(n_pages, generator=g, device="cuda") + 1)[None].to(torch.int32)
    q = torch.randn((1, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor([q0 + C], dtype=torch.int32, device="cuda")
    q_starts = torch.tensor([q0], dtype=torch.int32, device="cuda")
    return q, cache, lengths, q_starts, tables


def _paged_prefill_case(g, *, replaces):
    Hq, Hkv, D, P, C, q0 = (PAGED_MAIN[x] for x in ("Hq", "Hkv", "D", "P", "C", "q_start"))
    ctx = q0 + C
    n_pages = ctx // P
    q, cache, lengths, q_starts, tables = _paged_main_inputs(g)
    out, p_out, ratios, tol, launch, plain = _paged_prefill_check(q, cache, lengths, q_starts,
                                                                  tables)
    ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    # SDPA on the same K/V dequantized to bf16 and expanded to the q heads
    # beforehand (untimed), with the chunk's causal mask made explicit.
    import torch
    k_pages, v_pages, k_scales, v_scales = cache
    idx = tables[0].long()

    def dense(pages, scales):
        x = pages[:, idx].float() * scales[:, idx][..., None, None]      # [Hkv, n, P, D]
        return x.reshape(Hkv, ctx, D).repeat_interleave(Hq // Hkv, dim=0)[None].to(torch.bfloat16)
    kd, vd = dense(k_pages, k_scales), dense(v_pages, v_scales)
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= q0 + torch.arange(C, device="cuda")[:, None])
    lib_ms, backend = _sdpa(q, kd, vd, attn_mask=mask)
    del kd, vd
    pairs = Hq * (C * q0 + C * (C + 1) // 2)
    nbytes = (2 * q.numel() * 2 + 2 * ctx * Hkv * D + 2 * Hkv * n_pages * 4
              + tables.numel() * 4 + Hq * C * 4)
    bms, by = bound(nbytes, {"bf16": 4 * pairs * D, "exp": pairs})
    return {"name": "paged_prefill", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "tol_range": [tol.min().item(), tol.max().item()],
            "ok": max(ratios) <= 1.0,
            "shape": dict(PAGED_MAIN, lengths=ctx, save_residuals=True, q="bfloat16"),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


# Small shapes off the main paths, so that every branch of the two kernels
# is held against its plain version: ragged q tiles, quant blocks that are
# not a multiple of the kernel's 64-wide tile, a padded cache (kv tail
# mask), per-sequence offsets, GQA/MQA, window + sinks, softcap, both
# numerics modes at every head dim, both q dtypes and lse.
#   (B, H, Hkv, Sq, Skv, kv_len, D, block_kv, causal, window, sinks,
#    softcap, mode, bf16 q, offsets: None for end-aligned, a q offset per
#    sequence, or a (q offset, kv offset) pair per sequence)
# The cases from the tenth on hold MODE_BF16_P's wgmma kernel (128 q rows a
# block; 64-key tiles walked per quant block, twice) at its edges: q rows
# not a multiple of 128, block_kv of 64, 96, 320 and 512 (tiles clipped at
# a block's end, several tiles a sweep), Skv under one tile, a quant block
# wholly masked for some rows of a tile (causal with q offsets; rows of the
# last case's second sequence see no key), window + sinks with skipped
# tiles, softcap on mask-free tiles, d = 32, 64 and 128 (128 not causal),
# f32 and bf16 q, GQA with offsets per sequence. The cases from the
# eighteenth on hold MODE_INT8_P's wgmma kernel (64 q rows a block, one q
# head) at its edges: serve_w4's 512 keys in one quant block of 512, a
# quant block of 1024 over keys padded past kv_len, q rows not a multiple
# of 64, GQA groups of 1, 4 and 8, block_kv of 64, 96, 320 and 40 (Skv
# under one tile), a quant block wholly masked for some rows (offsets per
# sequence), window + sinks with skipped tiles, softcap on mask-free tiles,
# d = 32, 64 and 128, f32 and bf16 q; each draws from its own generator
# (FIRST_INT8P_CASE), so that the cases after FLASH_COVERAGE keep theirs.
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
    (1, 2, 2, 150, 256, 256, 32, 64, True, None, 0, None, 1, False, None),
    (1, 2, 1, 200, 384, 384, 64, 96, False, None, 0, None, 1, True, None),
    (2, 4, 2, 130, 640, 600, 32, 320, True, None, 0, None, 1, False, (0, 200)),
    (1, 4, 4, 64, 48, 48, 128, 48, False, None, 0, None, 1, True, None),
    (1, 2, 1, 300, 512, 512, 64, 256, True, 64, 4, None, 1, False, None),
    (1, 4, 2, 96, 256, 256, 64, 128, False, None, 0, 25.0, 1, True, None),
    (1, 2, 2, 70, 512, 512, 128, 512, False, None, 0, None, 1, False, None),
    (2, 8, 2, 96, 192, 192, 32, 64, True, None, 0, None, 1, True, ((70, 10), (0, 40))),
    (1, 8, 2, 512, 512, 512, 128, 512, True, None, 0, None, 0, True, None),
    (1, 4, 1, 300, 1024, 600, 128, 1024, True, None, 0, None, 0, False, None),
    (1, 2, 2, 100, 320, 320, 64, 320, True, None, 0, None, 0, True, None),
    (1, 8, 1, 70, 40, 40, 32, 40, False, None, 0, None, 0, False, None),
    (2, 4, 2, 96, 192, 192, 64, 96, True, None, 0, None, 0, True, ((70, 10), (0, 40))),
    (1, 4, 2, 400, 512, 400, 128, 128, True, 64, 4, None, 0, True, None),
    (1, 4, 2, 128, 256, 256, 64, 256, False, None, 0, 25.0, 0, False, None),
    (2, 2, 2, 150, 256, 256, 32, 64, True, None, 0, None, 0, True, (10, 50)),
)
FIRST_INT8P_CASE = 17
#   (B, Hq, Hkv, D, page, window, sinks, softcap, bf16 q, table slots,
#    lengths (None: drawn from 1 to a full table), scores far below zero)
# The first three hold tables of 6 slots (one split); the rest hold 20-40
# slots, several splits (ops/decode.decode_splits): window + sinks with
# whole splits behind the window, lengths of 1 and below one split, MQA
# at 20 pages (32 and 64 query heads, the latter two blocks), and scores
# below -200 (q against all-positive keys), where a merge that took an
# empty split's m as 0 would underflow every weight.
DECODE_COVERAGE = (
    (3, 8, 2, 32, 16, None, 0, None, False, 6, None, False),
    (3, 4, 4, 64, 32, 20, 3, 50.0, True, 6, None, False),
    (2, 8, 1, 128, 16, 7, 0, None, False, 6, None, False),
    (3, 8, 2, 64, 16, 100, 5, None, True, 40, (640, 500, 300), False),
    (2, 8, 2, 128, 32, 200, 3, 30.0, False, 24, (768, 700), False),
    (4, 8, 2, 32, 16, None, 0, None, False, 32, (1, 5, 40, 512), False),
    (4, 8, 2, 64, 16, None, 0, None, True, 32, (1, 63, 64, 300), False),
    (2, 32, 1, 128, 128, None, 0, None, True, 20, (2560, 1800), False),
    (2, 64, 1, 64, 64, None, 0, None, False, 20, (1280, 900), False),
    (3, 8, 2, 64, 16, None, 0, None, False, 24, (384, 100, 30), True),
)


#   (B, H, Hkv, Sq, Skv, D, causal, window, sinks, softcap, bf16, (q_off, kv_off) or None;
#    an offset may be a tuple, one per sequence)
# The bf16 cases from the eighth on hold the wgmma kernel's block rows (all
# q heads of a kv head's group times rows / group positions; 128 rows at
# d=32, 192 above) at its edges: Sq a multiple of neither the rows nor
# rows / group, Skv under one 64-key tile, groups of 1, 3, 5 and 8, groups
# that leave rows of a block empty (3 at d=32, 5 at d=128), groups of more
# than a block's rows (130 at d=32, 200 at d=64: two head chunks),
# sequences with their own offsets (rows of the second see no key), a
# window with sink tiles and skipped tiles between, softcap on tiles with
# no masked pair, d = 32, 64 and 128. The cases from FIRST_F32_CASE on hold
# the f32 route's six-pass kernel (192 rows at d=32, 128 at d=64, 64 rows
# and 32-key tiles at d=128) at its edges, each drawing from its own
# generator: d=64 causal GQA 4 with a ragged q tile over five key tiles, a
# fold of 130 q heads over one kv head at Sq=5 over a ragged key tile,
# d=128 with offsets per sequence and softcap over seven 32-key tiles, a
# window with sinks at d=32 over seven 64-key tiles, d=128 GQA 2 not
# causal over three tiles.
FLASH_FWD_COVERAGE = (
    (2, 4, 2, 100, 190, 32, False, None, 0, None, False, None),
    (2, 4, 2, 100, 190, 64, True, None, 0, None, True, None),
    (1, 4, 1, 130, 130, 128, True, 40, 4, None, True, None),
    (1, 4, 1, 130, 130, 128, True, 40, 4, None, False, None),
    (1, 8, 2, 77, 77, 64, True, None, 0, 20.0, True, None),
    (1, 2, 2, 96, 160, 32, True, None, 0, 30.0, False, (10, 50)),
    (2, 4, 4, 64, 64, 128, False, None, 0, None, False, None),
    (1, 8, 2, 75, 75, 128, True, None, 0, None, True, None),
    (2, 4, 2, 20, 40, 32, False, None, 0, None, True, None),
    (1, 2, 2, 200, 200, 128, True, None, 0, None, True, None),
    (1, 6, 2, 90, 150, 32, True, None, 0, None, True, None),
    (1, 16, 2, 50, 120, 32, True, None, 0, None, True, None),
    (1, 130, 1, 5, 70, 32, True, None, 0, None, True, None),
    (2, 8, 2, 96, 160, 64, True, None, 0, None, True, ((70, 10), (0, 40))),
    (1, 8, 2, 400, 400, 128, True, 64, 4, None, True, None),
    (1, 4, 2, 128, 256, 64, False, None, 0, 30.0, True, None),
    (1, 10, 2, 60, 90, 128, True, None, 0, None, True, None),
    (1, 200, 1, 3, 40, 64, True, None, 0, None, True, None),
    (1, 8, 2, 100, 260, 64, True, None, 0, None, False, None),
    (1, 130, 1, 5, 70, 32, True, None, 0, None, False, None),
    (2, 4, 2, 150, 200, 128, True, None, 0, 20.0, False, ((60, 10), (0, 50))),
    (1, 4, 1, 200, 400, 32, True, 64, 4, None, False, None),
    (1, 6, 3, 70, 96, 128, False, None, 0, None, False, None),
)
FIRST_F32_CASE = 18
# f32 cases built so that a dropped third bf16 piece shows, each
#   (B, H, Hkv, S, kind); causal, end-aligned, d=32:
# "pv": scores in [-0.02, 0] with key 0 at 0 (every row's max, p = 1 and
#   v = 0), V positive with its third piece near its largest (2^-17 of v):
#   rows of few keys lose up to 2^-17 of w_abs with P's third piece, all
#   rows 2^-17 with V's.
# "qk": Q (scaled) and K constant, each with its third piece near its
#   largest: every score ~1030, the sum of 32 aligned products, which Q's
#   or K's third piece moves by 2^-17 in every row's lse.
FLASH_FWD_PIECES = ((4, 32, 4, 80, "pv"), (1, 4, 1, 70, "qk"))
# 1 + 1.5·2^-9 + (2^-17 - 2^-23): bf16 pieces 1, 1.5·2^-9, 2^-17 - 2^-23.
PIECES_VALUE = 1 + 1.5 * 2**-9 + 2**-17 - 2**-23


def _f32_preimage(target, scale):
    """An f32 x with x·scale rounded to f32 equal to the f32 target."""
    import torch
    t, s = (torch.tensor(x, dtype=torch.float32) for x in (target, scale))
    x = (t.double() / s.double()).float()
    for _ in range(8):
        y = x * s
        if y == t:
            return float(x)
        x = torch.nextafter(x, torch.tensor(math.inf if y < t else -math.inf))
    raise AssertionError(f"no f32 preimage of {target} under {scale}")


def flash_fwd_pieces_inputs(g, case, device="cuda"):
    """(q, k, v) of a FLASH_FWD_PIECES case, f32, from the generator g."""
    import torch
    B, H, Hkv, S, kind = case
    D = 32
    if kind == "pv":
        q = torch.rand((B, H, S, D), generator=g, device=device) * 0.02
        k = -torch.rand((B, Hkv, S, D), generator=g, device=device)
        e = torch.randint(-1, 2, (B, Hkv, S, D), generator=g, device=device)
        v = torch.ldexp(torch.full((B, Hkv, S, D), PIECES_VALUE, device=device), e.float())
        k[:, :, 0] = 0.0
        v[:, :, 0] = 0.0
        return q, k, v
    qv = _f32_preimage(4 * PIECES_VALUE, D**-0.5)
    q = torch.full((B, H, S, D), qv, device=device)
    k = torch.full((B, Hkv, S, D), 8 * PIECES_VALUE, device=device)
    v = torch.randn((B, Hkv, S, D), generator=g, device=device)
    return q, k, v


#   (Hq, Hkv, D, page, C, lengths, q_starts, window, sinks, softcap, bf16 q)
# The bf16 cases (tensor cores) also cover d=32, pages of 16 and 32 keys
# (shorter than the kernel's 64-key tile), a window with sink tiles and
# skipped tiles between, GQA groups of 3, 8 and 64 (one q position a tile).
PAGED_PREFILL_COVERAGE = (
    (8, 2, 32, 16, 40, (40, 90), (0, 50), None, 0, None, False),
    (4, 4, 64, 32, 33, (100,), (67,), 30, 3, None, True),
    (8, 1, 128, 128, 70, (200, 70, 0), (130, 0, 0), None, 0, 10.0, True),
    (6, 2, 64, 64, 20, (300,), (280,), 64, 0, None, False),
    (32, 8, 128, 128, 130, (900,), (770,), None, 0, None, True),
    (8, 2, 32, 16, 40, (40, 90), (0, 50), None, 0, None, True),
    (4, 2, 64, 32, 100, (300, 100), (200, 0), None, 0, None, True),
    (8, 2, 128, 64, 150, (500,), (350,), 100, 5, None, True),
    (8, 1, 64, 16, 70, (200, 70), (130, 0), None, 0, 20.0, True),
    (6, 2, 64, 16, 50, (120,), (70,), None, 0, None, True),
    (64, 1, 32, 16, 5, (37,), (32,), None, 0, None, True),
)


def _coverage_float(g):
    """FLASH_FWD_COVERAGE and PAGED_PREFILL_COVERAGE: kernel against plain
    on the card, [output, lse] err_over_tol per case."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    ratios, failed = {}, []
    for i, case in enumerate(FLASH_FWD_COVERAGE):
        gi = g if i < FIRST_F32_CASE else torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v, offsets, masks = flash_fwd_coverage_inputs(gi, case)
        _, _, r, *_ = _flash_fwd_check(q, k, v, offsets, **masks)
        ratios[f"flash_fwd{i}"] = r
        if max(r) > 1.0:
            failed.append(f"flash_fwd{i}")
    for i, case in enumerate(FLASH_FWD_PIECES):
        gi = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v = flash_fwd_pieces_inputs(gi, case)
        _, _, r, *_ = _flash_fwd_check(q, k, v, _offsets(0, 0, case[0], q.device), causal=True)
        ratios[f"flash_fwd_pieces{i}"] = r
        if max(r) > 1.0:
            failed.append(f"flash_fwd_pieces{i}")
    for i, case in enumerate(PAGED_PREFILL_COVERAGE):
        *inputs, masks = paged_prefill_coverage_inputs(g, case)
        _, _, r, *_ = _paged_prefill_check(*inputs, **masks)
        ratios[f"paged_prefill{i}"] = r
        if max(r) > 1.0:
            failed.append(f"paged_prefill{i}")
    return ratios, failed


def flash_fwd_coverage_inputs(g, case, device="cuda"):
    """(q, k, v, offsets, masks) of a FLASH_FWD_COVERAGE case, drawn from
    the generator g; masks holds causal, window, sinks and softcap."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, Hkv, Sq, Skv, D, causal, window, sinks, cap, bf16, offs = case
    dt = torch.bfloat16 if bf16 else torch.float32
    q = (torch.randn((B, H, Sq, D), generator=g, device=device) * 1.5).to(dt)
    k, v = torch.randn((2, B, Hkv, Skv, D), generator=g, device=device).to(dt)
    q_off, kv_off = offs if offs is not None else (Skv - Sq, 0)
    return (q, k, v, _offsets(q_off, kv_off, B, q.device),
            dict(causal=causal, window=window, sinks=sinks, softcap=cap))


def flash_coverage_inputs(g, case, device="cuda"):
    """(q, k_i8, k_scales, v_i8, v_scales, offsets, kw) of a FLASH_COVERAGE
    case, drawn from the generator g; kw holds the plain version's keywords
    (save_residuals=True)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    (B, H, Hkv, Sq, Skv, kv_len, D, bkv, causal, window, sinks, cap, mode, qbf16,
     offs) = case
    dt = torch.bfloat16 if qbf16 else torch.float32
    q = (torch.randn((B, H, Sq, D), generator=g, device=device) * 2).to(dt)
    kv = torch.randn((2, B, Hkv, Skv, D), generator=g, device=device).to(dt)
    k_i8, ks = quantize_kv_blocks(kv[0], bkv)
    v_i8, vs = quantize_kv_blocks(kv[1], bkv)
    if offs is None:
        qo, kvo = kv_len - Sq, 0
    elif isinstance(offs[0], tuple):
        qo, kvo = (torch.tensor(x, device=device) for x in zip(*offs))
    else:
        qo, kvo = torch.tensor(offs, device=device), 0
    kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=kv_len, block_kv=bkv,
              scale_clamp=1e-8, p_scale=127.0, window=window, softcap=cap,
              sinks=sinks, mode=mode, save_residuals=True)
    return q, k_i8, ks, v_i8, vs, fa8._offsets(qo, kvo, B, q.device), kw


def _flash_coverage_ratios(g):
    """FLASH_COVERAGE: the INT8 flash kernel against plain on the card,
    each case launched twice, {case: [output, lse] err_over_tol} (a third
    entry, inf, when the second launch's bits differ)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    ratios = {}
    for i, case in enumerate(FLASH_COVERAGE):
        gi = g if i < FIRST_INT8P_CASE else torch.Generator(device="cuda").manual_seed(i)
        *operands, kw = flash_coverage_inputs(gi, case)
        kernel, args, (out, lse), _operands = fa8._flash_int8_launch(*operands, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        same = _same_bits_again(lambda: kernel(*args), (out, lse))
        p_out, p_lse = fa8._flash_int8_plain(*operands, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            *operands, **{k: x for k, x in kw.items() if k != "save_residuals"})
        tol, lse_tol = flash_tolerances(p_out, p_lse, l, operands[3], operands[4],
                                        kw["block_kv"], kw["mode"])
        ratios[f"fa8_{i}"] = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
        if not same:
            ratios[f"fa8_{i}"].append(float("inf"))
    return ratios


def _coverage():
    """Every FLASH_COVERAGE / DECODE_COVERAGE case, kernel against plain on
    the card with output and lse checked; returns the summary entry, with
    each case's [output, lse] error over its tolerance."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(5)
    ratios = _flash_coverage_ratios(g)
    failed = [k for k, x in ratios.items() if max(x) > 1.0]
    r = _decode_coverage_ratios(g)
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    r, f = _coverage_float(g)
    ratios.update(r)
    failed += f
    r = _coverage_int4(g)
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    composites = _mixed_composites(g)
    failed += [k for k, c in composites.items() if c["err_over_tol"] > 1.0]
    r = _coverage_bwd(g)
    ratios.update(r)
    failed += [k for k, x in r.items() if max(x) > 1.0]
    return {"flash_cases": len(FLASH_COVERAGE), "decode_cases": len(DECODE_COVERAGE),
            "flash_fwd_cases": len(FLASH_FWD_COVERAGE),
            "flash_bwd_cases": len(FLASH_BWD_COVERAGE),
            "paged_prefill_cases": len(PAGED_PREFILL_COVERAGE),
            "int4_cases": len(DECODE_INT4_COVERAGE) + len(PREFILL_INT4_COVERAGE),
            "err_over_tol": ratios, "mixed_composites": composites, "failed": failed,
            "ok": not failed}


# --- INT4 pages (the mixed cache's bulk): rows 11 and 12 -------------------

# serve_mixed's shapes: Llama-3-8B heads, page 128, 4 scale sub-tiles a page,
# the INT8 region the first 256 positions, an INT4 table of 64 slots.
MIXED_MAIN = dict(Hq=32, Hkv=8, D=128, P=128, subs=4, boundary=256, max_pages4=64)


def _int4_cache(g, Hkv, num_pages, P, D, subs):
    """Random nibble-packed pages (every byte value) and per-sub-tile
    scales [Hkv, num_pages, subs] on the card."""
    import torch
    k_pages, v_pages = torch.randint(-128, 128, (2, Hkv, num_pages, P, D // 2), generator=g,
                                     device="cuda", dtype=torch.int8)
    k_scales, v_scales = torch.rand((2, Hkv, num_pages, subs), generator=g, device="cuda") * 0.2 + 0.1
    return k_pages, v_pages, k_scales, v_scales


def _tables_for(g, B, max_pages, num_pages):
    """[B, max_pages] tables of distinct random pages past scrap page 0."""
    import torch
    perm = torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages] + 1
    return perm.reshape(B, max_pages).to(torch.int32)


def _int4_check(q, cache, lengths, tables, q_starts=None, *, window=None, sinks=0,
                softcap=None):
    """One INT4 launch with lse, decode (q [B, Hq, D]) or prefill (q [B,
    Hq, C, D], q_starts), against its plain version: (kernel output, plain
    output, [output, lse] err_over_tol, output tolerance, launch, plain
    call, plain lse, lse tolerance). A decode launch and a bf16 prefill
    launch run twice, as in _paged_prefill_check."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, window=window, softcap=softcap, sinks=sinks, save_residuals=True)
    w_abs = None
    if q_starts is None:
        operands = (q, *cache, lengths, tables)
        launch_fn, plain_fn = dec._paged_decode_launch, dec._paged_decode_int4_plain
    else:
        operands = (q, *cache, lengths, q_starts, tables)
        launch_fn, plain_fn = pp._paged_prefill_launch, pp._paged_prefill_int4_plain
        w_abs = prefill_w_abs(q, cache, lengths, q_starts, tables, int4=True, **kw)
    kernel, args, (out, lse), _operands = launch_fn(*operands, int4=True, **kw)
    kernel(*args)
    torch.cuda.synchronize()
    same = ((q_starts is not None and w_abs is None)
            or _same_bits_again(lambda: kernel(*args), (out, lse)))
    p_out, p_lse = plain_fn(*operands, **kw)
    tol, lse_tol = int4_tolerances(q, *cache, p_out, p_lse, sm_scale=sm, softcap=softcap,
                                   w_abs=w_abs)
    ratios = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
    if not same:
        ratios.append(float("inf"))
    return (out, p_out, ratios, tol, lambda: kernel(*args), lambda: plain_fn(*operands, **kw),
            p_lse, lse_tol)


def _int4_decode_main_inputs(g):
    """serve_mixed's decode at batch 8: INT4 contexts of 1.7k-7.7k tokens
    (lengths less the 256-token INT8 region) through 64-slot tables."""
    import torch
    m = MIXED_MAIN
    B = 8
    cache = _int4_cache(g, m["Hkv"], B * m["max_pages4"] + 1, m["P"], m["D"], m["subs"])
    tables = _tables_for(g, B, m["max_pages4"], B * m["max_pages4"] + 1)
    lengths = torch.randint(1700, 7701, (B,), generator=g, device="cuda", dtype=torch.int32)
    q = torch.randn((B, m["Hq"], m["D"]), generator=g, device="cuda").to(torch.bfloat16)
    return q, cache, lengths, tables


def _int4_prefill_main_inputs(g):
    """serve_mixed's heaviest chunk in the INT4 frame: 2048 rows at 4096 of
    context (q_start 4096 - 256, length 6144 - 256), bf16 q."""
    import torch
    m = MIXED_MAIN
    C, q0 = 2048, 4096 - m["boundary"]
    n_pages = -(-(q0 + C) // m["P"])
    cache = _int4_cache(g, m["Hkv"], n_pages + 1, m["P"], m["D"], m["subs"])
    tables = _tables_for(g, 1, n_pages, n_pages + 1)
    q = torch.randn((1, m["Hq"], C, m["D"]), generator=g, device="cuda").to(torch.bfloat16)
    return (q, cache, torch.tensor([q0 + C], dtype=torch.int32, device="cuda"),
            tables, torch.tensor([q0], dtype=torch.int32, device="cuda"))


def _int4_decode_case(g):
    """Row 12 at serve_mixed's decode shape: check, kernel / plain / SDPA
    times, the bound (the INT4 bytes of the context once, q, o, lse)."""
    from quantizedmha_tpu_torch.ops.decode import decode_splits
    m = MIXED_MAIN
    q, cache, lengths, tables = _int4_decode_main_inputs(g)
    out, p_out, ratios, tol, launch, plain, *_ = _int4_check(q, cache, lengths, tables)
    ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    lib_ms, backend = _sdpa_decode(q, *cache, lengths, tables)
    B, Hq, D = q.shape
    ctx = int(lengths.sum().item())
    pages = sum(-(-int(n) // m["P"]) for n in lengths.tolist())
    nbytes = (q.numel() * 2 * 2 + B * Hq * 4 + 2 * ctx * m["Hkv"] * D // 2
              + 2 * pages * m["Hkv"] * m["subs"] * 4 + B * 4 + tables.numel() * 4)
    bms, by = bound(nbytes, {"fp32": 2 * 2 * ctx * Hq * D, "exp": ctx * Hq})
    splits = decode_splits(B, m["Hkv"], m["max_pages4"], m["P"])
    return {"name": "paged_decode_int4", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_decode.cu",
            "replaces": "quantizedmha_tpu/ops/decode.py:897", "launches": None,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "tol_range": [tol.min().item(), tol.max().item()],
            "ok": max(ratios) <= 1.0, "same_bits_twice": len(ratios) == 2,
            "shape": {"B": B, "Hq": Hq, "Hkv": m["Hkv"], "D": D, "page": m["P"],
                      "subs": m["subs"], "max_pages": m["max_pages4"], "splits": list(splits),
                      "lengths": lengths.tolist(), "save_residuals": True, "q": "bfloat16"},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


def _int4_prefill_case(g):
    """Row 11 at serve_mixed's heaviest chunk: check, kernel / plain / SDPA
    times (SDPA on the same K/V dequantized to bf16, causal mask explicit),
    the bound (bf16 operations of the visible pairs: both products on the
    tensor cores)."""
    import torch
    m = MIXED_MAIN
    q, cache, lengths, tables, q_starts = _int4_prefill_main_inputs(g)
    out, p_out, ratios, tol, launch, plain, *_ = _int4_check(q, cache, lengths, tables, q_starts)
    ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    B, Hq, C, D = q.shape
    q0, ctx = int(q_starts[0]), int(lengths[0])
    kd = _dense_kv(cache[0], cache[2], tables, Hq)[:, :, :ctx]
    vd = _dense_kv(cache[1], cache[3], tables, Hq)[:, :, :ctx]
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= q0 + torch.arange(C, device="cuda")[:, None])
    lib_ms, backend = _sdpa(q, kd, vd, attn_mask=mask)
    del kd, vd
    pairs = Hq * (C * q0 + C * (C + 1) // 2)
    n_pages = tables.shape[1]
    nbytes = (2 * q.numel() * 2 + 2 * ctx * m["Hkv"] * D // 2
              + 2 * m["Hkv"] * n_pages * m["subs"] * 4 + tables.numel() * 4 + Hq * C * 4)
    bms, by = bound(nbytes, {"bf16": 4 * pairs * D, "exp": pairs})
    return {"name": "paged_prefill_int4", "route": "cuda",
            "source": "quantizedmha_tpu_torch/csrc/paged_prefill.cu",
            "replaces": "quantizedmha_tpu/ops/paged_prefill.py:323", "launches": None,
            "max_abs_err": (out.float() - p_out.float()).abs().max().item(),
            "err_over_tol": max(ratios), "tol_range": [tol.min().item(), tol.max().item()],
            "ok": max(ratios) <= 1.0,
            "shape": {"Hq": Hq, "Hkv": m["Hkv"], "D": D, "P": m["P"], "subs": m["subs"],
                      "C": C, "q_start": q0, "lengths": ctx, "save_residuals": True,
                      "q": "bfloat16"},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend}


# Small INT4 shapes off the main paths: subs 1 and 4, window, window + sinks,
# softcap, Hkv 1 and 2, GQA groups 4, 3 and 8, every head dim, both q dtypes,
# an empty sequence (length 0) in every decode case, and prefill chunks whose
# q_start is negative and straddles 0 inside a q tile.
#   (B, Hq, Hkv, D, page, subs, window, sinks, softcap, bf16 q, table slots,
#    lengths (None: drawn from 1 to a full table; the first is set to 0))
# The last four hold 20-40 slots, several splits, as DECODE_COVERAGE's.
DECODE_INT4_COVERAGE = (
    (3, 8, 2, 32, 16, 1, None, 0, None, False, 6, None),
    (3, 4, 1, 64, 32, 4, 20, 3, 50.0, True, 6, None),
    (2, 8, 2, 128, 16, 4, 7, 0, None, False, 6, None),
    (4, 8, 1, 128, 64, 2, None, 0, 30.0, True, 6, None),
    (3, 8, 2, 64, 16, 4, 100, 5, None, True, 40, (0, 640, 300)),
    (3, 4, 1, 128, 32, 2, None, 0, 20.0, False, 24, (0, 1, 700)),
    (2, 32, 1, 128, 128, 4, None, 0, None, True, 24, (0, 2900)),
    (4, 8, 2, 32, 16, 1, None, 0, None, False, 32, (0, 5, 40, 512)),
)
#   (Hq, Hkv, D, page, subs, C, lengths, q_starts, window, sinks, softcap, bf16 q)
# The last three (bf16, tensor cores): d=32 on 16-key pages; GQA 8 (Hkv 1)
# on 32-key pages of 4 sub-tiles with negative q_starts; window + sinks.
PREFILL_INT4_COVERAGE = (
    (8, 2, 32, 16, 1, 40, (40, 90), (0, 50), None, 0, None, False),
    (4, 1, 64, 32, 4, 33, (100, 20), (67, -13), 30, 3, None, True),
    (8, 2, 128, 128, 4, 70, (200, 0, 50), (130, -70, -20), None, 0, 10.0, True),
    (6, 2, 64, 64, 2, 20, (300,), (280,), 64, 0, None, False),
    (32, 8, 128, 128, 4, 130, (900, 60), (770, -70), None, 0, None, True),
    (8, 2, 32, 16, 2, 40, (40, 90), (0, 50), None, 0, None, True),
    (8, 1, 64, 32, 4, 60, (100, 30, 0), (40, -30, -60), None, 0, None, True),
    (4, 2, 128, 64, 2, 120, (400,), (280,), 90, 4, 15.0, True),
)


def _coverage_int4(g):
    """DECODE_INT4_COVERAGE and PREFILL_INT4_COVERAGE: kernel against plain
    on the card, {case: [output, lse] err_over_tol}."""
    import torch
    ratios = {}
    for i, (B, Hq, Hkv, D, P, subs, window, sinks, cap, bf16, max_pages,
            lens) in enumerate(DECODE_INT4_COVERAGE):
        cache = _int4_cache(g, Hkv, B * max_pages + 1, P, D, subs)
        tables = _tables_for(g, B, max_pages, B * max_pages + 1)
        lengths = torch.randint(1, P * max_pages + 1, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        if lens is not None:
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        lengths[0] = 0
        q = torch.randn((B, Hq, D), generator=g, device="cuda")
        q = q.to(torch.bfloat16) if bf16 else q
        ratios[f"paged_decode_int4_{i}"] = _int4_check(
            q, cache, lengths, tables, window=window, sinks=sinks, softcap=cap)[2]
    for i, case in enumerate(PREFILL_INT4_COVERAGE):
        q, cache, lengths, q_starts, tables, masks = paged_prefill_coverage_inputs(
            g, case, int4=True)
        ratios[f"paged_prefill_int4_{i}"] = _int4_check(q, cache, lengths, tables, q_starts,
                                                        **masks)[2]
    return ratios


def paged_prefill_coverage_inputs(g, case, *, int4=False, q_dtype=None):
    """(q, cache, lengths, q_starts, tables, masks) of one
    PAGED_PREFILL_COVERAGE case (INT8 pages) or, with int4,
    PREFILL_INT4_COVERAGE case on the card; q in q_dtype when given, else
    as the case says."""
    import torch
    if int4:
        Hq, Hkv, D, P, subs, C, lengths, q_starts, window, sinks, cap, bf16 = case
    else:
        Hq, Hkv, D, P, C, lengths, q_starts, window, sinks, cap, bf16 = case
    B = len(lengths)
    max_pages = max(-(-n // P) for n in lengths) + 1
    if int4:
        cache = _int4_cache(g, Hkv, B * max_pages + 1, P, D, subs)
        tables = _tables_for(g, B, max_pages, B * max_pages + 1)
    else:
        cache = _paged_cache(g, Hkv, B * max_pages + 1, P, D)
        tables = (torch.randperm(B * max_pages, generator=g, device="cuda") + 1).reshape(
            B, max_pages).to(torch.int32)
    q = torch.randn((B, Hq, C, D), generator=g, device="cuda")
    q = q.to(q_dtype or (torch.bfloat16 if bf16 else torch.float32))
    return (q, cache, torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            torch.tensor(q_starts, dtype=torch.int32, device="cuda"), tables,
            dict(window=window, sinks=sinks, softcap=cap))


def _mixed_composites(g):
    """mixed_paged_decode_attention and mixed_paged_prefill_attention on the
    card (two kernels each and the merge) against their plain compositions
    (the plain INT8 and INT4 walks, the same merge), held within
    merge_tolerance of the partials' tolerances; and the decode composite's
    largest deviation from float attention over the dequantized mixed cache
    (scripts/run13_mixed_kv.py's check), printed."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.parallel.combine import merge_two_partials
    from quantizedmha_tpu_torch.serving.mixed_kv import (
        MixedPagedKVState,
        mixed_paged_decode_attention,
        mixed_paged_prefill_attention,
    )
    m = MIXED_MAIN
    Hq, Hkv, D, P, bnd = m["Hq"], m["Hkv"], m["D"], m["P"], m["boundary"]
    bp, mp4, B = bnd // P, 16, 8
    c8 = _paged_cache(g, Hkv, B * bp + 1, P, D)
    c4 = _int4_cache(g, Hkv, B * mp4 + 1, P, D, m["subs"])
    state = MixedPagedKVState(*c8, *c4)
    t8, t4 = _tables_for(g, B, bp, B * bp + 1), _tables_for(g, B, mp4, B * mp4 + 1)
    lengths = torch.tensor([100, 256, 257, 300, 900, 1500, 2000, 2304], dtype=torch.int32,
                           device="cuda")
    sm = D**-0.5
    kw = dict(sm_scale=sm, window=None, softcap=None, sinks=0, save_residuals=True)
    out = {}

    def held(name, got, parts, tols):
        (o8, l8), (o4, l4) = parts
        plain = merge_two_partials(o8, l8, o4, l4)[0]
        tol = merge_tolerance(plain, (l8, l4), (o8, o4), (tols[0][0], tols[1][0]),
                              (tols[0][1], tols[1][1]))
        out[name] = {"err_over_tol": err_over_tol(got, plain, tol),
                     "max_abs_err": (got.float() - plain.float()).abs().max().item()}
        return plain

    # Decode: lengths below, at and past the boundary, bf16 q.
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    got = mixed_paged_decode_attention(q, state, lengths, t8, t4, bnd)
    len8, len4 = lengths.clamp(max=bnd), (lengths - bnd).clamp(min=0)
    p8 = dec._paged_decode_plain(q, *c8, len8, t8, **kw)
    p4 = dec._paged_decode_int4_plain(q, *c4, len4, t4, **kw)
    tol8 = decode_tolerance(p8[0], c8[1], c8[3])
    lse_tol8 = 1e-5 + 1e-6 * torch.nan_to_num(p8[1].double().abs(), posinf=0.0)
    tols4 = int4_tolerances(q, *c4, *p4, sm_scale=sm, softcap=None)
    held("mixed_decode", got, (p8, p4), ((tol8, lse_tol8), tols4))
    # Float attention over the dequantized mixed cache, one sequence at a time.
    f32 = torch.float32
    k = torch.cat([_dense_kv(c8[0], c8[2], t8, Hq, f32), _dense_kv(c4[0], c4[2], t4, Hq, f32)],
                  dim=2)
    v = torch.cat([_dense_kv(c8[1], c8[3], t8, Hq, f32), _dense_kv(c4[1], c4[3], t4, Hq, f32)],
                  dim=2)
    dev = 0.0
    for b in range(B):
        n = int(lengths[b])
        n8 = min(n, bnd)
        keep = torch.cat([torch.arange(bnd, device="cuda") < n8,
                          torch.arange(k.shape[2] - bnd, device="cuda") < n - n8])
        s = (q[b].float()[:, None] @ k[b, :, keep].transpose(-1, -2))[:, 0] * sm
        ref = (torch.softmax(s, dim=-1)[:, None] @ v[b, :, keep])[:, 0]
        dev = max(dev, (got[b].float() - ref).abs().max().item())
    out["mixed_decode"]["max_abs_dev_vs_float_dequant"] = dev
    del k, v
    # Prefill: one chunk of 512 rows at 128 (spanning the boundary: its INT4
    # rows start at -128), one past it at 1024, bf16 q.
    C = 512
    q = torch.randn((2, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    starts = torch.tensor([128, 1024], dtype=torch.int32, device="cuda")
    lengths = starts + C
    got = mixed_paged_prefill_attention(q, state, lengths, starts, t8[:2], t4[:2], bnd)
    len8, len4 = lengths.clamp(max=bnd), (lengths - bnd).clamp(min=0)
    p8 = pp._paged_prefill_plain(q, *c8, len8, starts, t8[:2], **kw)
    p4 = pp._paged_prefill_int4_plain(q, *c4, len4, starts - bnd, t4[:2], **kw)
    w8 = prefill_w_abs(q, c8, len8, starts, t8[:2], **kw)
    w4 = prefill_w_abs(q, c4, len4, starts - bnd, t4[:2], int4=True, **kw)
    tols8 = paged_prefill_tolerances(q, *c8, *p8, sm_scale=sm, softcap=None, w_abs=w8)
    tols4 = int4_tolerances(q, *c4, *p4, sm_scale=sm, softcap=None, w_abs=w4)
    held("mixed_prefill", got, (p8, p4), (tols8, tols4))
    return out


# The four fused w4a16 matmuls of one Llama-3-8B decoder layer (serve_w4):
# (name, in, out), group 128, halves packing, bf16 x at the serve_w4 batches.
W4_MAIN = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gateup", 4096, 28672),
           ("w_down", 14336, 4096))
W4_BATCHES = (8, 1, 32, 64)  # the first is the entry's headline; 64: serve_w4's prefill
# Off the main path: pairs packing, f32 x, groups 32/64, R = 5, 17 and 64,
# out widths with a tail (and not a multiple of 8 or 16: byte-wise loads),
# a layer > 0 of a 3-layer stack; bf16 x past 64 rows (two row tiles),
# scale groups of one k16 step (four a stage) and of fewer packed rows than
# a k16 step (the CUDA-core kernel takes bf16 x there).
#   (R, in, out, group, packing, f32 x, stacked layer or None)
W4_COVERAGE = (
    (5, 1024, 1000, 64, "pairs", False, None),
    (64, 2048, 768, 128, "halves", False, None),
    (3, 512, 333, 32, "pairs", True, None),
    (2, 768, 520, 64, "halves", True, 2),
    (1, 14336, 264, 128, "pairs", False, 1),
    (17, 256, 96, 32, "halves", False, None),
    (100, 1024, 776, 128, "pairs", False, None),
    (9, 768, 272, 32, "pairs", False, None),
    (4, 512, 200, 8, "halves", False, None),
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
         "splits": w4.split_k(R, in_dim // 2, n,
                              w4.tensor_core_route(x, w.group, w.packing))[1],
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


# --- The FlashAttention backward: rows 6 and 7 ------------------------------


def flash_bwd_tolerances(q, k, v, o, lse, do, dlse, offsets, grads, *, sm_scale, causal,
                         window, softcap, sinks):
    """Per-element tolerances (dq, dk, dv) of the two backward kernels
    against _flash_bwd_plain on the same inputs (o, lse, di and dlse equal
    on both sides: the wrapper's di prepass is the plain version's op).

    Both compute in f32 from the same values and differ in summation order
    (u = 2^-24): a raw dot Q·K or dO·V of D exact products by at most
    2(D+16) u |q||k|max (two orders, Cauchy-Schwarz), so s moves by e_s =
    (2D+33) u |q||k|max sm_scale (with its rounding), plus 2^-22 cap under
    softcap (tanh ulps). p = exp(s - lse) moves by p·delta, delta = 1.01 e_s
    + 2^-22 (1 + |lse|) + 2^-21 (exp ulps, the subtraction); dp by e_dp =
    2(D+16) u |dO||v|max. ds = p (dp - di) sm_scale (1 - th²) moves by A =
    p (a |dp - di| + sm_scale e_dp), a = sm_scale (delta + 2 e_s / cap under
    softcap + 4u). A gradient sums N terms: dQ = dS·K over Skv keys, dK =
    dSᵀQ and dV = PᵀdO over the group's G·Sq rows; it moves by the sum of
    the terms' errors times the other factor, plus 2(N+1) u of the sum of
    the terms' magnitudes (two summation orders). A bf16 gradient adds one
    bf16 ulp, 2^-7 (|g| + tol).

    bf16 inputs: both sides round p and ds to bf16 (round to nearest even)
    as the operands of dV = PᵀdO, dK = dSᵀQ and dQ = dS·K (the TPU's
    Precision.DEFAULT). Each side rounds its own f32 p and ds, which differ
    by the errors above, so two values that sit on either side of a
    rounding boundary round one bf16 ulp apart (at most 2^-7 of the
    magnitude, 8 significant bits) on top of that difference: a term's
    error grows by 2^-7 |p| (in dV) and 2^-7 |ds| (in dK and dQ), carried
    through the three sums as A is (times |dO|, |q| and |k|). Rounding
    never moves a value by more than half an ulp, so the magnitudes in the
    summation-order terms grow by at most 2^-8, far inside that term."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    u = 2.0**-24
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    di = fa._bwd_di(o, do, dlse)
    q_pos, k_pos = fa._bwd_positions(offsets, Sq, Skv)
    tols = [torch.zeros(x.shape, dtype=torch.float64, device=x.device) for x in grads]
    for h in range(Hkv):
        grp = slice(h * G, (h + 1) * G)
        qh, doh = q[:, grp].float(), do[:, grp].float()
        kh, vh = k[:, h].float(), v[:, h].float()
        p, dp, ds = fa._bwd_pairs(qh, kh, vh, doh, lse[:, grp], di[:, grp], q_pos, k_pos,
                                  sm_scale=sm_scale, causal=causal, window=window,
                                  softcap=softcap, sinks=sinks)
        kn = kh.norm(dim=-1).amax(dim=-1)[:, None, None]          # [B, 1, 1]
        vn = vh.norm(dim=-1).amax(dim=-1)[:, None, None]
        e_s = (2 * D + 33) * u * qh.norm(dim=-1) * kn * sm_scale  # [B, G, Sq]
        if softcap is not None:
            e_s = e_s + 2.0**-22 * softcap
        lse_h = torch.nan_to_num(lse[:, grp].float().abs(), posinf=0.0)
        delta = 1.01 * e_s + 2.0**-22 * (1.0 + lse_h) + 2.0**-21
        a = delta + 4 * u + (2.0 * e_s / softcap if softcap is not None else 0.0)
        e_dp = 2 * (D + 16) * u * doh.norm(dim=-1) * vn
        A = p * (sm_scale * a[..., None] * (dp - di[:, grp, :, None]).abs()
                 + sm_scale * e_dp[..., None])
        e_p = p * delta[..., None]
        if q.dtype == torch.bfloat16:
            A = A + 2.0**-7 * ds.abs()
            e_p = e_p + 2.0**-7 * p
        g_kv, g_q = 2 * (Skv + 1) * u, 2 * (G * Sq + 1) * u
        ka, qa, da = kh.abs()[:, None], qh.abs(), doh.abs()
        tols[0][:, grp] = (A @ ka + g_kv * (ds.abs() @ ka)).double()
        tols[1][:, h] = (torch.einsum("bgqk,bgqd->bkd", A, qa)
                         + g_q * torch.einsum("bgqk,bgqd->bkd", ds.abs(), qa)).double()
        tols[2][:, h] = (torch.einsum("bgqk,bgqd->bkd", e_p, da)
                         + g_q * torch.einsum("bgqk,bgqd->bkd", p, da)).double()
        del p, dp, ds, A, e_p
    if q.dtype == torch.bfloat16:
        tols = [t + 2.0**-7 * (g.double().abs() + t) for t, g in zip(tols, grads)]
    return tols


def _flash_bwd_check(q, k, v, offsets, do, dlse=None, *, causal, window=None, sinks=0,
                     softcap=None):
    """The float flash forward on the card (its o and lse), then the two
    backward launches against _flash_bwd_plain: (kernel grads, plain grads,
    [dq, dk, dv] err_over_tol, [launch of dK/dV, of dQ], plain call, lse,
    whether a second pair of launches gave the same bits)."""
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, causal=causal, window=window, softcap=softcap, sinks=sinks)
    o, lse = fa._flash_fwd_cuda(q, k, v, offsets, block_kv=min(1024, k.shape[2]),
                                save_residuals=True, **kw)
    launches, grads, operands = fa._flash_bwd_launch(q, k, v, o, lse, do, offsets, dlse, **kw)
    for kernel, args in launches:
        kernel(*args)
    torch.cuda.synchronize()
    same_bits = _same_bits_again(lambda: [kernel(*args) for kernel, args in launches], grads)
    # Each launch closure holds the operands (the di prepass among them),
    # whose memory its raw pointers name.
    launches = [lambda kernel=kernel, args=args, keep=operands: kernel(*args)
                for kernel, args in launches]
    plain = fa._flash_bwd_plain(q, k, v, o, lse, do, offsets, dlse, **kw)
    tols = flash_bwd_tolerances(q, k, v, o, lse, do, dlse, offsets, plain, **kw)
    ratios = [err_over_tol(g, p, t) for g, p, t in zip(grads, plain, tols)]
    return (grads, plain, ratios, launches,
            lambda: fa._flash_bwd_plain(q, k, v, o, lse, do, offsets, dlse, **kw), lse, same_bits)


def _sdpa_bwd(q, k, v, do, *, is_causal):
    """(ms, backend) of SDPA's backward in bf16 on these inputs, K/V
    expanded to the q heads beforehand (untimed): the time of
    torch.autograd.grad through one call minus the time of the call alone,
    the first of the flash, memory-efficient and cuDNN backends that takes
    them. One call computes dQ, dK and dV. The port never calls it."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = q.shape[1] // k.shape[1]
    qb, kb, vb = (x.to(torch.bfloat16).repeat_interleave(r, dim=1).detach().requires_grad_()
                  for x, r in ((q, 1), (k, group), (v, group)))
    dob = do.to(torch.bfloat16)

    def fwd():
        return sdpa(qb, kb, vb, is_causal=is_causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qb, kb, vb), dob)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                fwd_bwd()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            both = cuda_ms(fwd_bwd, iters=10)
            alone = cuda_ms(fwd, iters=10)
        return both - alone, backend.name
    return None, None


# The training step's attention: Llama-3-8B heads, 2048 tokens, bf16, causal.
BWD_MAIN = dict(B=1, H=32, Hkv=8, S=2048, D=128)


def _flash_bwd_cases(g):
    """Rows 6 and 7 at the training step's shape with a seeded random dO:
    check, kernel / plain / SDPA-backward times, each kernel's bound."""
    import torch
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    B, H, Hkv, S, D = (BWD_MAIN[x] for x in ("B", "H", "Hkv", "S", "D"))
    bf = torch.bfloat16
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(bf)
    k, v = torch.randn((2, B, Hkv, S, D), generator=g, device="cuda").to(bf)
    do = torch.randn((B, H, S, D), generator=g, device="cuda").to(bf)
    grads, plain, ratios, launches, plain_call, _, same_bits = _flash_bwd_check(
        q, k, v, _offsets(0, 0, B, q.device), do, causal=True)
    plain_ms = cuda_ms(plain_call, iters=1, warmup=1)
    lib_ms, backend = _sdpa_bwd(q, k, v, do, is_causal=True)
    pairs = B * H * _visible_pairs(S, S, True)
    rows = 2 * B * H * S * D * 2                        # q and dO, bf16
    kv = 2 * B * Hkv * S * D * 2                        # k and v (dK, dV the same)
    stats = 2 * B * H * S * 4                           # lse and di, f32
    shape = dict(BWD_MAIN, causal=True, dtype="bfloat16")
    entries = []
    for (name, replaces, ops, nbytes, idx), launch in zip((
            ("flash_bwd_dkv", "quantizedmha_tpu/ops/flash_attention.py:507",
             {"bf16": 8 * pairs * D, "exp": pairs}, rows + kv + stats + kv, (1, 2)),
            ("flash_bwd_dq", "quantizedmha_tpu/ops/flash_attention.py:600",
             {"bf16": 6 * pairs * D, "exp": pairs},
             rows + kv + stats + B * H * S * D * 2, (0,))), launches):
        ms = cuda_ms(launch, iters=5)
        bms, by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": "quantizedmha_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max((grads[i].float() - plain[i].float()).abs().max().item()
                               for i in idx),
            "err_over_tol": max(ratios[i] for i in idx), "same_bits_twice": same_bits,
            "ok": max(ratios[i] for i in idx) <= 1.0 and same_bits, "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_backend": backend,
            "library_note": ("SDPA backward in bf16 (K/V expanded to the q heads): one call "
                             "computes dQ, dK and dV; plain_ms is _flash_bwd_plain, both "
                             "kernels' work")})
    return entries


# Small cases off the training path, each kernel against plain on the card:
# f32, d 32/64, MQA, group 1, cross attention at unaligned lengths, a window
# smaller than a tile with and without sinks that end mid-tile, softcap,
# per-batch offsets with fully masked rows, a non-zero dlse.
#   (B, H, Hkv, Sq, Skv, D, causal, window, sinks, softcap, bf16,
#    per-batch (q_off, kv_off) or None for end-aligned, dlse)
FLASH_BWD_COVERAGE = (
    (2, 4, 2, 100, 190, 32, False, None, 0, None, False, None, False),
    (1, 4, 1, 130, 130, 64, True, None, 0, None, True, None, False),
    (1, 4, 4, 96, 96, 128, True, None, 0, None, False, None, False),
    (1, 2, 2, 200, 392, 64, False, None, 0, None, True, None, False),
    (1, 4, 2, 150, 150, 64, True, 40, 0, None, True, None, False),
    (1, 4, 2, 150, 200, 64, True, 40, 37, None, True, None, False),
    (1, 8, 2, 77, 77, 32, True, None, 0, 20.0, True, None, False),
    (1, 4, 2, 64, 96, 32, True, 24, 5, 10.0, False, None, False),
    (2, 4, 2, 64, 100, 64, True, None, 0, None, False, ((30, 0), (0, 20)), False),
    (1, 4, 2, 90, 90, 128, True, None, 0, None, True, None, True),
    (1, 2, 1, 70, 120, 32, True, 16, 0, None, False, ((10, 40),), True),
)


def _coverage_bwd(g):
    """FLASH_BWD_COVERAGE: {case: [dq, dk, dv] err_over_tol}; a row whose
    lse is -inf (it sees no key) must get dq exactly 0, and a second pair of
    launches must give the same bits (inf appended otherwise)."""
    import torch
    ratios = {}
    for i, (B, H, Hkv, Sq, Skv, D, causal, window, sinks, cap, bf16, offs,
            with_dlse) in enumerate(FLASH_BWD_COVERAGE):
        dt = torch.bfloat16 if bf16 else torch.float32
        q = (torch.randn((B, H, Sq, D), generator=g, device="cuda") * 1.5).to(dt)
        k, v = torch.randn((2, B, Hkv, Skv, D), generator=g, device="cuda").to(dt)
        do = torch.randn((B, H, Sq, D), generator=g, device="cuda").to(dt)
        dlse = torch.randn((B, H, Sq), generator=g, device="cuda") if with_dlse else None
        if offs is None:
            offsets = torch.tensor([[Skv - Sq, 0]] * B, dtype=torch.int32, device="cuda")
        else:
            offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
        grads, _, r, _, _, lse, same_bits = _flash_bwd_check(
            q, k, v, offsets, do, dlse, causal=causal, window=window, sinks=sinks, softcap=cap)
        empty = torch.isinf(lse)
        if empty.any() and not bool((grads[0][empty] == 0).all()):
            r = r + [float("inf")]
        if not same_bits:
            r = r + [float("inf")]
        ratios[f"flash_bwd{i}"] = r
    return ratios


def phase_kernels(st):
    import torch
    from quantizedmha_tpu_torch.ops import flash_attention as fa
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
    int8_p = _flash_case("flash_int8_fwd[int8_p]", 0, qp, kp, vp, 256, True,
                         replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                         library=True)
    # serve_w4's prefill (most of the kernel's launches): 512-token prompts,
    # one a launch, block_kv = min(1024, 512); drawn from its own generator,
    # so that every other kernel keeps its inputs.
    g4 = torch.Generator(device="cuda").manual_seed(13)
    q4 = torch.randn((1, 32, 512, 128), generator=g4, device="cuda").to(torch.bfloat16)
    k4, v4 = torch.randn((2, 1, 8, 512, 128), generator=g4, device="cuda").to(torch.bfloat16)
    w4_prefill = _flash_case("flash_int8_fwd[int8_p]", 0, q4, k4, v4, 512, True,
                             replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                             library=True)
    del q4, k4, v4
    # The prefill bench's attention: 2048 tokens, block_kv as prefill_at
    # picks it (pick_blocks: min(1024, 2048)); its own generator too.
    g2 = torch.Generator(device="cuda").manual_seed(15)
    q2 = torch.randn((1, 32, PREFILL_BENCH_LEN, 128), generator=g2,
                     device="cuda").to(torch.bfloat16)
    k2, v2 = torch.randn((2, 1, 8, PREFILL_BENCH_LEN, 128), generator=g2,
                         device="cuda").to(torch.bfloat16)
    bench_prefill = _flash_case("flash_int8_fwd[int8_p]", 0, q2, k2, v2,
                                fa.pick_blocks(PREFILL_BENCH_LEN, PREFILL_BENCH_LEN, 128)[1],
                                True, replaces="quantizedmha_tpu/ops/flash_attention_int8.py:80",
                                library=True)
    del q2, k2, v2
    sub_keys = ("max_abs_err", "err_over_tol", "same_bits_twice", "ok", "shape", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
    int8_p["serve_w4"] = {k: w4_prefill[k] for k in sub_keys}
    int8_p["prefill_bench"] = {k: bench_prefill[k] for k in sub_keys}
    int8_p["ok"] = int8_p["ok"] and w4_prefill["ok"] and bench_prefill["ok"]
    cases = [
        int8_p,
        _flash_case("flash_int8_fwd[bf16_p]", 1, qs, ks, vs, 512, False,
                    replaces="quantizedmha_tpu/ops/flash_attention_int8.py:437",
                    library=True),
    ]
    # DECODE_MAIN: serve's shape is the entry; the same CUDA kernel stands
    # for the per-kv-head grid form used for MQA (no 8B path gives it
    # Hkv=1) and runs serve_flash's deep decode: both checked and timed
    # here and reported inside the paged_decode entry.
    serve, mqa, deep = (
        _decode_case("paged_decode", hkv, seed=seed, lengths=lens, max_pages=slots,
                     replaces="quantizedmha_tpu/ops/decode.py:" + ("53" if hkv == 1 else "527"))
        for hkv, seed, lens, slots in DECODE_MAIN.values())
    cases.append(serve)
    keys = ("replaces", "max_abs_err", "err_over_tol", "ok", "same_bits_twice", "shape", "ms",
            "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend")
    cases[-1]["also_replaces"] = mqa["replaces"]
    cases[-1]["mqa"] = {k: mqa[k] for k in keys}
    cases[-1]["serve_flash"] = {k: deep[k] for k in keys}
    cases[-1]["ok"] = cases[-1]["ok"] and mqa["ok"] and deep["ok"]
    cases.append(_w4_kernels(g))
    # The float flash kernel: the serve_flash bucketed prefill (bf16, a
    # 2048 bucket, Llama-3-8B heads, causal) and solve's fa / fa_bf16 rungs
    # (N=8192, 32 heads of d=32, not causal), the bf16 one reported inside
    # the bf16 entry.
    qf = torch.randn((1, 32, 2048, 128), generator=g, device="cuda").to(torch.bfloat16)
    kf, vf = torch.randn((2, 1, 8, 2048, 128), generator=g, device="cuda").to(torch.bfloat16)
    fwd = _flash_fwd_case("flash_fwd[bf16]", qf, kf, vf, True, label="serve_flash prefill",
                          replaces="quantizedmha_tpu/ops/flash_attention.py:124")
    del qf, kf, vf
    solve_bf16 = _flash_fwd_case("flash_fwd[bf16]", *(x.to(torch.bfloat16) for x in (qs, ks, vs)),
                                 False, label="solve fa_bf16",
                                 replaces="quantizedmha_tpu/ops/flash_attention.py:124")
    fwd["solve"] = {k: solve_bf16[k] for k in ("max_abs_err", "err_over_tol", "same_bits_twice",
                                               "ok", "shape", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "library_backend")}
    fwd["ok"] = fwd["ok"] and solve_bf16["ok"]
    cases.append(fwd)
    cases.append(_flash_fwd_case("flash_fwd[f32]", qs, ks, vs, False, label="solve fa",
                                 replaces="quantizedmha_tpu/ops/flash_attention.py:124"))
    cases.append(_paged_prefill_case(g, replaces="quantizedmha_tpu/ops/paged_prefill.py:63"))
    # The INT4 kernels of the mixed cache at serve_mixed's shapes.
    cases.append(_int4_prefill_case(g))
    cases.append(_int4_decode_case(g))
    # The training step's backward: rows 6 (dK/dV) and 7 (dQ).
    cases += _flash_bwd_cases(g)
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


# One line of a kernel source changed: (file under csrc/, what the fault
# does, the line as committed, the line planted). Each must fail the kernels
# phase's checks (main shapes and coverage cases, err_over_tol > 1) of every
# float kernel built from that file.
PLANTED_FAULTS = (
    ("flash_fwd.cu", "kv edge unmasked (keys past Skv kept)",
     "bool valid = kloc < p.Skv;", "bool valid = true;"),
    ("flash_fwd.cu", "bf16 P·V: each k16 step of P against the V rows of the neighbouring step",
     "for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(vt, 16 * kk));",
     "for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(vt, 16 * (kk ^ 1)));"),
    ("flash_fwd.cu", "bf16: P's two keys swapped when packed to the A fragment",
     "const __nv_bfloat162 pb = __floats2bfloat162_rn(sc[nt][2 * r], sc[nt][2 * r + 1]);",
     "const __nv_bfloat162 pb = __floats2bfloat162_rn(sc[nt][2 * r + 1], sc[nt][2 * r]);"),
    ("flash_fwd.cu", "bf16: next key tile copied into the stage being read",
     "issue(t0, s);", "issue(t0, (n + 1) % R::STAGES);"),
    ("flash_fwd.cu", "bf16: acc not rescaled when a row's max moved",
     "if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {", "if (false) {"),
    ("flash_fwd.cu", "bf16: a folded row's Q taken from the group's next q head",
     "const int gi = hc * p.GB + br / p.NQ;  // the row's q head within the group",
     "const int gi = min(hc * p.GB + br / p.NQ + 1, p.G - 1);"),
    ("flash_fwd.cu", "bf16: a tile taken as wholly visible when the warp's last row sees it",
     "range_unmasked(p, wspan.x, wspan.y, k_first, kv_off + t0 + BKV - 1, t0 + BKV - 1);",
     "range_unmasked(p, wspan.y, wspan.y, k_first, kv_off + t0 + BKV - 1, t0 + BKV - 1);"),
    ("flash_fwd.cu", "f32: Q's third piece dropped (S without q2·k0)",
     "qk(2, 0);  // q2·k0: Q's third piece", ";"),
    ("flash_fwd.cu", "f32: K's third piece dropped (S without q0·k2)",
     "qk(0, 2);  // q0·k2: K's third piece", ";"),
    ("flash_fwd.cu", "f32: P's third piece dropped (P·V without p2·v0)",
     "pvp(2, 0);  // p2·v0: P's third piece", ";"),
    ("flash_fwd.cu", "f32: V's third piece dropped (P·V without p0·v2)",
     "pvp(0, 2);  // p0·v2: V's third piece", ";"),
    ("flash_fwd.cu", "f32: a1 taken as bf16(a) − a0, not the exact residual a − a0",
     "const float2 r1 = make_float2(x - __low2float(h0), y - __high2float(h0));",
     "const float2 r1 = make_float2(__low2float(h0) - __low2float(h0), "
     "__high2float(h0) - __high2float(h0));"),
    ("flash_fwd.cu", "f32: V's planes copied from K's",
     "cp_async16(st + R::plane(3 + j) + sw(r, c), vg + j * kv_plane + src, ok);",
     "cp_async16(st + R::plane(3 + j) + sw(r, c), kg + j * kv_plane + src, ok);"),
    ("flash_fwd.cu", "f32: next key tile copied into the stage being read",
     "copy_tile(t0, s);", "copy_tile(t0, (n + 1) % R::STAGES);"),
    ("flash_fwd.cu", "f32: acc not rescaled when a row's max moved",
     "if (__any_sync(0xffffffffu, (alpha[0] != 1.f) | (alpha[1] != 1.f))) {", "if (false) {"),
    ("flash_fwd.cu", "f32: a folded row's Q taken from the group's next q head",
     "const int head = hc * p.GB + br / p.NQ;  // the row's q head in the group",
     "const int head = min(hc * p.GB + br / p.NQ + 1, p.G - 1);"),
    ("flash_fwd.cu", "f32: a tile taken as wholly visible when the warp's last row sees it",
     "const bool unmasked = range_unmasked(p, span.x, span.y, k_first,",
     "const bool unmasked = range_unmasked(p, span.y, span.y, k_first,"),
    ("flash_fwd.cu", "f32: a tile's P·V never added to acc",
     "for (int e = 0; e < 4; ++e) acc[c][e] += pacc[c][e];", "for (int e = 0; e < 4; ++e) ;"),
    ("flash_fwd.cu", "f32 split pass: V's last 32 values (its last row at d=32) left unwritten",
     "const size_t chunks = (nq + 2 * nkv) / 8;", "const size_t chunks = (nq + 2 * nkv) / 8 - 4;"),
    ("f32_tile.cuh", "f32 tile: each thread's own tile max, not the row's",
     "const float m_next = fmaxf(m[i], row_max16(mt));", "const float m_next = fmaxf(m[i], mt);"),
    ("paged_prefill.cu", "diagonal masked (kpos < qpos; both routes)",
     "bool valid = kpos <= qpos && kpos < kend;", "bool valid = kpos < qpos && kpos < kend;"),
    ("paged_prefill.cu", "bf16: V scale of the next physical page",
     "cp_async4(sk + BK + gtid, p.vs + sidx, ok);", "cp_async4(sk + BK + gtid, p.vs + sidx + 1, ok);"),
    ("paged_prefill.cu", "window one key wider (kpos >= qpos - window; both routes)",
     "if (p.window >= 0) valid &= kpos > qpos - p.window || kpos < p.sinks;",
     "if (p.window >= 0) valid &= kpos >= qpos - p.window || kpos < p.sinks;"),
    ("paged_prefill.cu", "bf16: P's two keys swapped when packed to the A fragment",
     "__floats2bfloat162_rn(sc[n][2 * r] * vc[n][0], sc[n][2 * r + 1] * vc[n][1]));",
     "__floats2bfloat162_rn(sc[n][2 * r + 1] * vc[n][1], sc[n][2 * r] * vc[n][0]));"),
    ("paged_prefill.cu", "bf16: next key tile copied into the stage being converted",
     "if (tn < rows.kend) issue(tn, buf ^ 1);", "if (tn < rows.kend) issue(tn, buf);"),
    ("paged_prefill.cu", "bf16: K scales of the key pair two columns on",
     "const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * n + 2 * t);",
     "const float2 k2 = *reinterpret_cast<const float2*>(sk + ((8 * n + 2 * t + 2) & (BK - 1)));"),
    ("paged_prefill.cu", "bf16: a tile taken as wholly visible when the warp's last row sees it",
     "const bool unmasked = t0 + BK <= rows.kend && t0 + BK - 1 <= wq_lo &&",
     "const bool unmasked = t0 + BK <= rows.kend && t0 + BK - 1 <= wq_hi &&"),
    ("int4.cuh", "high nibble shifted as unsigned (0..15, not -8..7)",
     "__device__ __forceinline__ int int4_hi(int b) { return b >> 4; }",
     "__device__ __forceinline__ int int4_hi(int b) { return (b & 0xff) >> 4; }"),
    ("paged_decode.cu", "INT4 sub-tile scale index off by one",
     "const int sub = t / sub_w;", "const int sub = (t / sub_w + 1) % p.subs;"),
    ("paged_prefill.cu", "negative q_start clamped to 0 (both routes)",
     "const int qstart = p.qstarts[b];", "const int qstart = max(p.qstarts[b], 0);"),
    ("paged_decode.cu", "empty row's lse 0, not -inf",
     "return l == 0.f ? -INFINITY : m + logf(fmaxf(l, 1e-38f));",
     "return l == 0.f ? 0.f : m + logf(fmaxf(l, 1e-38f));"),
    ("paged_decode.cu", "a split's page range one page too long (pages counted twice)",
     "const int p_end = min(p_begin + p.pages_per_split, n_pages);",
     "const int p_end = min(p_begin + p.pages_per_split + 1, n_pages);"),
    ("paged_decode.cu", "merge without a split's rescale",
     "const float w = expf(ms - mx);", "const float w = 1.f;"),
    ("paged_decode.cu", "an empty split's m taken as 0",
     "p.ml[mslot + g] = -INFINITY;", "p.ml[mslot + g] = 0.f;"),
    ("paged_decode.cu", "a split's sums written to the neighbouring split's slot",
     "p.part[((size_t(s) * p.B + b) * p.Hq + hq0) * D + e] = sum;",
     "p.part[((size_t((s + 1) % p.splits) * p.B + b) * p.Hq + hq0) * D + e] = sum;"),
    ("paged_decode.cu", "next page copied into the stage being read",
     "if (nxt < p_end) issue(nxt, buf ^ 1);", "if (nxt < p_end) issue(nxt, buf);"),
    ("paged_decode.cu", "scores' reduce-scatter: the two head pairs swapped",
     "hoff = up ? 2 : 0;", "hoff = up ? 0 : 2;"),
    ("paged_decode.cu", "INT4 high nibbles not re-biased (read as n + 8)",
     "hi[c] = __uint_as_float(__byte_perm(hb, 0x4B000000u, 0x7540 + c)) - 8388616.f;",
     "hi[c] = __uint_as_float(__byte_perm(hb, 0x4B000000u, 0x7540 + c)) - 8388608.f;"),
    ("paged_decode.cu", "window's first page skipped one page too far",
     "w0 = max(length - p.window, 0) / P;", "w0 = max(length - p.window, 0) / P + 1;"),
    ("flash_bwd.cu", "bf16 dK/dV: the group's last q head left out of the sum",
     "const bool more = hd_next < group;", "const bool more = hd_next < group - 1;"),
    ("flash_bwd.cu", "softcap's 1 - tanh² chain factor dropped",
     "if (capped) ds *= 1.f - th * th;", "if (capped) ds *= 1.f;"),
    ("flash_bwd.cu", "dlse folded with the wrong sign (di + dlse: f32, bf16 dQ)",
     "if (p.dlse != nullptr) d = d - p.dlse[at];", "if (p.dlse != nullptr) d = d + p.dlse[at];"),
    ("flash_bwd.cu", "bf16 dK/dV: dlse folded with the wrong sign",
     "const float dr = st_s[BR + r] - st_s[2 * BR + r];",
     "const float dr = st_s[BR + r] + st_s[2 * BR + r];"),
    ("flash_bwd.cu", "window one key wider (qpos - kpos <= window)",
     "bool in_win = (qpos - kpos) < p.window;", "bool in_win = (qpos - kpos) <= p.window;"),
    ("flash_bwd.cu", "bf16: P/dS packed into the A operand with its halves swapped",
     "__floats2bfloat162_rn(x[2 * kk + hh][2 * r], x[2 * kk + hh][2 * r + 1]);",
     "__floats2bfloat162_rn(x[2 * kk + hh][2 * r + 1], x[2 * kk + hh][2 * r]);"),
    ("flash_bwd.cu", "bf16 dK/dV: lse/di of the transposed tile's q row from the key half",
     "const int r = 32 * h + 8 * n + 2 * t + (e & 1);",
     "const int r = 32 * h + 8 * n + 2 * t + (e >> 1);"),
    ("flash_bwd.cu", "bf16 dK/dV: next Q/dO tile copied into the stage being read (stale reads)",
     "if (more) issue(hd_next, q_next, buf ^ 1);", "if (more) issue(hd_next, q_next, buf);"),
    ("w4_matmul.cu", "bf16: the high plane's scales from the next group (the last one's own)",
     "const size_t src = ok ? size_t(g0 + slot + plane * hi_goff) * p.n + col : 0;",
     "const size_t src = ok ? size_t(min(g0 + slot + plane * (hi_goff + 1), "
     "in_dim / p.group - 1)) * p.n + col : 0;"),
    ("w4_matmul.cu", "bf16: the low plane's +8 storage bias left in",
     "return __uint_as_float(bits) - float((1 << (23 - O)) + 8);",
     "return __uint_as_float(bits) - float((1 << (23 - O)) + (HI ? 8 : 0));"),
    ("w4_matmul.cu", "split-K: the second split's partial sums dropped (both routes)",
     "for (int s = 1; s < splits; ++s) v += ws[size_t(s) * total + e];",
     "for (int s = 1; s < splits; ++s) v += s == 1 ? 0.f : ws[size_t(s) * total + e];"),
    ("w4_matmul.cu", "bf16: A fragment's k pair swapped (packed rows 2t and 2t+1)",
     "a[0][0] = weight_pair<HI, 0>(w0, v0, w1, v1, s.x, mk);",
     "a[0][0] = weight_pair<HI, 0>(w1, v1, w0, v0, s.x, mk);"),
    ("w4_matmul.cu", "bf16: the low plane's nibbles read as two's complement",
     "constexpr uint32_t MAGIC = (uint32_t(150 - O) << 23) | (HI ? 8u << O : 0u);",
     "constexpr uint32_t MAGIC = (uint32_t(150 - O) << 23) | (8u << O);"),
    ("w4_matmul.cu", "bf16: the next stage's packed tile read (not yet landed)",
     "const unsigned char* pt = packed_tile(s) + 2 * t * PROW + colw;",
     "const unsigned char* pt = packed_tile((n + 1) % R::STAGES) + 2 * t * PROW + colw;"),
    ("w4_matmul.cu", "bf16: output columns permuted (tile 0's row g + 8 and tile 1's row g swapped)",
     "const float v[4] = {acc[0][i][u], acc[0][i][2 + u], acc[1][i][u], acc[1][i][2 + u]};",
     "const float v[4] = {acc[0][i][u], acc[1][i][u], acc[0][i][2 + u], acc[1][i][2 + u]};"),
    ("wgmma_s8.cuh", "bf16 P: s8 operands' k32 step advanced 16 bytes, not 32 (d >= 64)",
     "  return sw128_desc(tile + 32 * kc);", "  return sw128_desc(tile + 16 * kc);"),
    ("flash_int8_fwd.cu", "bf16 P: scores converted as unsigned (negative ones near 2^32)",
     "__device__ __forceinline__ float s32_to_f32(int s) { return static_cast<float>(s); }",
     "__device__ __forceinline__ float s32_to_f32(int s) { return static_cast<float>(unsigned(s)); }"),
    ("flash_int8_fwd.cu", "bf16 P: V converted as unsigned (biased by 128)",
     "  const uint32_t u = w ^ 0x80808080u;", "  const uint32_t u = w;"),
    ("flash_int8_fwd.cu", "bf16 P: the ones column zero (l dropped)",
     "          make_uint4(BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES);",
     "          make_uint4(0u, 0u, 0u, 0u);"),
    ("flash_int8_fwd.cu", "bf16 P: an item's K and V copied into the next stage (stale reads)",
     "          issue(t0, kb1, sweep == 1, s);",
     "          issue(t0, kb1, sweep == 1, (n + 1) % R::STAGES);"),
    ("flash_int8_fwd.cu", "bf16 P: V scale of the next quant block",
     "    const float v_scale = p.vs[sidx];",
     "    const float v_scale = p.vs[qb + 1 < p.nkv ? sidx + 1 : sidx];"),
    ("flash_int8_fwd.cu", "bf16 P: keys past a clipped tile's quant block kept",
     "const bool keep = kloc < tend && pair_valid(p, qpos_r[r], kv_off + kloc, kloc);",
     "const bool keep = pair_valid(p, qpos_r[r], kv_off + kloc, kloc);"),
    ("flash_int8_fwd.cu", "bf16 P: a warp's tile taken as mask-free when its last row sees it whole",
     "range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1);",
     "range_unmasked(p, wq_last, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1);"),
    ("flash_int8_fwd.cu", "bf16 P: each k16 step of P against the V rows of the neighbouring step",
     "for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(pv, a[kk], tile_desc_mn(vt, 16 * kk));",
     "for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(pv, a[kk], tile_desc_mn(vt, 16 * (kk ^ 1)));"),
    ("flash_int8_fwd.cu", "bf16 P: acc not rescaled by alpha (rows g)",
     "make_float4(x.x * alpha[0] + pv[c][0] * v_scale, x.y * alpha[0] + pv[c][1] * v_scale,",
     "make_float4(x.x + pv[c][0] * v_scale, x.y + pv[c][1] * v_scale,"),
    ("flash_int8_fwd.cu", "int8 P: Vᵀ's keys one step off (lane t's P against lane t + 1's keys)",
     "*reinterpret_cast<uint32_t*>(vt_of(s) + sw8(d, x.q) + 4 * x.ut) = col[k];",
     "*reinterpret_cast<uint32_t*>(vt_of(s) + sw8(d, x.q) + 4 * ((x.ut + 1) & 3)) = col[k];"),
    ("flash_int8_fwd.cu", "int8 P: P truncated, not rounded to nearest even",
     "x[u] = __float_as_uint(__fadd_rn(pe[u], 12582912.f));",
     "x[u] = __float_as_uint(__fadd_rz(pe[u], 12582912.f));"),
    ("flash_int8_fwd.cu", "int8 P: l sums the rounded P, not the f32 P'",
     "lsum[r] += (pe[0] + pe[1]) + (pe[2] + pe[3]);",
     "lsum[r] += (rintf(pe[0]) + rintf(pe[1])) + (rintf(pe[2]) + rintf(pe[3]));"),
    ("flash_int8_fwd.cu", "int8 P: V scale of the next quant block",
     "    const float vsc = p.vs[sidx];",
     "    const float vsc = p.vs[qb + 1 < p.nkv ? sidx + 1 : sidx];"),
    ("flash_int8_fwd.cu", "int8 P: acc not rescaled by alpha",
     "acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], static_cast<float>(pvi[j][e]) * vsc);",
     "acc[j][e] = acc[j][e] + static_cast<float>(pvi[j][e]) * vsc;"),
    ("flash_int8_fwd.cu", "int8 P: keys past a clipped tile's quant block kept",
     "const bool keep = kloc < tend && pair_valid(p, qp[r], kv_off + kloc, kloc);",
     "const bool keep = pair_valid(p, qp[r], kv_off + kloc, kloc);"),
    ("flash_int8_fwd.cu", "int8 P: a warp's tile taken as mask-free when its last row sees it whole",
     "tend - t0 == TK && range_unmasked(p, wlo, whi, kv_off + t0, kv_off + tend - 1, tend - 1);",
     "tend - t0 == TK && range_unmasked(p, whi, whi, kv_off + t0, kv_off + tend - 1, tend - 1);"),
    ("flash_int8_fwd.cu", "int8 P: an item's K and V copied into the next stage (stale reads)",
     "          copy_item(t0, kb1, sw == 1, s);",
     "          copy_item(t0, kb1, sw == 1, (n + 1) % R::STAGES);"),
)
# The kernel sources the faults are held to, and the prefixes of their
# coverage cases.
FAULT_SOURCES = {"flash_fwd": ("flash_fwd",), "paged_prefill": ("paged_prefill",),
                 "paged_decode": ("decode", "paged_decode"), "flash_bwd": ("flash_bwd",),
                 "w4_matmul": ("w4",), "flash_int8_fwd": ("fa8_",)}


def _decode_coverage_ratios(g):
    """DECODE_COVERAGE: the INT8 decode kernel against plain on the card,
    each case launched twice, {case: [output, lse] err_over_tol} (a third
    entry, inf, when the second launch's bits differ)."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    ratios = {}
    for i, (B, Hq, Hkv, D, P, window, sinks, cap, qbf16, max_pages, lens,
            neg) in enumerate(DECODE_COVERAGE):
        num_pages = B * max_pages + 1
        lengths = torch.randint(1, P * max_pages + 1, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        if lens is not None:
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        tables = (torch.randperm(num_pages - 1, generator=g, device="cuda")[:B * max_pages]
                  + 1).reshape(B, max_pages).to(torch.int32)
        k_pages, v_pages = torch.randint(-127, 128, (2, Hkv, num_pages, P, D), generator=g,
                                         device="cuda", dtype=torch.int8)
        k_scales, v_scales = torch.rand((2, Hkv, num_pages), generator=g, device="cuda") * 0.05
        dt = torch.bfloat16 if qbf16 else torch.float32
        q = torch.randn((B, Hq, D), generator=g, device="cuda")
        if neg:
            q, k_pages = -(q.abs() + 1.0) * 400.0, k_pages.abs() + 1
        q = q.to(dt)
        kw = dict(sm_scale=D**-0.5, window=window, softcap=cap, sinks=sinks,
                  save_residuals=True)
        operands = (q, k_pages, v_pages, k_scales, v_scales, lengths, tables)
        kernel, args, (out, lse), _operands = dec._paged_decode_launch(*operands, **kw)
        kernel(*args)
        torch.cuda.synchronize()
        same = _same_bits_again(lambda: kernel(*args), (out, lse))
        p_out, p_lse = dec._paged_decode_plain(*operands, **kw)
        if neg:
            # Scores of hundreds: their summation-order error counts (score_err).
            tol, lse_tol = paged_prefill_tolerances(q, k_pages, v_pages, k_scales, v_scales,
                                                    p_out, p_lse, sm_scale=D**-0.5,
                                                    softcap=cap)
        else:
            tol = decode_tolerance(p_out, v_pages, v_scales)
            # lse: f32 on both sides, summation order only.
            lse_tol = 1e-5 + 1e-6 * torch.nan_to_num(p_lse.double().abs(), posinf=0.0)
        ratios[f"decode{i}"] = [err_over_tol(out, p_out, tol), err_over_tol(lse, p_lse, lse_tol)]
        if not same:
            ratios[f"decode{i}"].append(float("inf"))
    return ratios


def _w4_fault_ratios(g, g5):
    """w4_matmul's checks with whatever library is bound: ({W4_MAIN matmul
    at R = 8 and 32: [err_over_tol vs plain, vs golden]}, {W4_COVERAGE
    case: [the same]}); a second launch with other bits adds inf."""
    import torch
    from quantizedmha_tpu_torch.quant.weights import quantize_weight4

    def ratios(x, w, layer=None):
        e = _w4_case(x, w, layer, timed=False)
        return [e["err_over_tol"], e["golden_err_over_tol"]] + (
            [] if e["bitwise_repeat"] else [float("inf")])
    main = {}
    for name, in_dim, n in W4_MAIN:
        w = quantize_weight4(torch.randn((in_dim, n), generator=g, device="cuda") * in_dim**-0.5,
                             group=128, packing="halves")
        for R in (8, 32):
            x = torch.randn((R, in_dim), generator=g, device="cuda").to(torch.bfloat16)
            main[f"{name} R={R}"] = ratios(x, w)
    cov = {}
    for i, (R, in_dim, n, group, packing, f32, layer) in enumerate(W4_COVERAGE):
        shape = (in_dim, n) if layer is None else (3, in_dim, n)
        w = quantize_weight4(torch.randn(shape, generator=g5, device="cuda"), group=group,
                             packing=packing)
        x = torch.randn((R, in_dim), generator=g5, device="cuda")
        cov[f"w4_{i}"] = ratios(x if f32 else x.to(torch.bfloat16), w, layer)
    return main, cov


def _fault_checks(src):
    """The kernel checks of one source with whatever library is bound:
    ({main shape: [err_over_tol]}, {coverage case: err_over_tol})."""
    import torch
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops.flash_attention import _offsets
    g = torch.Generator(device="cuda").manual_seed(1)
    g5 = torch.Generator(device="cuda").manual_seed(5)
    main = {}
    if src == "flash_fwd":
        for label, dt, shape, hkv, causal in (
                ("serve_flash prefill", torch.bfloat16, (1, 32, 2048, 128), 8, True),
                ("solve fa", torch.float32, (1, 32, 8192, 32), 32, False)):
            q = torch.randn(shape, generator=g, device="cuda").to(dt)
            kv = torch.randn((2, 1, hkv) + shape[2:], generator=g, device="cuda").to(dt)
            main[label] = _flash_fwd_check(q, kv[0], kv[1], _offsets(0, 0, 1, q.device),
                                           causal=causal, save_residuals=False)[2]
        ratios, _ = _coverage_float(g5)
    elif src == "flash_bwd":
        B, H, Hkv, S, D = (BWD_MAIN[x] for x in ("B", "H", "Hkv", "S", "D"))
        q = torch.randn((B, H, S, D), generator=g, device="cuda").to(torch.bfloat16)
        k, v = torch.randn((2, B, Hkv, S, D), generator=g, device="cuda").to(torch.bfloat16)
        do = torch.randn((B, H, S, D), generator=g, device="cuda").to(torch.bfloat16)
        main["train step"] = _flash_bwd_check(q, k, v, _offsets(0, 0, B, q.device), do,
                                              causal=True)[2]
        ratios = _coverage_bwd(g5)
    elif src == "w4_matmul":
        main, ratios = _w4_fault_ratios(g, g5)
    elif src == "flash_int8_fwd":
        # solve's shape (MODE_BF16_P) and the serve and serve_w4 prefills'
        # (MODE_INT8_P); then FLASH_COVERAGE.
        for name, mode, shape, hkv, dt, bkv, causal in (
                ("solve fa_int8", 1, (1, 32, 8192, 32), 32, torch.float32, 512, False),
                ("serve prefill", 0, (1, 32, 256, 128), 8, torch.bfloat16, 256, True),
                ("serve_w4 prefill", 0, (1, 32, 512, 128), 8, torch.bfloat16, 512, True)):
            q = torch.randn(shape, generator=g, device="cuda").to(dt)
            k, v = torch.randn((2, 1, hkv) + shape[2:], generator=g, device="cuda").to(dt)
            e = _flash_case(name, mode, q, k, v, bkv, causal, replaces=None, library=False,
                            timed=False)
            main[name] = [e["err_over_tol"]] + ([] if e["same_bits_twice"] else [float("inf")])
        ratios = _flash_coverage_ratios(g5)
    elif src == "paged_prefill":
        main["serve_flash chunk"] = _paged_prefill_check(*_paged_main_inputs(g))[2]
        q, cache, lengths, tables, q_starts = _int4_prefill_main_inputs(g)
        main["serve_mixed chunk"] = _int4_check(q, cache, lengths, tables, q_starts)[2]
        ratios = {**_coverage_float(g5)[0], **_coverage_int4(g5)}
    else:
        kw = dict(sm_scale=128**-0.5, window=None, softcap=None, sinks=0, save_residuals=False)
        for label, (hkv, seed, lens, slots) in DECODE_MAIN.items():
            operands = _decode_main_inputs(hkv, seed=seed, lengths=lens, max_pages=slots)
            main[label] = [_decode_check(operands, kw)[2]]
        main["serve_mixed decode"] = _int4_check(*_int4_decode_main_inputs(g))[2]
        ratios = {**_decode_coverage_ratios(g5), **_coverage_int4(g5)}
    return main, {k: max(r) for k, r in ratios.items() if k.startswith(FAULT_SOURCES[src])}


def phase_faults(st):
    """Plant each PLANTED_FAULTS line in a copy of csrc/, build every float
    kernel source that the changed file is part of (all copies in
    parallel), bind each library in turn in place of the committed one and
    rerun that kernel's main-shape and coverage checks: every fault must
    fail them."""
    import ctypes
    import shutil
    from quantizedmha_tpu_torch.ops import cuda_lib
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    out_dir = cuda_lib.BUILD_DIR / "faults"
    shutil.rmtree(out_dir, ignore_errors=True)
    builds = []
    for i, (fname, what, old, new) in enumerate(PLANTED_FAULTS):
        text = (cuda_lib.CSRC / fname).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"fault {i}: the committed line is not unique in {fname}")
        copy = out_dir / f"fault{i}"
        shutil.copytree(cuda_lib.CSRC, copy)
        (copy / fname).write_text(text.replace(old, new))
        srcs = [s for s in FAULT_SOURCES if fname == f"{s}.cu"
                or f'#include "{fname}"' in (cuda_lib.CSRC / f"{s}.cu").read_text()]
        for src in srcs:
            lib = copy / f"lib{src}.so"
            proc = subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib),
                                     str(copy / f"{src}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            builds.append((what, src, proc, lib))
    for _, _, proc, _ in builds:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for a planted fault:\n{log}")
    kernels = {"flash_fwd": (fa.FLASH_FWD_BF16, fa.FLASH_FWD_F32),
               "paged_prefill": (pp.PAGED_PREFILL, pp.PAGED_PREFILL_INT4),
               "paged_decode": (dec.PAGED_DECODE, dec.PAGED_DECODE_INT4),
               "flash_bwd": (fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ),
               "w4_matmul": (w4.W4_MATMUL,),
               "flash_int8_fwd": (fa8.FLASH_INT8_P, fa8.FLASH_BF16_P)}
    rows = []
    try:
        for what, src, _, lib in builds:
            variant = ctypes.CDLL(str(lib))
            for kern in kernels[src]:
                fn = getattr(variant, kern.symbol)
                fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
                kern._fn = fn
            main, cov = _fault_checks(src)
            worst = max([max(r) for r in main.values()] + list(cov.values()))
            rows.append({"source": src, "fault": what, "main_err_over_tol": main,
                         "coverage_failing": sorted(k for k, r in cov.items() if r > 1.0),
                         "coverage_err_over_tol": cov, "max_err_over_tol": worst,
                         "caught": worst > 1.0})
    finally:
        for kerns in kernels.values():
            for kern in kerns:
                kern._fn = None  # rebind the committed kernel at its next call
    ok = all(r["caught"] for r in rows)
    emit({"phase": "faults", "ok": ok, "faults": rows})
    if not ok:
        raise AssertionError("a planted fault passed the kernel checks")


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
    rungs = {name: _solve_rung(name, q, k, v, ref, ones, st) for name in SOLVE_RUNG_TOL}
    ok = ok and all(r["ok"] for r in rungs.values())
    st["solve_ms"] = {"fa_int8": ms, **{name: r["ms"] for name, r in rungs.items()}}
    emit({"phase": "solve", "ok": ok, "ms": ms, "launches": launches,
          "rel_rms_err_vs_reference": rel_rms, "rel_rms_tol": SOLVE_REL_RMS_TOL,
          "max_abs_err_vs_reference": max_abs, "ref_rms": (ref.norm() / N**0.5 / d_model**0.5).item(),
          "ones_max_dev": const_dev, "ones_tol": 1e-6,
          "reference_l4_ms": REFERENCE_L4_MS, "rungs": rungs})
    if not ok:
        raise AssertionError("solve failed its checks")


# The float rungs of the solve ladder: relative RMS error limit against the
# float golden, and the kernel each launches once a call. fa and unfused
# compute in f32 and differ from the golden by summation order alone
# (~1e-7); fa_bf16 rounds Q, K, V and P to bf16 (2^-9 relative each, ~0.3%
# RMS at the output on random inputs), so a fault that moves the output by
# a few per cent exceeds its 1% limit.
SOLVE_RUNG_TOL = {"fa": (1e-5, "flash_fwd[f32]"), "fa_bf16": (1e-2, "flash_fwd[bf16]"),
                  "unfused": (1e-5, None)}


def _solve_rung(kernel, q, k, v, ref, ones, st):
    """One float rung at the reference workload: launches of its kernel in
    one call (counts zeroed just before), time, error against the golden,
    the all-ones gate."""
    import torch
    from quantizedmha_tpu_torch import solve
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    N, d_model = q.shape
    h = 32
    tol, name = SOLVE_RUNG_TOL[kernel]
    counters = {"flash_fwd[f32]": fa.FLASH_FWD_F32, "flash_fwd[bf16]": fa.FLASH_FWD_BF16}
    for c in counters.values():
        c.reset()
    out = solve(q, k, v, d_model, h, kernel=kernel)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    if name is not None:
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    ms = cuda_ms(lambda: solve(q, k, v, d_model, h, kernel=kernel), iters=5)
    rel_rms = ((out - ref).norm() / ref.norm()).item()
    const_dev = (solve(ones, ones, ones, d_model, h, kernel=kernel) - 1.0).abs().max().item()
    want = {n: int(n == name) for n in counters}
    ok = (launches == want and bool(torch.isfinite(out).all().item()) and rel_rms <= tol
          and out.dtype == torch.float32 and const_dev <= 1e-6)
    return {"ok": ok, "ms": ms, "launches": launches, "rel_rms_err_vs_reference": rel_rms,
            "rel_rms_tol": tol, "ones_max_dev": const_dev, "ones_tol": 1e-6}


# The harness phase: the kernel counter each rung of the reference driver
# launches (none for unfused and reference), and the band its CLI time must
# lie in around the solve phase's time of the same rung.
HARNESS_RUNG_KERNELS = {"fa_int8": "flash_int8_fwd[bf16_p]", "fa": "flash_fwd[f32]",
                        "fa_bf16": "flash_fwd[bf16]"}
HARNESS_MS_BAND = (0.8, 1.25)
HARNESS_ARGS = dict(warmup=3, runs=16, repeats=3)


def phase_harness(st):
    """The reference driver (harness/cli.py) at solve's workload, all rungs,
    through the CLI's own entry with a temporary cache and JSON report."""
    import tempfile
    import torch
    from quantizedmha_tpu_torch.harness import cli
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.profiling.device_info import device_info
    counters = {"flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P,
                "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
                "flash_fwd[f32]": fa.FLASH_FWD_F32, "flash_fwd[bf16]": fa.FLASH_FWD_BF16}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "run.json")
        argv = ["--kernel", "all", "--n", "8192", "--d-model", "1024", "--heads", "32",
                "--cache-dir", os.path.join(tmp, "cache"), "--json", report]
        for key, val in HARNESS_ARGS.items():
            argv += [f"--{key}", str(val)]
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        rc = cli.run(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        with open(report) as f:
            payload = json.load(f)
    torch.cuda.empty_cache()
    results = payload["results"]
    # Every checked and timed rung calls solve 1 + warmup + runs * repeats times.
    calls = 1 + HARNESS_ARGS["warmup"] + HARNESS_ARGS["runs"] * HARNESS_ARGS["repeats"]
    want = {n: 0 for n in counters}
    want.update({n: calls for n in HARNESS_RUNG_KERNELS.values()})
    for n in HARNESS_RUNG_KERNELS.values():
        st["launches"][n] = st["launches"].get(n, 0) + launches[n]
    ratios = {r["kernel"]: r["ms"] / st["solve_ms"][r["kernel"]] for r in results
              if r["kernel"] in st["solve_ms"] and r["ms"]}
    lo, hi = HARNESS_MS_BAND
    ok = (rc == 0 and launches == want
          and [r["kernel"] for r in results] == ["unfused", "fa", "fa_bf16", "fa_int8",
                                                 "reference"]
          and all(r["error"] is None and r["skipped"] is None and r["check"]
                  and r["check"]["n_mismatch"] == 0 and r["check"]["n_nonfinite"] == 0
                  and r["ms"] and r["ms"] > 0
                  and 0 <= r["pct_mxu_sol"] <= 100 and 0 <= r["pct_hbm_sol"] <= 100
                  for r in results)
          and len(ratios) == 4 and all(lo <= x <= hi for x in ratios.values()))
    emit({"phase": "harness", "ok": ok, "rc": rc, "seconds": secs, "argv": argv,
          "device": payload["device"], "workload": payload["workload"],
          "results": results, "launches": launches, "launches_expected": want,
          "ms_over_solve_ms": ratios, "ms_band": HARNESS_MS_BAND,
          "device_info": device_info()})
    if not ok:
        raise AssertionError("the reference driver failed its checks")


def phase_serve(st):
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.harness import serving_bench
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
    # The serving benchmark's prefill on the same params: every layer's
    # attention through the int8-P kernel in each of its timed calls.
    torch.cuda.empty_cache()
    fa8.FLASH_INT8_P.reset()
    fa8.FLASH_BF16_P.reset()
    prefill = serving_bench.run_prefill_bench(cfg, params, prompt_len=PREFILL_BENCH_LEN)
    torch.cuda.synchronize()
    prefill_launches = {"flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P.launches,
                        "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P.launches}
    timing = serving_bench.PREFILL_TIMING
    prefill_want = {"flash_int8_fwd[int8_p]": cfg.num_layers * (
                        timing["warmup"] + timing["runs"] * timing["repeats"]),
                    "flash_int8_fwd[bf16_p]": 0}
    st["launches"]["flash_int8_fwd[int8_p]"] += prefill_launches["flash_int8_fwd[int8_p]"]
    prefill_ok = (prefill_launches == prefill_want and prefill["prefill_ms"] > 0
                  and 0 < prefill["prefill_pct_mxu_sol"] <= 100)
    ok = ok and prefill_ok
    if st.get("profile"):
        bench_toks = torch.as_tensor(
            np.random.default_rng(0).integers(1, cfg.vocab_size, (1, PREFILL_BENCH_LEN)),
            dtype=torch.int32, device="cuda")
        emit({"phase": "serve_prefill_profile", "prefill_len": PREFILL_BENCH_LEN,
              **_profile_prefill(lambda: llama_adapter.prefill_at(
                  cfg, params, bench_toks, PREFILL_BENCH_LEN - 1))})
    emit({"phase": "serve", "ok": ok, "model": "llama3_8b", "layers": cfg.num_layers,
          "weights_gb": wbytes / 1e9, "init_s": init_s,
          "requests": batch, "prompt_len": prompt_len, "max_new": max_new,
          "decode_chunk": chunk, "tokens_each": sorted({len(results.get(r, [])) for r in rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "first_step_s": first_step_s, "ttft_warm_s": ttft,
          "decode_tok_s": toks / dt, "decode_ms_per_step": dt * 1e3 / max(steps, 1),
          "measured_tokens": toks, "prefill_logits_rel_err_vs_reference": rel,
          "rel_err_tol": 0.25, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "prefill_bench": {**prefill, "ok": prefill_ok, "launches": prefill_launches,
                            "launches_expected": prefill_want}})
    if not ok:
        raise AssertionError("serve phase failed its checks")


SERVE_FLASH = dict(bucketed=(256, 700, 1500, 2000), long=(5000, 7900), shared=4096,
                   hit_suffixes=(300, 1000), max_new=32, chunk=8, page=128, num_pages=256,
                   decode_new=72)


def _first_token_at(eng, rid):
    """True once request rid has its first sampled token."""
    return rid in eng.finished or any(s.seq_id == rid for s in eng.active)


def phase_serve_flash(st):
    """Llama-3-8B as configured (attention_impl="flash", bf16 weights, all
    32 layers) through the engine with the JAX default buckets, prefix
    caching and interleaved prefill: four bucketed prompts, two long ones
    prefilled in chunks between the others' decode steps, then two prompts
    that share the longest one's first 4096 tokens (prefix hits)."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    from quantizedmha_tpu_torch.serving.kv_cache import PageAllocator

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sf = SERVE_FLASH
    cfg = llama.LlamaConfig.llama3_8b()
    L = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(num_pages=sf["num_pages"], page_size=sf["page"], max_batch=8,
                        max_pages_per_seq=64, prefill_buckets=(128, 256, 512, 1024, 2048),
                        max_new_tokens=sf["max_new"], decode_chunk=sf["chunk"],
                        prefix_cache=True, interleaved_prefill=True)
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in sf["bucketed"] + sf["long"]]
    longest = prompts[-1]
    hits = [longest[:sf["shared"]] + rng.integers(1, vocab, n).tolist()
            for n in sf["hit_suffixes"]]
    # Warm-up outside the measured run: a bucketed prompt and a two-chunk
    # one (first cuBLAS and kernel use), on tokens no later prompt shares.
    for n in (100, 2100):
        eng.add_request(rng.integers(1, vocab, n).tolist(), max_new=sf["chunk"] + 1)
    eng.run()
    eng.finished.clear()

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "paged_prefill": pp.PAGED_PREFILL, "paged_decode": dec.PAGED_DECODE,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    counters = ("decode_steps", "tokens_generated", "prefix_cache_hits",
                "prefix_tokens_reused", "prefill_chunks_interleaved", "requests_admitted")
    base = {c: eng.metrics.counter(c) for c in counters}
    for kern in kernels.values():
        kern.reset()
    t_add, ttft = {}, {}
    t_start = time.perf_counter()
    rids = []
    for p in prompts:
        rids.append(eng.add_request(p, max_new=sf["max_new"]))
        t_add[rids[-1]] = t_start
    long_rid, hit_rids = rids[-1], []
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        torch.cuda.synchronize()
        te = time.perf_counter()
        for rid in t_add:
            if rid not in ttft and _first_token_at(eng, rid):
                ttft[rid] = te - t_add[rid]
        if not hit_rids and any(s.seq_id == long_rid for s in eng.active):
            # The 7900-token prompt is prefilled and decoding: its pages are
            # registered, so these two share its first 32 pages.
            for p in hits:
                hit_rids.append(eng.add_request(p, max_new=sf["max_new"]))
                t_add[hit_rids[-1]] = time.perf_counter()
    run_s = time.perf_counter() - t_start
    # Decode at a full batch: eight fresh prompts of the largest bucketed
    # length, admitted in one step; every later step that decodes all
    # eight for a whole chunk (no admission, no sequence finished) is timed.
    batch_prompts = [rng.integers(1, vocab, sf["bucketed"][-1]).tolist() for _ in range(8)]
    batch_rids = [eng.add_request(p, max_new=sf["decode_new"]) for p in batch_prompts]
    decode_wall = []
    while eng.queue or eng.active or eng.prefilling:
        before = {c: eng.metrics.counter(c) for c in ("requests_admitted", "decode_steps",
                                                      "tokens_generated")}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        d = {c: eng.metrics.counter(c) - before[c] for c in before}
        if (d["requests_admitted"] == 0 and d["decode_steps"] == sf["chunk"]
                and d["tokens_generated"] == 8 * sf["chunk"]):
            decode_wall.append(dt)
    launches = {name: kern.launches for name, kern in kernels.items()}
    delta = {c: eng.metrics.counter(c) - base[c] for c in counters}
    results = eng.finished
    n_chunks = (sum(-(-n // 2048) for n in sf["long"])
                + sum(1 for _ in sf["hit_suffixes"]))  # each suffix fits one bucket
    n_bucketed = len(sf["bucketed"]) + len(batch_rids)
    want = {"flash_fwd[bf16]": L * n_bucketed, "flash_fwd[f32]": 0,
            "paged_prefill": L * n_chunks, "paged_decode": L * int(delta["decode_steps"]),
            "flash_int8_fwd[int8_p]": 0, "flash_int8_fwd[bf16_p]": 0}
    for name in ("flash_fwd[bf16]", "paged_prefill", "paged_decode"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    all_rids = rids + hit_rids
    lens_ok = (len(hit_rids) == 2
               and all(len(results.get(r, [])) == sf["max_new"] for r in all_rids)
               and all(len(results.get(r, [])) == sf["decode_new"] for r in batch_rids))
    in_vocab = all(0 <= t < vocab for r in all_rids + batch_rids for t in results.get(r, []))
    counts_ok = (launches == want and delta["prefix_cache_hits"] == 2
                 and delta["prefix_tokens_reused"] == 2 * sf["shared"]
                 and delta["prefill_chunks_interleaved"] > 0 and len(decode_wall) >= 4)

    # Right by the repo's own means: last-token logits against the float
    # attention golden (attention_impl="reference") on the same tokens, for
    # the 2000-token bucketed prefill and the 5000-token prompt prefilled in
    # chunks through a fresh paged cache. Each path runs twice; the second
    # run is timed (prefill tok/s).
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    checks = {}
    n_b = sf["bucketed"][-1]
    toks = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
    toks[0, :n_b] = torch.tensor(prompts[len(sf["bucketed"]) - 1], device="cuda")
    def bucketed():
        return llama_adapter.prefill_at(cfg, params, toks, n_b - 1)[0]
    for _ in range(2):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        logits = bucketed()
        torch.cuda.synchronize()
        bucket_s = time.perf_counter() - tb
    ref = llama.forward(ref_cfg, params, toks[:, :n_b])[:, -1]
    checks["bucketed_2000"] = ((logits - ref).abs().max() / ref.std()).item()
    del ref
    n_c = sf["long"][0]
    chunk = 2048
    slots = -(-n_c // chunk) * chunk // sf["page"]
    cache = llama_adapter.make_cache(cfg, slots + 1, sf["page"], device="cuda")
    alloc = PageAllocator(slots + 1, sf["page"], scrap_page=0)
    alloc.admit(0, n_c)
    table = torch.tensor(alloc.block_table_array([0], slots)[0], device="cuda")
    ctoks = torch.tensor(prompts[len(sf["bucketed"])], dtype=torch.int32, device="cuda")

    def chunked():
        for start in range(0, n_c, chunk):
            part = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
            n_part = min(chunk, n_c - start)
            part[0, :n_part] = ctoks[start:start + n_part]
            out, _ = llama_adapter.prefill_chunk(cfg, params, cache, part, start, table,
                                                 n_part - 1, page_size=sf["page"])
        return out
    for _ in range(2):
        torch.cuda.synchronize()
        tc = time.perf_counter()
        clog = chunked()
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - tc
    if st.get("profile"):
        emit({"phase": "serve_flash_profile",
              "bucketed_2000": _profile_prefill(bucketed),
              "chunked_5000": _profile_prefill(chunked)})
    del cache
    ref = llama.forward(ref_cfg, params, ctoks[None])[:, -1]
    checks["chunked_5000"] = ((clog - ref).abs().max() / ref.std()).item()
    finite = bool(torch.isfinite(logits).all().item() and torch.isfinite(clog).all().item())
    del ref
    torch.cuda.empty_cache()

    dec_s = sum(decode_wall)
    dec_steps = sf["chunk"] * len(decode_wall)
    ok = (lens_ok and in_vocab and counts_ok and not eng.failed and finite
          and max(checks.values()) <= 0.25)
    emit({"phase": "serve_flash", "ok": ok, "model": "llama3_8b", "attention_impl": "flash",
          "layers": L, "weights": "bf16", "init_s": init_s,
          "prompts": list(sf["bucketed"] + sf["long"]),
          "prefix_hits": [sf["shared"] + n for n in sf["hit_suffixes"]],
          "max_new": sf["max_new"], "decode_chunk": sf["chunk"],
          "tokens_each": sorted({len(results.get(r, [])) for r in all_rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "counters": delta, "run_s": run_s,
          "ttft_cold_long_s": [ttft.get(r) for r in rids[len(sf["bucketed"]):]],
          "ttft_bucketed_s": [ttft.get(r) for r in rids[:len(sf["bucketed"])]],
          "ttft_prefix_hit_s": [ttft.get(r) for r in hit_rids],
          "prefill_tok_s_bucketed": n_b / bucket_s, "prefill_2000_s": bucket_s,
          "prefill_tok_s_chunked": n_c / chunked_s, "prefill_chunked_5000_s": chunked_s,
          "decode_batch": 8, "decode_prompt_len": sf["bucketed"][-1],
          "decode_new": sf["decode_new"], "decode_engine_steps_timed": len(decode_wall),
          "decode_tok_s_batch8": 8 * dec_steps / dec_s if dec_s else None,
          "decode_ms_per_step_batch8": dec_s * 1e3 / dec_steps if dec_steps else None,
          "logits_rel_err_vs_reference": checks, "rel_err_tol": 0.25,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve_flash phase failed its checks")


SERVE_MIXED = dict(bucketed=(240, 1000, 2000), long=(5000, 7900), max_new=32, chunk=8,
                   page=128, decode_new=72, logit_tol=0.25,
                   mixed={"boundary_tokens": 256, "int8_pages": 32, "int4_pages": 512,
                          "subs": 4})


def _cache_page_bytes(cfg, page, subs=None):
    """Bytes of one page of a layer-stacked cache: K and V of every layer
    and kv head, payload and scales (INT8, or nibble-packed INT4 with subs
    scales)."""
    per_head = page * cfg.hd + 4 if subs is None else page * cfg.hd // 2 + 4 * subs
    return cfg.num_layers * 2 * cfg.num_kv_heads * per_head


def _kv_quantized_logits(cfg, params, toks, *, boundary, page, subs):
    """Last-token logits of the model with float attention over K/V passed
    through the mixed cache's quantization and back: each layer's K and V
    (after RoPE, in the model's dtype), page by page, INT8 with one scale a
    head below `boundary` and INT4 with one scale a head and sub-tile past
    it, dequantized to f32. The golden of the mixed cache's numerics,
    without its kernels, its paging or its chunking."""
    import functools
    import torch
    from quantizedmha_tpu_torch.models.llama import (
        embed_tokens, final_logits, layer_params, qkv_triple, rms_norm)
    from quantizedmha_tpu_torch.ops.quantize import unpack_int4_halves
    from quantizedmha_tpu_torch.quant.weights import qdense
    from quantizedmha_tpu_torch.reference.mha import apply_rope, mha_masked_reference
    from quantizedmha_tpu_torch.serving.kv_cache import quantize_page
    from quantizedmha_tpu_torch.serving.llama_adapter import _attn_residual, _mlp_residual
    from quantizedmha_tpu_torch.serving.mixed_kv import quantize_page_int4
    b, n = toks.shape
    n_pad = -(-n // page) * page
    nb = boundary // page

    def through_cache(x):  # [Hkv, n, D] -> the dequantized cache contents, f32
        h, _, d = x.shape
        xp = torch.zeros((h, n_pad, d), dtype=torch.float32, device=x.device)
        xp[:, :n] = x.float()
        pages = xp.reshape(h, n_pad // page, page, d).transpose(0, 1)  # [pages, Hkv, P, D]
        q8, s8 = quantize_page(pages[:nb])
        q4, s4 = quantize_page_int4(pages[nb:], subs)
        d4 = torch.cat(unpack_int4_halves(q4), dim=-1).float()
        d4 = d4 * s4.repeat_interleave(page // subs, dim=-1)[..., None]
        out = torch.cat([q8.float() * s8[..., None, None], d4])
        return out.transpose(0, 1).reshape(h, n_pad, d)[:, :n]
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    x = embed_tokens(cfg, params, toks)
    hd = cfg.hd
    for i in range(cfg.num_layers):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = apply_rope(q.reshape(b, n, cfg.num_heads, hd).transpose(1, 2), cfg.rope_theta)
        k = apply_rope(k.reshape(b, n, cfg.num_kv_heads, hd).transpose(1, 2), cfg.rope_theta)
        v = v.reshape(b, n, cfg.num_kv_heads, hd).transpose(1, 2)
        o = mha_masked_reference(q, through_cache(k[0])[None], through_cache(v[0])[None],
                                 sm_scale=cfg.sm_scale, causal=True,
                                 softcap=cfg.logit_softcap)
        x = _attn_residual(cfg, dense, p, x, o.transpose(1, 2).reshape(b, n, -1))
        x = _mlp_residual(cfg, dense, p, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x[:, -1], params["lm_head"])


def phase_serve_mixed(st):
    """Llama-3-8B as configured (flash attention, random bf16 weights, 32
    layers) served from the mixed INT8-sink / INT4-bulk paged cache:
    bucketed prompts written split across the two pools, chunked and
    interleaved prompts through rows 10 + 11, fused decode through rows 3 +
    12 and the lse merge; then eight 2000-token prompts time decode at
    batch 8."""
    import numpy as np
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import decode as dec
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    from quantizedmha_tpu_torch.serving import llama_adapter
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    from quantizedmha_tpu_torch.serving.kv_cache import MixedPageAllocator, PageAllocator

    # An earlier phase's engine sits in reference cycles with its model:
    # collect it, so that the peak below is this phase's.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sm_ = SERVE_MIXED
    mk = sm_["mixed"]
    cfg = llama.LlamaConfig.llama3_8b()
    L, page, bnd = cfg.num_layers, sm_["page"], mk["boundary_tokens"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(page_size=page, prefill_buckets=(128, 256, 512, 1024, 2048), max_batch=8,
                        max_pages_per_seq=64, max_new_tokens=sm_["max_new"],
                        decode_chunk=sm_["chunk"], interleaved_prefill=True, mixed_kv=dict(mk))
    eng = Engine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in sm_["bucketed"] + sm_["long"]]
    # Warm-up outside the measured run: a bucketed prompt and a two-chunk one.
    for n in (100, 2100):
        eng.add_request(rng.integers(1, vocab, n).tolist(), max_new=sm_["chunk"] + 1)
    eng.run()
    eng.finished.clear()

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "paged_prefill": pp.PAGED_PREFILL, "paged_prefill_int4": pp.PAGED_PREFILL_INT4,
               "paged_decode": dec.PAGED_DECODE, "paged_decode_int4": dec.PAGED_DECODE_INT4,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    counters = ("decode_steps", "tokens_generated", "prefill_chunks_interleaved",
                "requests_admitted", "prefill_tokens")
    base = {c: eng.metrics.counter(c) for c in counters}
    for kern in kernels.values():
        kern.reset()
    t_start = time.perf_counter()
    rids = [eng.add_request(p, max_new=sm_["max_new"]) for p in prompts]
    long_rid = rids[-1]
    # The 7900-token sequence's pages at its release: its final length.
    long_pages, release = [], eng.alloc.release

    def release_counting(seq_id):
        if seq_id == long_rid:
            long_pages.extend((len(eng.alloc.a8.tables[seq_id]),
                               len(eng.alloc.a4.tables[seq_id]), eng.alloc.lengths[seq_id]))
        release(seq_id)
    eng.alloc.release = release_counting
    ttft = {}
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        torch.cuda.synchronize()
        te = time.perf_counter()
        for rid in rids:
            if rid not in ttft and _first_token_at(eng, rid):
                ttft[rid] = te - t_start
    run_s = time.perf_counter() - t_start
    batch_prompts = [rng.integers(1, vocab, sm_["bucketed"][-1]).tolist() for _ in range(8)]
    batch_rids = [eng.add_request(p, max_new=sm_["decode_new"]) for p in batch_prompts]
    decode_wall = []
    while eng.queue or eng.active or eng.prefilling:
        before = {c: eng.metrics.counter(c) for c in ("requests_admitted", "decode_steps",
                                                      "tokens_generated")}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        d = {c: eng.metrics.counter(c) - before[c] for c in before}
        if (d["requests_admitted"] == 0 and d["decode_steps"] == sm_["chunk"]
                and d["tokens_generated"] == 8 * sm_["chunk"]):
            decode_wall.append(dt)
    launches = {name: kern.launches for name, kern in kernels.items()}
    delta = {c: eng.metrics.counter(c) - base[c] for c in counters}
    results = eng.finished
    n_chunks = sum(-(-n // 2048) for n in sm_["long"])
    n_bucketed = len(sm_["bucketed"]) + len(batch_rids)
    steps = int(delta["decode_steps"])
    want = {"flash_fwd[bf16]": L * n_bucketed, "flash_fwd[f32]": 0,
            "paged_prefill": L * n_chunks, "paged_prefill_int4": L * n_chunks,
            "paged_decode": L * steps, "paged_decode_int4": L * steps,
            "flash_int8_fwd[int8_p]": 0, "flash_int8_fwd[bf16_p]": 0}
    for name in ("flash_fwd[bf16]", "paged_prefill", "paged_prefill_int4", "paged_decode",
                 "paged_decode_int4"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]
    lens_ok = (all(len(results.get(r, [])) == sm_["max_new"] for r in rids)
               and all(len(results.get(r, [])) == sm_["decode_new"] for r in batch_rids))
    in_vocab = all(0 <= t < vocab for r in rids + batch_rids for t in results.get(r, []))
    drained = (eng.alloc.a8.free_pages == mk["int8_pages"] - 1
               and eng.alloc.a4.free_pages == mk["int4_pages"] - 1)
    counts_ok = (launches == want and delta["prefill_chunks_interleaved"] == n_chunks
                 and len(decode_wall) >= 4)
    if st["profile"]:
        # After the launch counts are read: the traced chunks launch too.
        profile_prompts = [rng.integers(1, vocab, sm_["bucketed"][-1]).tolist()
                           for _ in range(8)]
        emit({"phase": "serve_mixed_profile",
              **_profile_decode_chunk(eng, profile_prompts, 4 * sm_["chunk"])})

    # The 5000-token prompt's last logits, chunk-prefilled through a fresh
    # mixed cache (and, beside it, a plain INT8 cache), against the float
    # attention golden on the same tokens, and, gated, against the golden
    # whose attention reads K/V through the mixed cache's quantization (the
    # INT4 step itself moves the logits ~1 std of the float golden on these
    # random weights); the 2000-token bucketed prefill timed. Each path
    # runs twice; the second run is timed.
    ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
    n_b, n_c, chunk = sm_["bucketed"][-1], sm_["long"][0], 2048
    toks = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
    toks[0, :n_b] = torch.tensor(prompts[len(sm_["bucketed"]) - 1], device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        llama_adapter.prefill_at(cfg, params, toks, n_b - 1)
        torch.cuda.synchronize()
        bucket_s = time.perf_counter() - tb
    slots = -(-n_c // chunk) * chunk // page
    ctoks = torch.tensor(prompts[len(sm_["bucketed"])], dtype=torch.int32, device="cuda")

    def chunked(cache, table):
        for start in range(0, n_c, chunk):
            part = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
            n_part = min(chunk, n_c - start)
            part[0, :n_part] = ctoks[start:start + n_part]
            out, _ = llama_adapter.prefill_chunk(cfg, params, cache, part, start, table,
                                                 n_part - 1, page_size=page,
                                                 boundary_tokens=bnd)
        return out
    bp = bnd // page
    a = MixedPageAllocator(bp + 1, slots - bp + 1, page, bnd)
    a.admit(0, n_c)
    table = tuple(torch.tensor(t[0], device="cuda") for t in a.block_tables([0], slots - bp))
    cache = llama_adapter.make_cache_mixed(cfg, bp + 1, slots - bp + 1, page, mk["subs"],
                                           device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        tc = time.perf_counter()
        mixed_logits = chunked(cache, table)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - tc
    del cache
    plain = PageAllocator(slots + 1, page, scrap_page=0)
    plain.admit(0, n_c)
    cache = llama_adapter.make_cache(cfg, slots + 1, page, device="cuda")
    int8_logits = chunked(cache, torch.tensor(plain.block_table_array([0], slots)[0],
                                              device="cuda"))
    del cache
    ref = llama.forward(ref_cfg, params, ctoks[None])[:, -1]
    checks = {"mixed_chunked_5000": ((mixed_logits - ref).abs().max() / ref.std()).item(),
              "int8_chunked_5000": ((int8_logits - ref).abs().max() / ref.std()).item()}
    del ref
    ref = _kv_quantized_logits(cfg, params, ctoks[None], boundary=bnd, page=page,
                               subs=mk["subs"])
    gated = ((mixed_logits - ref).abs().max() / ref.std()).item()
    finite = bool(torch.isfinite(mixed_logits).all().item())
    del ref
    torch.cuda.empty_cache()

    n8, n4, n_long = long_pages or (0, 0, 0)
    kv_mixed = n8 * _cache_page_bytes(cfg, page) + n4 * _cache_page_bytes(cfg, page, mk["subs"])
    kv_int8 = -(-n_long // page) * _cache_page_bytes(cfg, page)
    dec_s = sum(decode_wall)
    dec_steps = sm_["chunk"] * len(decode_wall)
    ok = (lens_ok and in_vocab and counts_ok and drained and not eng.failed and finite
          and gated <= sm_["logit_tol"])
    emit({"phase": "serve_mixed", "ok": ok, "model": "llama3_8b", "attention_impl": "flash",
          "layers": L, "weights": "bf16", "init_s": init_s, "mixed_kv": mk,
          "prompts": list(sm_["bucketed"] + sm_["long"]), "max_new": sm_["max_new"],
          "decode_chunk": sm_["chunk"],
          "tokens_each": sorted({len(results.get(r, [])) for r in rids}),
          "failed": eng.failed, "launches": launches, "launches_expected": want,
          "counters": delta, "pools_drained": drained,
          "free_pages": [eng.alloc.a8.free_pages, eng.alloc.a4.free_pages], "run_s": run_s,
          "ttft_s": {n: ttft.get(r) for n, r in zip(sm_["bucketed"] + sm_["long"], rids)},
          "prefill_tok_s_bucketed": n_b / bucket_s, "prefill_2000_s": bucket_s,
          "prefill_tok_s_chunked": n_c / chunked_s, "prefill_chunked_5000_s": chunked_s,
          "decode_batch": 8, "decode_prompt_len": sm_["bucketed"][-1],
          "decode_new": sm_["decode_new"], "decode_engine_steps_timed": len(decode_wall),
          "decode_tok_s_batch8": 8 * dec_steps / dec_s if dec_s else None,
          "decode_ms_per_step_batch8": dec_s * 1e3 / dec_steps if dec_steps else None,
          "kv_bytes_long": {"tokens": n_long, "int8_pages": n8, "int4_pages": n4,
                            "mixed": kv_mixed, "plain_int8": kv_int8,
                            "ratio": kv_mixed / kv_int8 if kv_int8 else None},
          "logits_rel_err_vs_reference": checks,
          "logits_rel_err_vs_kv_quantized_golden": {"mixed_chunked_5000": gated},
          "rel_err_tol": sm_["logit_tol"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not ok:
        raise AssertionError("serve_mixed phase failed its checks")


# Llama-3-8B as configured, trained by SGD on one batch of random tokens.
# lr: a bf16 weight of the 8B init (|w| ~ 0.016, an ulp ~ 1e-4) moves only
# where lr·|g| passes half an ulp; the lm_head's target columns see
# gradients ~ |x| / tokens ~ 5e-4, so lr 0.5 moves them while a step stays
# small against the weights.
TRAIN = dict(tokens=2048, steps=4, lr=0.5, check_layers=2, grad_rel_tol=2.0**-4)


def _leaf_grads(cfg, params, tokens):
    """Every float leaf's gradient of loss_fn through sgd_train_step's
    leaves (one a layer): {name: tensor}, layers stacked."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    leaves = llama.float_leaves(params)
    llama.loss_fn(cfg, leaves, tokens).backward()
    grads = {k: v.grad for k, v in leaves.items() if k != "layers"}
    grads.update({f"layers.{k}": torch.stack([r.grad for r in rows])
                  for k, rows in leaves["layers"].items()})
    return grads


def phase_train(st):
    """sgd_train_step of LlamaConfig.llama3_8b() as configured (bf16,
    attention_impl="flash", 32 layers, random weights from seed 0) on one
    batch of 2048 random tokens, TRAIN["steps"] steps (the first pays the
    one-time costs: tokens/s is over the others): every forward through
    row 5, every backward through rows 6 and 7. Then the same width cut to
    2 layers: one step's gradients through the kernels against autograd
    through the float golden (attention_impl="reference")."""
    import torch
    from quantizedmha_tpu_torch.models import llama
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = TRAIN
    cfg = llama.LlamaConfig.llama3_8b()
    L, steps = cfg.num_layers, tr["steps"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, tr["tokens"]), generator=g, device="cuda",
                           dtype=torch.int32)
    with torch.no_grad():
        loss_direct = float(llama.loss_fn(cfg, params, tokens))

    kernels = {"flash_fwd[bf16]": fa.FLASH_FWD_BF16, "flash_fwd[f32]": fa.FLASH_FWD_F32,
               "flash_bwd_dkv": fa.FLASH_BWD_DKV, "flash_bwd_dq": fa.FLASH_BWD_DQ,
               "flash_int8_fwd[int8_p]": fa8.FLASH_INT8_P,
               "flash_int8_fwd[bf16_p]": fa8.FLASH_BF16_P}
    for kern in kernels.values():
        kern.reset()
    losses, step_ms = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        params, loss = llama.sgd_train_step(cfg, params, tokens, lr=tr["lr"])
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_fwd[bf16]": L * steps, "flash_fwd[f32]": 0, "flash_bwd_dkv": L * steps,
            "flash_bwd_dq": L * steps, "flash_int8_fwd[int8_p]": 0, "flash_int8_fwd[bf16_p]": 0}
    for name in ("flash_fwd[bf16]", "flash_bwd_dkv", "flash_bwd_dq"):
        st["launches"][name] = st["launches"].get(name, 0) + launches[name]

    # Finite weights after the steps (a NaN or inf gradient would reach
    # them) and the share of weights the steps changed, against a fresh
    # draw of the same init.
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [params[k] for k in params if k != "layers"] + list(params["layers"].values()))
    init = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    changed = n_all = 0
    for a, b in zip([params[k] for k in params if k != "layers"] + list(params["layers"].values()),
                    [init[k] for k in init if k != "layers"] + list(init["layers"].values())):
        changed += int((a != b).sum())
        n_all += a.numel()
    del init
    if st.get("profile"):
        emit({"phase": "train_profile", "step": _profile_prefill(
            lambda: llama.sgd_train_step(cfg, params, tokens, lr=tr["lr"]))})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # The wiring of the autograd Function on the card: at the same width cut
    # to 2 layers, one step's gradient of every leaf through the kernels
    # against autograd through mha_masked_reference (its S x S tensors do
    # not fit at 32 layers). Both compute attention in f32 from bf16 inputs
    # but round its bf16 output at other places (the kernel's P in bf16 for
    # P·V), which moves a bf16 gradient by a few per cent of its leaf's
    # largest entry; a lost GQA head or a swapped dK/dV moves it by 25-100%.
    cut = dataclasses.replace(cfg, num_layers=tr["check_layers"])
    grads = {}
    for impl in ("flash", "reference"):
        p2 = llama.init_params(cut, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        grads[impl] = _leaf_grads(dataclasses.replace(cut, attention_impl=impl), p2, tokens)
        del p2
    grad_rel = {k: ((grads["flash"][k].float() - grads["reference"][k].float()).abs().max()
                    / grads["reference"][k].float().abs().max()).item() for k in grads["flash"]}
    grads_finite = all(bool(torch.isfinite(x).all()) for x in grads["flash"].values())
    del grads
    torch.cuda.empty_cache()

    ok = (launches == want and finite and grads_finite
          and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - loss_direct) <= 1e-5 * abs(loss_direct)
          and all(b < a for a, b in zip(losses, losses[1:]))
          and max(grad_rel.values()) <= tr["grad_rel_tol"])
    step_s = sum(step_ms[1:]) / len(step_ms[1:]) / 1e3
    emit({"phase": "train", "ok": ok, "model": "llama3_8b", "attention_impl": "flash",
          "layers": L, "weights": "bf16", "init_s": init_s, "batch": 1, "tokens": tr["tokens"],
          "lr": tr["lr"], "steps": steps, "losses": losses, "loss_no_grad": loss_direct,
          "step_ms": step_ms, "tokens_per_s_after_first": tr["tokens"] / step_s,
          "share_of_weights_changed": changed / n_all, "weights_finite": finite,
          "launches": launches, "launches_expected": want, "peak_mem_gb": peak_gb,
          "grad_check_layers": tr["check_layers"], "grad_rel_err_vs_reference": grad_rel,
          "grad_rel_tol": tr["grad_rel_tol"], "gpu": st["gpu"]})
    if not ok:
        raise AssertionError("train phase failed its checks")


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
        for batch in (8, 32):
            emit({"phase": "serve_w4_profile", "batch": batch,
                  **_profile_w4(cfg, params, batch)})
    emit({"phase": "serve_w4", "ok": ok, "model": "llama3-8b-shape-int4-lmh8",
          "layers": L, "weights_gb": wbytes / 1e9, "init_s": init_s,
          "prefill64_w4_launches": prefill_launches,
          "prefill64_logits_rel_err_vs_bf16_dequant": rel, "rel_err_tol": 0.25,
          "peak_headroom_gb": W4_PEAK_HEADROOM_GB, "sweep": rows})
    if not ok:
        raise AssertionError("serve_w4 phase failed its checks")


def _profile_w4(cfg, params, batch):
    """Profiled full-batch decode chunks of the w4 model at `batch`."""
    import numpy as np
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
    page, new = 128, 4 * W4_SERVE["chunk"]
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


def _kernel_groups(prof):
    """Device kernels of a torch.profiler window: ({name: (us, launches)},
    {KERNEL_GROUPS group or "other": (us, launches)}, busy seconds), by
    profiling/trace_summary.py's grouping."""
    from torch.autograd import DeviceType
    from quantizedmha_tpu_torch.profiling.trace_summary import group_kernels
    return group_kernels((e.name, e.time_range.elapsed_us()) for e in prof.events()
                         if e.device_type == DeviceType.CUDA)


def _profile_prefill(fn):
    """Where one prefill's device time goes: fn() under torch.profiler
    between two synchronizes; kernels grouped by KERNEL_GROUPS, the eight
    longest by name, wall and busy ms, and the idle share 1 - busy / wall
    (tracing slows the host, so an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, by_group, busy_s = _kernel_groups(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"traced_wall_ms": wall * 1e3, "device_busy_ms": busy_s * 1e3,
            "device_idle_share_traced": 1.0 - busy_s / wall,
            "groups": {g: {"ms": t / 1e3, "launches": n}
                       for g, (t, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0])},
            "top_kernels": [{"kernel": k[:80], "ms": t / 1e3, "launches": n}
                            for k, (t, n) in top]}


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
    by_name, by_group, busy_s = _kernel_groups(prof)
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
                    help="also trace one full-batch decode chunk of the serve, "
                         "serve_w4 and serve_mixed phases, serve's 2048-token prefill "
                         "bench, serve_flash's bucketed and chunked prefills and one "
                         "train step, with torch.profiler")
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
    if "harness" in phases and "solve" not in phases:
        phases.append("solve")  # the harness phase holds its times to solve's
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
            e.update({k: c[k] for k in ("also_replaces", "mqa", "serve_flash", "library_note",
                                        "library_backend", "library_f32", "solve", "serve_w4",
                                        "prefill_bench") if k in c})
            if "shapes" in c:
                e["shapes"] = [{k: s[k] for k in ("matmul", "rows", "ms", "wrapper_ms", "plain_ms",
                                                  "bound_ms", "library_ms")} for s in c["shapes"]]
            e["launches"] = st["launches"].get(name, 0)
            entries.append(e)
        emit({"kernels": entries})
        idle = [e["name"] for e in entries if e["launches"] == 0]
        if ({"solve", "serve", "serve_w4", "serve_flash", "serve_mixed", "train"} <= set(phases)
                and idle):
            print(f"chip_smoke: kernels never launched on a main path: {idle}",
                  file=sys.stderr)
            return 1
    print(st["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
