"""A/B of a kernel source on one card: another tree's source, such as a
parent commit unpacked beside this one (`git archive <commit> | tar -x -C
build/parent`), against this tree's, in one process.

    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --parent build/parent \\
        [--source paged_prefill|paged_decode|flash_fwd|w4_matmul|flash_int8_fwd] [--out ab.json]
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source paged_decode \\
        --variants quantizedmha_tpu_torch/harness/decode_ablations.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source flash_fwd \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/flash_fwd_variants.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source w4_matmul \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/w4_matmul_variants.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source flash_int8_fwd \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/flash_int8_fwd_variants.json \\
        [--only int8p_one_consumer int8p_knockout_no_exp ...]

Each library is launched through its own tree's wrapper (`ops/<op>.py`'s
`_*_launch`, loaded from that tree), so a change of the C signature is
A/B'd as well; both are built with this tree's cuda_lib.NVCC_FLAGS. With
--variants (a JSON object {name: [[line as committed, line planted],
...]}), each named variant of this tree's source, its lines replaced, is
timed in turns against this tree's, beside the parent when one is given
(a variant that knocks a phase out fails its check by design: its
err_over_tol is reported, not gated); --only keeps the named variants of
the file.

--source paged_prefill (csrc/paged_prefill.cu):
- Rows 10 (`paged_prefill`) and 11 (`paged_prefill_int4`) at chip_smoke.py's
  main shapes, bf16 q: each library's ms in turns (parent, this, this,
  parent; CUDA events over 20 launches) and its err_over_tol against the
  plain version under chip_smoke.py's tolerance.
- The f32-q route at each main shape and at every paged prefill coverage
  case of chip_smoke.py (INT8 and INT4), q taken in f32: whether the two
  libraries give the same bits (output and lse).

--source paged_decode (csrc/paged_decode.cu):
- Rows 3 (serve's shape and serve_flash's deep decode), 4 (MQA) and 12
  (`paged_decode_int4`, serve_mixed's shape) at chip_smoke.py's main
  shapes: ms in turns as above (50 launches), err_over_tol against this
  tree's plain version, whether this tree's library gives the same bits
  twice, each C entry's host time a call (its launches enqueued, before
  the sync), and SDPA's ms on the same K/V dequantized beforehand.

--source flash_fwd (csrc/flash_fwd.cu, row 5):
- The bf16 route at chip_smoke.py's main shapes: serve_flash's bucketed
  prefill (1 x 32 x 2048 x 128, 8 kv heads, causal), the train step's
  forward (the same shape with lse) and solve's fa_bf16 rung (1 x 32 x
  8192 x 32, not causal): ms in turns (20 launches), err_over_tol against
  this tree's plain version, whether each library gives the same bits
  twice, SDPA's ms (bf16, the first backend that takes the inputs) and
  the bound.
- The f32 route at solve's fa shape and at every FLASH_FWD_COVERAGE case
  of chip_smoke.py, q, k, v in f32: whether the libraries give the same
  bits (output and lse).
- ptxas registers and spill bytes of each library's kernels.

--source w4_matmul (csrc/w4_matmul.cu, rows 8-9):
- bf16 x at the four fused matmuls of a Llama-3-8B layer (chip_smoke.py's
  W4_MAIN: group 128, halves) at R = 1, 8, 32 and 64: ms in turns (50
  launches, the weight read from L2 where it fits, as chip_smoke.py times
  it; graph_ms: 20 launches captured in a CUDA graph and replayed, the
  card's time without the host's), err_over_tol against this tree's plain version under chip_smoke.py's
  w4_tolerance, whether each library gives the same bits twice,
  `torch._weight_int4pack_mm`'s ms on the same weights and the bound; each
  R's sum over the four ("layer").
- bf16 x at every bf16 W4_COVERAGE case: err_over_tol and the same bits
  twice, for this tree's library.
- f32 x at the four matmuls (R = 8) and at every W4_COVERAGE case, x taken
  in f32: whether the libraries give the same bits.
- ptxas registers and spill bytes of each library's kernels.

--source flash_int8_fwd (csrc/flash_int8_fwd.cu, rows 1-2):
- MODE_BF16_P (row 2) at solve's fa_int8 shape (1 x 32 x 8192 x 32, f32 q,
  block_kv 512, not causal): ms in turns (20 launches; graph_ms: 20
  launches in one CUDA graph, replayed), err_over_tol against this tree's
  plain version under chip_smoke.py's flash_tolerances, whether each
  library gives the same bits twice, SDPA's ms (bf16, the first backend
  that takes the inputs) and the bound; whether the parent's library gives
  this one's bits.
- MODE_INT8_P (row 1) at the serve prefill's shape (1 x 32 x 256 x 128,
  8 kv heads, bf16 q, block_kv 256, causal) and serve_w4's (the same at
  512 tokens, block_kv 512), timed the same way.
- Every MODE_INT8_P case of chip_smoke.py's FLASH_COVERAGE: each
  library's err_over_tol (output, lse) and whether it gives the same bits
  twice; every MODE_BF16_P case: whether the parent's library gives this
  one's bits (output and lse).
- ptxas registers and spill bytes of each library's kernels.

Prints one JSON object (and writes it to --out); exits 1 when a library
fails its check, or the f32 route's bits differ.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
OPS = {"paged_prefill": "paged_prefill", "paged_decode": "decode",
       "flash_fwd": "flash_attention", "w4_matmul": "w4_matmul",
       "flash_int8_fwd": "flash_attention_int8"}
# The wrapper's launch function, where it is not _<source>_launch.
LAUNCH = {"flash_int8_fwd": "_flash_int8_launch"}


def _ops_module(tree: Path, source: str, name: str):
    """ops/<op>.py of a tree, loaded under its own module name (its imports
    of the rest of the package resolve to this tree's)."""
    path = tree / "quantizedmha_tpu_torch" / "ops" / f"{OPS[source]}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bind(lib_path, kernels):
    """{symbol: ctypes function} of a library, typed as its tree's wrapper
    declares."""
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for kern in kernels:
        fn = getattr(lib, kern.symbol)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        fns[kern.symbol] = fn
    return fns


def _nvcc_build(src: Path, out: Path):
    """Start nvcc on one source with this tree's flags: (process, library);
    `_built` waits for it and keeps its ptxas report beside the library."""
    from quantizedmha_tpu_torch.ops import cuda_lib
    proc = subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def _built(build) -> Path:
    proc, out = build
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {out}:\n{log}")
    out.with_suffix(".log").write_text(log)
    return out


def _build_parent(parent: Path, source: str):
    out = parent / "_ab" / f"lib{source}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    return _nvcc_build(parent / "quantizedmha_tpu_torch" / "csrc" / f"{source}.cu", out)


def _build_variant(name: str, edits, source: str):
    """This tree's csrc/ copied with one source's lines replaced; its build
    started."""
    import shutil
    from quantizedmha_tpu_torch.ops import cuda_lib
    out = cuda_lib.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, out)
    text = (out / f"{source}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not one line of {source}.cu")
        text = text.replace(old, new)
    (out / f"{source}.cu").write_text(text)
    return _nvcc_build(out / f"{source}.cu", out / f"lib{source}.so")


def _trees(source: str, parent=None, variants=None):
    """{"parent" | variant name | "this": (ops module, bound functions,
    library)}; every library built at once."""
    from quantizedmha_tpu_torch.ops import cuda_lib
    from quantizedmha_tpu_torch.ops import (decode, flash_attention, flash_attention_int8,
                                            paged_prefill, w4_matmul)
    this = {"paged_prefill": paged_prefill, "paged_decode": decode,
            "flash_fwd": flash_attention, "w4_matmul": w4_matmul,
            "flash_int8_fwd": flash_attention_int8}[source]
    libs = []
    if parent is not None:
        libs.append(("parent", _ops_module(parent, source, f"_ab_parent_{source}"),
                     _build_parent(parent, source)))
    for name, edits in (variants or {}).items():
        libs.append((name, this, _build_variant(name, edits, source)))
    cuda_lib.build_all([source])
    libs = [(which, module, _built(build)) for which, module, build in libs]
    libs.append(("this", this, cuda_lib.library_path(source)))
    out = {}
    for which, module, lib in libs:
        kernels = [k for k in vars(module).values()
                   if isinstance(k, cuda_lib.CudaKernel) and k.library == source]
        out[which] = (module, _bind(lib, kernels), lib)
    return out


def _launcher(module, fns, source):
    """launch(operands, **kw) -> (outputs, (function, ctypes args), kept
    operands) through a tree's wrapper and library."""
    make = getattr(module, LAUNCH.get(source, f"_{source}_launch"))

    def launch(operands, **kw):
        kernel, args, outs, keep = make(*operands, **kw)
        fn = fns[kernel.symbol]
        err = fn(*args)
        if err:
            raise RuntimeError(f"{kernel.symbol}: CUDA error {err}")
        torch.cuda.synchronize()
        return outs, (fn, args), keep
    return launch


def _timed_turns(calls, row, iters):
    """ms of each library's call in turns: the others, this, this, the
    others in reverse (parent, this, this, parent)."""
    import chip_smoke as cs
    others = [w for w in calls if w != "this"]
    for which in others + ["this", "this"] + others[::-1]:
        fn, fargs = calls[which][0]
        row[which].setdefault("ms", []).append(cs.cuda_ms(lambda: fn(*fargs), iters=iters))
    if "parent" in calls:
        row["speedup"] = min(row["parent"]["ms"]) / max(row["this"]["ms"])


def _prefill_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    launchers = {w: _launcher(m, f, "paged_prefill") for w, (m, f, _) in trees.items()}
    q8, cache8, len8, st8, tab8 = cs._paged_main_inputs(g)
    q4, cache4, len4, tab4, st4 = cs._int4_prefill_main_inputs(g)
    mains = {"paged_prefill": ((q8, cache8, len8, st8, tab8), False),
             "paged_prefill_int4": ((q4, cache4, len4, st4, tab4), True)}
    nomask = dict(window=None, sinks=0, softcap=None)
    result["f32_same_bits"] = {}
    ok = True
    for name, (inputs, int4) in mains.items():
        q, cache, lengths, q_starts, tables = inputs
        operands = (q, *cache, lengths, q_starts, tables)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **nomask)
        plain_fn = pp._paged_prefill_int4_plain if int4 else pp._paged_prefill_plain
        plain = plain_fn(*operands, **kw)
        w_abs = cs.prefill_w_abs(q, cache, lengths, q_starts, tables, int4=int4, **kw)
        tols = (cs.int4_tolerances if int4 else cs.paged_prefill_tolerances)(
            q, *cache, *plain, sm_scale=kw["sm_scale"], softcap=None, w_abs=w_abs)
        row, calls = {}, {}
        for which, launch in launchers.items():
            # calls holds each launch's outputs and operands while it is timed.
            (o, lse), call, keep = launch(operands, int4=int4, **kw)
            calls[which] = (call, (o, lse, keep))
            row[which] = {"err_over_tol": [cs.err_over_tol(o, plain[0], tols[0]),
                                           cs.err_over_tol(lse, plain[1], tols[1])]}
            ok &= max(row[which]["err_over_tol"]) <= 1.0
        _timed_turns(calls, row, iters=20)
        result["main"][name] = row
        # The f32 route at the main shape.
        f32 = (q.float(), *operands[1:])
        outs = [launch(f32, int4=int4, **kw)[0] for launch in launchers.values()]
        result["f32_same_bits"][name] = all(torch.equal(a, b) for a, b in zip(*outs))
    cases = ([(f"paged_prefill{i}", c, False) for i, c in enumerate(cs.PAGED_PREFILL_COVERAGE)]
             + [(f"paged_prefill_int4_{i}", c, True)
                for i, c in enumerate(cs.PREFILL_INT4_COVERAGE)])
    for name, case, int4 in cases:
        q, cache, lengths, q_starts, tables, masks = cs.paged_prefill_coverage_inputs(
            g, case, int4=int4, q_dtype=torch.float32)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **masks)
        outs = [launch((q, *cache, lengths, q_starts, tables), int4=int4, **kw)[0]
                for launch in launchers.values()]
        result["f32_same_bits"][name] = all(torch.equal(a, b) for a, b in zip(*outs))
    return ok and all(result["f32_same_bits"].values())


def _decode_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import decode as dec
    launchers = {w: _launcher(m, f, "paged_decode") for w, (m, f, _) in trees.items()}
    mains = {}
    for label, (hkv, seed, lens, slots) in cs.DECODE_MAIN.items():
        mains[label] = (cs._decode_main_inputs(hkv, seed=seed, lengths=lens, max_pages=slots),
                        False)
    q, cache, lengths, tables = cs._int4_decode_main_inputs(g)
    mains["serve_mixed decode (int4)"] = ((q, *cache, lengths, tables), True)
    ok = True
    for name, (operands, int4) in mains.items():
        q, k_pages, v_pages, k_scales, v_scales, lengths, tables = operands
        B, Hq, D = q.shape
        kw = dict(sm_scale=D**-0.5, window=None, softcap=None, sinks=0, save_residuals=int4)
        if int4:
            p_out, p_lse = dec._paged_decode_int4_plain(*operands, **kw)
            tol, lse_tol = cs.int4_tolerances(q, k_pages, v_pages, k_scales, v_scales, p_out,
                                              p_lse, sm_scale=kw["sm_scale"], softcap=None)
        else:
            p_out = dec._paged_decode_plain(*operands, **kw)
            tol = cs.decode_tolerance(p_out, v_pages, v_scales)
        row = {"splits": list(dec.decode_splits(B, k_pages.shape[0], tables.shape[1],
                                                k_pages.shape[2])),
               "lengths": lengths.tolist()}
        calls = {}
        for which, launch in launchers.items():
            (o, lse), call, keep = launch(operands, int4=int4, **kw)
            calls[which] = (call, (o, lse, keep))
            ratios = [cs.err_over_tol(o, p_out, tol)]
            if int4:
                ratios.append(cs.err_over_tol(lse, p_lse, lse_tol))
            row[which] = {"err_over_tol": ratios}
            if which in ("this", "parent"):
                ok &= max(ratios) <= 1.0
        outs = [x for x in calls["this"][1][:2] if x is not None]
        row["this"]["same_bits_twice"] = cs._same_bits_again(
            lambda: calls["this"][0][0](*calls["this"][0][1]), outs)
        ok &= row["this"]["same_bits_twice"]
        _timed_turns(calls, row, iters=50)
        for which, ((fn, fargs), _) in calls.items():
            # The C entry's host cost (its launches): 100 calls enqueued
            # on an idle card, timed before the sync that waits for them.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn(*fargs)
            row[which]["host_us_per_call"] = (time.perf_counter() - t0) * 1e6 / 100
            torch.cuda.synchronize()
        row["sdpa_ms"], row["sdpa_backend"] = cs._sdpa_decode(q, k_pages, v_pages, k_scales,
                                                              v_scales, lengths, tables)
        result["main"][name] = row
    return ok


# Row 5's main shapes: (q shape, kv heads, causal, lse); bf16.
FLASH_FWD_MAIN = {"serve_flash prefill": ((1, 32, 2048, 128), 8, True, False),
                  "train forward (lse)": ((1, 32, 2048, 128), 8, True, True),
                  "solve fa_bf16": ((1, 32, 8192, 32), 32, False, False)}


def _flash_fwd_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    launchers = {w: _launcher(m, f, "flash_fwd") for w, (m, f, _) in trees.items()}
    result["ptxas"] = {w: cs._ptxas_kernels(lib.with_suffix(".log").read_text())
                       for w, (_, _, lib) in trees.items()}
    ok = True
    for name, (shape, hkv, causal, lse) in FLASH_FWD_MAIN.items():
        B, H, S, D = shape
        q = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        k, v = torch.randn((2, B, hkv, S, D), generator=g, device="cuda").to(torch.bfloat16)
        offsets = fa._offsets(0, 0, B, q.device)
        kw = dict(sm_scale=D**-0.5, causal=causal, block_kv=min(1024, S), window=None,
                  softcap=None, sinks=0)
        p_out, p_lse = fa._flash_fwd_plain(q, k, v, offsets, save_residuals=True, **kw)
        w_abs = fa._flash_fwd_plain(q, k, v.abs(), offsets, save_residuals=False, **kw)
        tol, lse_tol = cs.flash_fwd_tolerances(q, k, v, p_out, p_lse, w_abs,
                                               sm_scale=kw["sm_scale"], softcap=None)
        row, calls = {}, {}
        for which, launch in launchers.items():
            (o, l), call, keep = launch((q, k, v, offsets), save_residuals=lse, **kw)
            calls[which] = (call, (o, l, keep))
            ratios = [cs.err_over_tol(o, p_out, tol)]
            if lse:
                ratios.append(cs.err_over_tol(l, p_lse, lse_tol))
            same = cs._same_bits_again(lambda: call[0](*call[1]),
                                       [x for x in (o, l) if x is not None])
            row[which] = {"err_over_tol": ratios, "same_bits_twice": same}
            if which in ("this", "parent"):
                ok &= max(ratios) <= 1.0 and same
        _timed_turns(calls, row, iters=20)
        row["sdpa_ms"], row["sdpa_backend"] = cs._sdpa(q, k, v, is_causal=causal,
                                                       enable_gqa=hkv != H)
        pairs = B * H * cs._visible_pairs(S, S, causal)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (B * H * S * 4 if lse else 0)
        row["bound_ms"], row["bound_by"] = cs.bound(nbytes, {"bf16": 4 * pairs * D, "exp": pairs})
        result["main"][name] = row
        del q, k, v, calls
    # The f32 route: the same bits from every library.
    result["f32_same_bits"] = {}
    f32_cases = [("solve fa", (1, 32, 32, 8192, 8192, 32, False, None, 0, None, False, None))]
    f32_cases += [(f"flash_fwd{i}", c) for i, c in enumerate(cs.FLASH_FWD_COVERAGE)]
    for name, case in f32_cases:
        B, H, Hkv, Sq, Skv, D, causal, window, sinks, cap, _, offs = case
        q = torch.randn((B, H, Sq, D), generator=g, device="cuda")
        k, v = torch.randn((2, B, Hkv, Skv, D), generator=g, device="cuda")
        q_off, kv_off = offs if offs is not None else (Skv - Sq, 0)
        offsets = fa._offsets(q_off, kv_off, B, q.device)
        kw = dict(sm_scale=D**-0.5, causal=causal, block_kv=min(1024, Skv), window=window,
                  softcap=cap, sinks=sinks, save_residuals=True)
        outs = [launch((q, k, v, offsets), **kw)[0] for launch in launchers.values()]
        result["f32_same_bits"][name] = all(torch.equal(a, b) for other in outs[1:]
                                            for a, b in zip(outs[0], other))
    return ok and all(result["f32_same_bits"].values())


W4_ROWS = (1, 8, 32, 64)


def _graph_ms(module, fns, source, operands, kw, calls=20, replays=5):
    """ms a call on the card alone: `calls` launches through a tree's
    wrapper captured in one CUDA graph and replayed (back-to-back launches
    from Python can be held back by the host)."""
    make = getattr(module, LAUNCH.get(source, f"_{source}_launch"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # first launches (one-time set-up) outside the capture
        kernel, args, _, _keep = make(*operands, **kw)
        fns[kernel.symbol](*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, kept = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            kernel, args, outs, keep = make(*operands, **kw)
            fns[kernel.symbol](*args)
            kept.append((outs, keep))
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _w4_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import w4_matmul as w4
    from quantizedmha_tpu_torch.quant.weights import dequantize_weight4, quantize_weight4
    launchers = {w: _launcher(m, f, "w4_matmul") for w, (m, f, _) in trees.items()}
    trees_f32 = [launchers[w] for w in ("parent", "this") if w in launchers]
    result["ptxas"] = {w: cs._ptxas_kernels(lib.with_suffix(".log").read_text())
                       for w, (_, _, lib) in trees.items()}
    ok = True
    layer = {R: {} for R in W4_ROWS}
    result["f32_same_bits"] = {}
    for name, in_dim, n in cs.W4_MAIN:
        w = quantize_weight4(torch.randn((in_dim, n), generator=g, device="cuda") * in_dim**-0.5,
                             group=128, packing="halves")
        kw = dict(group=w.group, packing=w.packing)
        for R in W4_ROWS:
            x = torch.randn((R, in_dim), generator=g, device="cuda").to(torch.bfloat16)
            plain = w4._w4_matmul_plain(x, w.packed, w.scale, **kw)
            golden = x.float() @ dequantize_weight4(w)
            tol = cs.w4_tolerance(x, w, plain)
            gtol = cs.w4_tolerance(x, w, golden, golden=True)
            row, calls = {"splits": w4.split_k(R, in_dim // 2, n)[1]}, {}
            for which, launch in launchers.items():
                out, call, keep = launch((x, w.packed, w.scale), **kw)
                calls[which] = (call, (out, keep))
                same = cs._same_bits_again(lambda: call[0](*call[1]), [out])
                row[which] = {"err_over_tol": cs.err_over_tol(out, plain, tol),
                              "golden_err_over_tol": cs.err_over_tol(out, golden, gtol),
                              "same_bits_twice": same}
                if which in ("this", "parent"):
                    ok &= row[which]["err_over_tol"] <= 1.0 and same
                    ok &= row[which]["golden_err_over_tol"] <= 1.0
            _timed_turns(calls, row, iters=50)
            for which, (module, fns, _) in trees.items():
                row[which]["graph_ms"] = _graph_ms(module, fns, "w4_matmul",
                                                   (x, w.packed, w.scale), kw)
            row["library_ms"], _, row["library_note"] = cs._int4pack_library(x, w, golden)
            nbytes = w.packed.numel() + w.scale.numel() * 4 + (R * in_dim + R * n) * 2
            row["bound_ms"], row["bound_by"] = cs.bound(nbytes, {"bf16": 2 * R * in_dim * n})
            result["main"][f"{name} R={R}"] = row
            for which in calls:
                tot = layer[R].setdefault(which, [0.0] * len(row[which]["ms"]))
                layer[R][which] = [a + b for a, b in zip(tot, row[which]["ms"])]
                key = f"{which} graph_ms"
                layer[R][key] = layer[R].get(key, 0.0) + row[which]["graph_ms"]
            for key in ("library_ms", "bound_ms"):
                if row[key] is not None:
                    layer[R][key] = layer[R].get(key, 0.0) + row[key]
            del calls
        # The f32 route at R = 8: the same bits from the parent's library and this one.
        x = torch.randn((8, in_dim), generator=g, device="cuda")
        outs = [launch((x, w.packed, w.scale), **kw)[0] for launch in trees_f32]
        result["f32_same_bits"][name] = all(torch.equal(outs[0], o) for o in outs[1:])
        del w
    result["layer"] = {f"R={R}": v for R, v in layer.items()}
    result["coverage"] = {}
    for i, (R, in_dim, n, group, packing, _, lay) in enumerate(cs.W4_COVERAGE):
        shape = (in_dim, n) if lay is None else (3, in_dim, n)
        w = quantize_weight4(torch.randn(shape, generator=g, device="cuda"), group=group,
                             packing=packing)
        view = w if lay is None else w.layer(lay)
        kw = dict(group=group, packing=packing)
        x = torch.randn((R, in_dim), generator=g, device="cuda")
        outs = [launch((x, view.packed, view.scale), **kw)[0] for launch in trees_f32]
        result["f32_same_bits"][f"w4_{i}"] = all(torch.equal(outs[0], o) for o in outs[1:])
        xb = x.to(torch.bfloat16)
        plain = w4._w4_matmul_plain(xb, view.packed, view.scale, **kw)
        out, call, _ = launchers["this"]((xb, view.packed, view.scale), **kw)
        same = cs._same_bits_again(lambda: call[0](*call[1]), [out])
        ratio = cs.err_over_tol(out, plain, cs.w4_tolerance(xb, view, plain))
        result["coverage"][f"w4_{i}"] = {"err_over_tol": ratio, "same_bits_twice": same}
        ok &= ratio <= 1.0 and same
    return ok and all(result["f32_same_bits"].values())


def _flash_int8_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    launchers = {w: _launcher(m, f, "flash_int8_fwd") for w, (m, f, _) in trees.items()}
    result["ptxas"] = {w: cs._ptxas_kernels(lib.with_suffix(".log").read_text())
                       for w, (_, _, lib) in trees.items()}
    ok = True
    # (mode, q shape, kv heads, q dtype, block_kv, causal)
    mains = {"solve fa_int8 (bf16_p)": (1, (1, 32, 8192, 32), 32, torch.float32, 512, False),
             "serve prefill (int8_p)": (0, (1, 32, 256, 128), 8, torch.bfloat16, 256, True),
             "serve_w4 prefill (int8_p)": (0, (1, 32, 512, 128), 8, torch.bfloat16, 512, True)}
    for name, (mode, shape, hkv, dt, bkv, causal) in mains.items():
        B, H, S, D = shape
        q = torch.randn(shape, generator=g, device="cuda").to(dt)
        k, v = torch.randn((2, B, hkv, S, D), generator=g, device="cuda").to(dt)
        k_i8, ks = quantize_kv_blocks(k, bkv)
        v_i8, vs = quantize_kv_blocks(v, bkv)
        operands = (q, k_i8, ks, v_i8, vs, fa8._offsets(0, 0, B, q.device))
        kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=S, block_kv=bkv, scale_clamp=1e-8,
                  p_scale=127.0, window=None, softcap=None, sinks=0, mode=mode)
        p_out = fa8._flash_int8_plain(*operands, save_residuals=False, **kw)
        _, _, l = fa8._flash_int8_plain_state(*operands, **kw)
        tol, _ = cs.flash_tolerances(p_out, None, l, v_i8, vs, bkv, mode)
        row, calls, outs = {}, {}, {}
        for which, launch in launchers.items():
            (o, _), call, keep = launch(operands, save_residuals=False, **kw)
            calls[which] = (call, (o, keep))
            outs[which] = o
            same = cs._same_bits_again(lambda: call[0](*call[1]), [o])
            row[which] = {"err_over_tol": cs.err_over_tol(o, p_out, tol), "same_bits_twice": same}
            if which in ("this", "parent"):
                ok &= row[which]["err_over_tol"] <= 1.0 and same
        row["same_bits_as_this"] = {w: torch.equal(o, outs["this"]) for w, o in outs.items()}
        if mode == 1:  # (row 2 keeps the parent's kernel)
            ok &= row["same_bits_as_this"].get("parent", True)
        _timed_turns(calls, row, iters=20)
        for which, (module, fns, _) in trees.items():
            row[which]["graph_ms"] = _graph_ms(module, fns, "flash_int8_fwd", operands,
                                               dict(save_residuals=False, **kw))
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        row["sdpa_ms"], row["sdpa_backend"] = cs._sdpa(qb, kb, vb, is_causal=causal,
                                                       enable_gqa=hkv != H)
        pairs = B * H * cs._visible_pairs(S, S, causal)
        nbytes = q.numel() * q.element_size() * 2 + 2 * k_i8.numel() + 2 * ks.numel() * 4
        ops = {"int8": 2 * pairs * D * (2 if mode == 0 else 1),
               "bf16": 0 if mode == 0 else 2 * pairs * D, "exp": pairs}
        row["bound_ms"], row["bound_by"] = cs.bound(nbytes, ops)
        result["main"][name] = row
        del q, k, v, qb, kb, vb, calls, outs
    # The coverage cases: MODE_INT8_P's held to the plain version (the same
    # bits twice), MODE_BF16_P's to the parent's bits.
    result["int8_p_coverage"], result["bf16_p_same_bits"] = {}, {}
    for i, case in enumerate(cs.FLASH_COVERAGE):
        *operands, kw = cs.flash_coverage_inputs(g, case)
        if case[12] == 1:
            outs = [launchers[w](operands, **kw)[0] for w in ("parent", "this") if w in launchers]
            result["bf16_p_same_bits"][f"fa8_{i}"] = all(
                torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other))
            continue
        p_out, p_lse = fa8._flash_int8_plain(*operands, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            *operands, **{k: x for k, x in kw.items() if k != "save_residuals"})
        tol, lse_tol = cs.flash_tolerances(p_out, p_lse, l, operands[3], operands[4],
                                           kw["block_kv"], 0)
        row = result["int8_p_coverage"][f"fa8_{i}"] = {}
        for which, launch in launchers.items():
            (o, lse), call, _keep = launch(operands, **kw)
            same = cs._same_bits_again(lambda: call[0](*call[1]), [o, lse])
            row[which] = [cs.err_over_tol(o, p_out, tol), cs.err_over_tol(lse, p_lse, lse_tol),
                          same]
            if which in ("this", "parent"):
                ok &= max(row[which][:2]) <= 1.0 and same
    return ok and all(result["bf16_p_same_bits"].values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="root of the other tree (holds quantizedmha_tpu_torch/csrc)")
    ap.add_argument("--source", choices=sorted(OPS), default="paged_prefill")
    ap.add_argument("--variants", type=Path,
                    help="JSON {name: [[line, replacement], ...]} of this tree's source "
                         "(paged_decode, flash_fwd, w4_matmul, flash_int8_fwd)")
    ap.add_argument("--only", nargs="+", help="the variants of --variants to build")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.parent is None and args.variants is None:
        ap.error("give --parent, --variants or both")
    if args.variants is not None and args.source == "paged_prefill":
        ap.error("--variants takes --source paged_decode, flash_fwd, w4_matmul or "
                 "flash_int8_fwd")
    if not torch.cuda.is_available():
        print("paged_prefill_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = json.loads(args.variants.read_text()) if args.variants else None
    if variants is not None and args.only:
        variants = {name: variants[name] for name in args.only}
    trees = _trees(args.source, args.parent and args.parent.resolve(), variants)
    g = torch.Generator(device="cuda").manual_seed(1)
    result = {"gpu": cs.gpu_line(), "parent": args.parent and str(args.parent),
              "variants": variants, "source": args.source, "main": {}}
    ab = {"paged_prefill": _prefill_ab, "paged_decode": _decode_ab,
          "flash_fwd": _flash_fwd_ab, "w4_matmul": _w4_ab,
          "flash_int8_fwd": _flash_int8_ab}[args.source]
    result["ok"] = bool(ab(trees, g, result))
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
