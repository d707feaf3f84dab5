"""A/B of a kernel source on one card: another tree's source, such as a
parent commit unpacked beside this one (`git archive <commit> | tar -x -C
build/parent`), against this tree's, in one process.

    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --parent build/parent \\
        [--source paged_prefill|paged_decode|flash_fwd|w4_matmul|flash_int8_fwd|flash_bwd] \\
        [--out ab.json]
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source paged_prefill \\
        --parent build/parent [--split-targets 528 924 1056] [--rounds 5] \\
        [--variants quantizedmha_tpu_torch/harness/paged_prefill_variants.json]
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source paged_decode \\
        --variants quantizedmha_tpu_torch/harness/decode_ablations.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source flash_fwd \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/flash_fwd_variants.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source w4_matmul \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/w4_matmul_variants.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source flash_int8_fwd \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/flash_int8_fwd_variants.json \\
        [--only int8p_one_consumer int8p_knockout_no_exp ...] [--mains "gemma2 full (int8_p)" ...]
        [--variants-on parent]

Each library is launched through its own tree's wrapper (`ops/<op>.py`'s
`_*_launch`, loaded from that tree), so a change of the C signature is
A/B'd as well; both are built with this tree's cuda_lib.NVCC_FLAGS. With
--variants (a JSON object {name: [[line as committed, line planted],
...]}), each named variant of this tree's source, its lines replaced, is
timed in turns against this tree's, beside the parent when one is given
(a variant that knocks a phase out fails its check by design: its
err_over_tol is reported, not gated); --only keeps the named variants of
the file; --variants-on parent edits the parent's source instead, and
launches it through the parent's wrapper
(harness/flash_int8_fwd_pr25_knockouts.json: PR 25's row 1 at d=256).

--source paged_prefill (csrc/paged_prefill.cu):
- Rows 10 (`paged_prefill`) and 11 (`paged_prefill_int4`) at chip_smoke.py's
  main shapes and row 10 at serve_hybrid's d=256 chunk (2048 rows at 4096
  of context, softcap 50), bf16 q, where prefill_splits gives S = 1: each
  library's ms in turns (parent, this, this, parent; CUDA events over 20
  launches) and its err_over_tol against the plain version under
  chip_smoke.py's tolerance.
- Row 10 at verify's shapes (VERIFY_MAIN: Gemma-2's full layer at the
  coverage's 41-slot table and at serve_spec's 64 slots, its sliding
  layer, Llama-3-8B's heads at 8 sequences, serve_tp's rank at 8 q / 2 kv
  heads), where this tree takes the split key walk: the splits, each
  library's ms in turns and err_over_tol against this tree's plain version
  (which cuts the same splits), this library's bits twice, SDPA's ms on the
  dequantized K/V and the bound; with --split-targets, this library at
  prefill_splits' cut for each target_blocks, in turns (the sweep that
  chose SPLIT_TARGET_BLOCKS). --rounds repeats each shape's turns.
- Both routes, bf16 q and q taken in f32, at each main shape and at every
  paged prefill coverage case of chip_smoke.py (INT8 and INT4) where
  prefill_splits gives S = 1: whether the libraries give the same bits
  (output and lse); at the bf16 cases where S > 1, each library's
  err_over_tol.
- ptxas registers and spill bytes of each library's kernels, and its
  serialized-wgmma warnings (C7514, C7515).

--source paged_decode (csrc/paged_decode.cu):
- Rows 3 (serve's shape and serve_flash's deep decode), 4 (MQA) and 12
  (`paged_decode_int4`, serve_mixed's shape) at chip_smoke.py's main
  shapes: ms in turns as above (50 launches), err_over_tol against this
  tree's plain version, whether this tree's library gives the same bits
  twice, each C entry's host time a call (its launches enqueued, before
  the sync), and SDPA's ms on the same K/V dequantized beforehand; whether
  the parent's library gives this one's bits.
- Every DECODE_COVERAGE and DECODE_INT4_COVERAGE case of chip_smoke.py:
  whether the parent's library gives this one's bits (output and lse).

--source flash_fwd (csrc/flash_fwd.cu, row 5):
- Both routes at chip_smoke.py's main shapes: serve_flash's bucketed
  prefill (1 x 32 x 2048 x 128, 8 kv heads, causal), the train step's
  forward (the same shape with lse) and solve's fa_bf16 rung (1 x 32 x
  8192 x 32, not causal) in bf16, solve's fa rung (the same shape) in f32:
  ms in turns (20 launches; graph_ms: 20 launches in one CUDA graph,
  replayed), err_over_tol against this tree's plain version under
  chip_smoke.py's tolerance, whether each library gives the same bits
  twice, SDPA's ms on the same inputs (f32: TF32 off, and in bf16 beside
  it) and the bound (f32: six bf16 passes a product); in bf16, whether the
  parent's library gives this one's bits.
- Every bf16 FLASH_FWD_COVERAGE case: whether the parent's library gives
  this one's bits (output and lse); every f32 case and FLASH_FWD_PIECES
  case: each library's err_over_tol (output, lse) under this tree's
  tolerance and whether it gives the same bits twice.
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
  block_kv 512, not causal) and at d=128 (1 x 32 x 4096 x 128, the same
  otherwise): ms in turns (20 launches; graph_ms: 20 launches in one CUDA
  graph, replayed), err_over_tol against this tree's plain version under
  chip_smoke.py's flash_tolerances, whether each library gives the same
  bits twice, SDPA's ms (bf16, the first backend that takes the inputs)
  and the bound; whether the parent's library gives this one's bits.
- MODE_INT8_P (row 1) at the serve prefill's shape (1 x 32 x 256 x 128,
  8 kv heads, bf16 q, block_kv 256, causal) and serve_w4's (the same at
  512 tokens, block_kv 512), timed the same way, and at Gemma-2's full
  layer (1 x 16 x 2048 x 256, 8 kv heads, bf16 q, causal, block_kv 1024,
  softcap 50, and without softcap), its sliding layer (8192 tokens under
  the 4096 window) and its full layer with f32 q. --mains keeps the named
  shapes.
- MODE_BF16_P_F32L at solve's shape, and both bf16-P modes at Gemma-2's
  full layer (1 x 16 x 2048 x 256, 8 kv heads, bf16 q, causal, softcap
  50; block_kv 512 for MODE_BF16_P, 1024 for MODE_BF16_P_F32L), timed the
  same way by the libraries that have the route (a parent from before
  them has neither).
- Every MODE_BF16_P and MODE_INT8_P case of chip_smoke.py's
  FLASH_COVERAGE at d <= 128: whether the parent's library gives this
  one's bits (output and lse; so at the main shapes at d <= 128); every
  MODE_INT8_P and every other case: each library's err_over_tol (output,
  lse) and whether it gives the same bits twice.
- ptxas registers and spill bytes of each library's kernels.

--source flash_bwd (csrc/flash_bwd.cu, rows 6-7):
- Both kernels (dK/dV, then dQ) at the train step's shape (1 x 32 x 2048 x
  128, 8 kv heads, causal) in f32 and in bf16, and at train_gemma2_f32's
  full layer (1 x 16 x 8192 x 256, 8 kv heads, causal, softcap 50, a
  dlse) in f32: each kernel's ms in turns (10 launches; 3 at 8192),
  err_over_tol (dq, dk, dv) against this tree's plain version under
  chip_smoke.py's flash_bwd_tolerances, whether each library gives the
  same bits twice and this one's bits (required in bf16).
- Every FLASH_BWD_COVERAGE and FLASH_BWD_GRID case of chip_smoke.py:
  whether each library gives this one's bits (required in bf16).
- ptxas registers and spill bytes of each library's kernels.

Prints one JSON object (and writes it to --out); exits 1 when a library
fails its check, or where a route is to keep the parent's bits and does
not.
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
       "flash_int8_fwd": "flash_attention_int8", "flash_bwd": "flash_attention"}
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


def _build_variant(name: str, edits, source: str, csrc=None):
    """A tree's csrc/ (this tree's unless `csrc`) copied with one source's
    lines replaced; its build started."""
    import shutil
    from quantizedmha_tpu_torch.ops import cuda_lib
    out = cuda_lib.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc or cuda_lib.CSRC, out)
    text = (out / f"{source}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not one line of {source}.cu")
        text = text.replace(old, new)
    (out / f"{source}.cu").write_text(text)
    return _nvcc_build(out / f"{source}.cu", out / f"lib{source}.so")


def _trees(source: str, parent=None, variants=None, variants_on="this"):
    """{"parent" | variant name | "this": (ops module, bound functions,
    library)}; every library built at once. The variants edit this tree's
    source, or the parent's (variants_on="parent"), and launch through that
    tree's wrapper."""
    from quantizedmha_tpu_torch.ops import cuda_lib
    from quantizedmha_tpu_torch.ops import (decode, flash_attention, flash_attention_int8,
                                            paged_prefill, w4_matmul)
    this = {"paged_prefill": paged_prefill, "paged_decode": decode,
            "flash_fwd": flash_attention, "w4_matmul": w4_matmul,
            "flash_int8_fwd": flash_attention_int8, "flash_bwd": flash_attention}[source]
    libs, t0 = [], time.perf_counter()
    if parent is not None:
        parent_module = _ops_module(parent, source, f"_ab_parent_{source}")
        libs.append(("parent", parent_module, _build_parent(parent, source)))
    on_parent = variants_on == "parent"
    for name, edits in (variants or {}).items():
        libs.append((name, parent_module if on_parent else this,
                     _build_variant(name, edits, source,
                                    parent / "quantizedmha_tpu_torch" / "csrc" if on_parent else None)))
    cuda_lib.build_all([source])
    libs = [(which, module, _built(build)) for which, module, build in libs]
    print(f"paged_prefill_ab: {len(libs) + 1} libraries built in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
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


def _timed_turns(calls, row, iters, rounds=1):
    """ms of each library's call in turns: the others, this, this, the
    others in reverse (parent, this, this, parent), `rounds` times."""
    import chip_smoke as cs
    others = [w for w in calls if w != "this"]
    for which in (others + ["this", "this"] + others[::-1]) * rounds:
        fn, fargs = calls[which][0]
        row[which].setdefault("ms", []).append(cs.cuda_ms(lambda: fn(*fargs), iters=iters))
    if "parent" in calls:
        row["speedup"] = min(row["parent"]["ms"]) / max(row["this"]["ms"])


# Row 10 at verify's shapes (VERIFY_COVERAGE tuples, table slots or None):
# Gemma-2's full layer at the coverage's table and at serve_spec's 64 slots,
# its sliding layer (the slots behind the window on the scrap page), Llama-3-8B
# at 8 sequences, and serve_tp's rank (8 q / 2 kv heads).
VERIFY_MAIN = {"verify gemma2 full": (1, None), "verify gemma2 full (64 slots)": (1, 64),
               "verify gemma2 sliding": (0, None), "verify d128 (8 seqs)": (5, None),
               "verify serve_tp d128": ("tp", None)}


def _prefill_ab(trees, g, result, split_targets=None, rounds=1):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    launchers = {w: _launcher(m, f, "paged_prefill") for w, (m, f, _) in trees.items()}
    result["ptxas"] = {w: _ptxas(lib) for w, (_, _, lib) in trees.items()}
    q8, cache8, len8, st8, tab8 = cs._paged_main_inputs(g)
    q4, cache4, len4, tab4, st4 = cs._int4_prefill_main_inputs(g)
    nomask = dict(window=None, sinks=0, softcap=None)
    mains = {"paged_prefill": ((q8, cache8, len8, st8, tab8), False, nomask),
             "paged_prefill_int4": ((q4, cache4, len4, st4, tab4), True, nomask),
             "gemma2 chunk (d=256)": (_gemma2_chunk(g), False,
                                      dict(nomask, softcap=cs.GEMMA2_ATTN["softcap"]))}
    result["f32_same_bits"], result["bf16_same_bits"] = {}, {}
    ok = True
    for name, (inputs, int4, masks) in mains.items():
        q, cache, lengths, q_starts, tables = inputs
        operands = (q, *cache, lengths, q_starts, tables)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **masks)
        plain_fn = pp._paged_prefill_int4_plain if int4 else pp._paged_prefill_plain
        plain = plain_fn(*operands, **kw)
        w_abs = cs.prefill_w_abs(q, cache, lengths, q_starts, tables, int4=int4, **kw)
        tols = (cs.int4_tolerances if int4 else cs.paged_prefill_tolerances)(
            q, *cache, *plain, sm_scale=kw["sm_scale"], softcap=masks["softcap"], w_abs=w_abs)
        row, calls = {}, {}
        for which, launch in launchers.items():
            # calls holds each launch's outputs and operands while it is timed.
            (o, lse), call, keep = launch(operands, int4=int4, **kw)
            calls[which] = (call, (o, lse, keep))
            row[which] = {"err_over_tol": [cs.err_over_tol(o, plain[0], tols[0]),
                                           cs.err_over_tol(lse, plain[1], tols[1])]}
            ok &= max(row[which]["err_over_tol"]) <= 1.0
        result["bf16_same_bits"][name] = _same_bits(calls)
        _timed_turns(calls, row, iters=20, rounds=rounds)
        row["splits"] = list(_splits(pp, q, cache, tables))
        result["main"][name] = row
        # The f32 route at the main shape.
        f32 = (q.float(), *operands[1:])
        outs = [launch(f32, int4=int4, **kw)[0] for launch in launchers.values()]
        result["f32_same_bits"][name] = _all_equal(outs)
    ok &= _verify_ab(launchers, result, split_targets, rounds)
    # The coverage cases: where prefill_splits gives S = 1, every library's
    # bits; where S > 1 (this tree's split walk, the parent's one walk),
    # each library's err_over_tol against this tree's plain version.
    cases = ([(f"paged_prefill{i}", c, False) for i, c in enumerate(cs.PAGED_PREFILL_COVERAGE)]
             + [(f"paged_prefill_int4_{i}", c, True)
                for i, c in enumerate(cs.PREFILL_INT4_COVERAGE)])
    result["bf16_split_err_over_tol"] = {}
    for route, dt in (("f32_same_bits", torch.float32), ("bf16_same_bits", torch.bfloat16)):
        for name, case, int4 in cases:
            q, cache, lengths, q_starts, tables, masks = cs.paged_prefill_coverage_inputs(
                g, case, int4=int4, q_dtype=dt)
            operands = (q, *cache, lengths, q_starts, tables)
            kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **masks)
            outs = {w: launch(operands, int4=int4, **kw)[0] for w, launch in launchers.items()}
            if _splits(pp, q, cache, tables)[0] == 1:
                result[route][name] = _all_equal(list(outs.values()))
                continue
            plain = (pp._paged_prefill_int4_plain if int4 else pp._paged_prefill_plain)(
                *operands, **kw)
            w_abs = cs.prefill_w_abs(q, cache, lengths, q_starts, tables, int4=int4, **kw)
            tols = (cs.int4_tolerances if int4 else cs.paged_prefill_tolerances)(
                q, *cache, *plain, sm_scale=kw["sm_scale"], softcap=masks["softcap"],
                w_abs=w_abs)
            errs = {w: [cs.err_over_tol(x, p, t) for x, p, t in zip(o, plain, tols)]
                    for w, o in outs.items()}
            result["bf16_split_err_over_tol"][name] = errs
            ok &= all(max(e) <= 1.0 for e in errs.values())
    return (ok and all(result["f32_same_bits"].values())
            and all(result["bf16_same_bits"].values()))


def _gemma2_chunk(g):
    """(q, cache, lengths, q_starts, tables) of serve_hybrid's full-layer
    chunk at d=256: 2048 rows at 4096 of context, Gemma-2's heads."""
    import chip_smoke as cs
    ga = cs.GEMMA2_ATTN
    Hq, Hkv, D, P = (ga[x] for x in ("Hq", "Hkv", "D", "P"))
    C, q0 = 2048, 4096
    n_pages = (q0 + C) // P
    cache = cs._paged_cache(g, Hkv, n_pages + 1, P, D)
    tables = (torch.randperm(n_pages, generator=g, device="cuda") + 1)[None].to(torch.int32)
    q = torch.randn((1, Hq, C, D), generator=g, device="cuda").to(torch.bfloat16)
    return (q, cache, torch.tensor([q0 + C], dtype=torch.int32, device="cuda"),
            torch.tensor([q0], dtype=torch.int32, device="cuda"), tables)


def _all_equal(outs):
    """Whether every library's outputs (a tuple each) are the first's bits."""
    return all(torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other))


def _ptxas(lib):
    """A library's ptxas report: {kernel: [registers, spill store bytes]}
    and its serialized-wgmma warnings (C7514, C7515)."""
    import re
    import chip_smoke as cs
    log = lib.with_suffix(".log").read_text()
    return {"kernels": cs._ptxas_kernels(log), "C7514": len(re.findall("C7514", log)),
            "C7515": len(re.findall("C7515", log))}


def _splits(pp, q, cache, tables, **kw):
    """prefill_splits of this tree at a launch's shapes."""
    B, Hq, C, D = q.shape
    Hkv, P = cache[0].shape[0], cache[0].shape[2]
    return pp.prefill_splits(B, Hkv, C, Hq // Hkv, D, tables.shape[1], P, q.dtype, **kw)


def _verify_ab(launchers, result, split_targets, rounds=1):
    """VERIFY_MAIN: each library's ms in turns (20 launches), err_over_tol
    against this tree's plain version (which cuts this tree's splits), this
    library's bits twice, SDPA's ms and the bound; with split_targets, this
    library at prefill_splits' cut for each target, in turns (ascending,
    then descending)."""
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    ok = True
    for name, (which, slots) in VERIFY_MAIN.items():
        g = torch.Generator(device="cuda").manual_seed(380 + (0 if which == "tp" else which))
        case = cs.VERIFY_TP["case"] if which == "tp" else cs.VERIFY_COVERAGE[which]
        slots = cs.VERIFY_TP["slots"] if which == "tp" else slots
        q, cache, lengths, q_starts, tables, clean, masks = cs.verify_coverage_inputs(
            g, case, slots)
        operands = (q, *cache, lengths, q_starts, tables)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **masks)
        plain = pp._paged_prefill_plain(*operands, **kw)
        w_abs = cs.prefill_w_abs(q, clean, lengths, q_starts, tables, **kw)
        tols = cs.paged_prefill_tolerances(q, *clean, *plain, sm_scale=kw["sm_scale"],
                                           softcap=masks["softcap"], w_abs=w_abs)
        row, calls = {"splits": list(_splits(pp, q, cache, tables)),
                      "lengths": lengths.tolist(), "max_pages": tables.shape[1]}, {}
        for which_lib, launch in launchers.items():
            (o, lse), call, keep = launch(operands, **kw)
            calls[which_lib] = (call, (o, lse, keep))
            row[which_lib] = {"err_over_tol": [cs.err_over_tol(o, plain[0], tols[0]),
                                               cs.err_over_tol(lse, plain[1], tols[1])]}
            ok &= max(row[which_lib]["err_over_tol"]) <= 1.0
        row["this"]["same_bits_twice"] = cs._same_bits_again(
            lambda: calls["this"][0][0](*calls["this"][0][1]), calls["this"][1][:2])
        ok &= row["this"]["same_bits_twice"]
        _timed_turns(calls, row, iters=20, rounds=rounds)
        nbytes, ops, library = cs.verify_yardsticks(q, clean, lengths, q_starts, tables,
                                                    masks["window"])
        row["bound_ms"], row["bound_by"] = cs.bound(nbytes, ops)
        row["sdpa_ms"], row["sdpa_backend"] = library()
        if split_targets:
            make = launchers["this"]
            sweep = {}
            for target in list(split_targets) + list(split_targets)[::-1]:
                splits = _splits(pp, q, cache, tables, target_blocks=target)
                (o, _), (fn, fargs), keep = make(operands, splits=splits, **kw)
                sweep.setdefault(str(target), {"splits": list(splits), "ms": []})["ms"].append(
                    cs.cuda_ms(lambda: fn(*fargs), iters=20))
                del keep
            row["split_sweep"] = sweep
        result["main"][name] = row
        del calls
    return ok


def _same_bits(calls):
    """Whether every library's outputs ((output, lse) of calls[w][1],
    None where there is no lse) are this one's bits."""
    this = calls["this"][1][:2]
    return all(torch.equal(a, b) for w, c in calls.items() if w != "this"
               for a, b in zip(this, c[1][:2]) if a is not None)


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
        if "parent" in calls:
            row["same_bits_as_parent"] = _same_bits(calls)
            ok &= row["same_bits_as_parent"]
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
    if "parent" not in launchers:
        return ok
    # The coverage cases: the parent's bits (output and lse).
    result["same_bits_as_parent"] = {}
    for i, case in enumerate(cs.DECODE_COVERAGE):
        operands, kw = cs.decode_coverage_inputs(g, case)
        outs = [launchers[w](operands, int4=False, **kw)[0] for w in ("parent", "this")]
        result["same_bits_as_parent"][f"decode{i}"] = all(
            torch.equal(a, b) for a, b in zip(*outs))
    for i, case in enumerate(cs.DECODE_INT4_COVERAGE):
        q, cache, lengths, tables, masks = cs.decode_int4_coverage_inputs(g, case)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **masks)
        outs = [launchers[w]((q, *cache, lengths, tables), int4=True, **kw)[0]
                for w in ("parent", "this")]
        result["same_bits_as_parent"][f"paged_decode_int4_{i}"] = all(
            torch.equal(a, b) for a, b in zip(*outs))
    return ok and all(result["same_bits_as_parent"].values())


# Row 5's main shapes: (q shape, kv heads, causal, lse, dtype).
FLASH_FWD_MAIN = {"serve_flash prefill": ((1, 32, 2048, 128), 8, True, False, torch.bfloat16),
                  "train forward (lse)": ((1, 32, 2048, 128), 8, True, True, torch.bfloat16),
                  "solve fa_bf16": ((1, 32, 8192, 32), 32, False, False, torch.bfloat16),
                  "solve fa (f32)": ((1, 32, 8192, 32), 32, False, False, torch.float32)}


def _flash_fwd_plain_tols(q, k, v, offsets, kw):
    """The plain version's (o, lse) and chip_smoke's tolerances on them."""
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    p_out, p_lse = fa._flash_fwd_plain(q, k, v, offsets, save_residuals=True, **kw)
    w_abs = fa._flash_fwd_plain(q, k, v.abs(), offsets, save_residuals=False, **kw)
    tol, lse_tol = cs.flash_fwd_tolerances(q, k, v, p_out, p_lse, w_abs, sm_scale=kw["sm_scale"],
                                           softcap=kw["softcap"])
    return p_out, p_lse, tol, lse_tol


def _flash_fwd_ratios(launch, operands, kw, plain, save_residuals=True):
    """One launch through a tree against the plain version (o, lse, tol,
    lse_tol): ([output, lse] err_over_tol, the same bits twice, outputs,
    (function, ctypes args), kept operands)."""
    import chip_smoke as cs
    p_out, p_lse, tol, lse_tol = plain
    (o, l), call, keep = launch(operands, save_residuals=save_residuals, **kw)
    ratios = [cs.err_over_tol(o, p_out, tol)]
    if save_residuals:
        ratios.append(cs.err_over_tol(l, p_lse, lse_tol))
    outs = [x for x in (o, l) if x is not None]
    same = cs._same_bits_again(lambda: call[0](*call[1]), outs)
    return ratios, same, outs, call, keep


def _flash_fwd_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    launchers = {w: _launcher(m, f, "flash_fwd") for w, (m, f, _) in trees.items()}
    result["ptxas"] = {w: cs._ptxas_kernels(lib.with_suffix(".log").read_text())
                       for w, (_, _, lib) in trees.items()}
    ok = True
    for name, (shape, hkv, causal, lse, dt) in FLASH_FWD_MAIN.items():
        B, H, S, D = shape
        q = torch.randn(shape, generator=g, device="cuda").to(dt)
        k, v = torch.randn((2, B, hkv, S, D), generator=g, device="cuda").to(dt)
        offsets = fa._offsets(0, 0, B, q.device)
        kw = dict(sm_scale=D**-0.5, causal=causal, block_kv=min(1024, S), window=None,
                  softcap=None, sinks=0)
        plain = _flash_fwd_plain_tols(q, k, v, offsets, kw)
        row, calls, outs = {}, {}, {}
        for which, launch in launchers.items():
            ratios, same, outs[which], call, keep = _flash_fwd_ratios(
                launch, (q, k, v, offsets), kw, plain, save_residuals=lse)
            calls[which] = (call, (outs[which], keep))
            row[which] = {"err_over_tol": ratios, "same_bits_twice": same}
            if which in ("this", "parent"):
                ok &= max(ratios) <= 1.0 and same
        if dt == torch.bfloat16 and "parent" in outs:
            row["same_bits_as_parent"] = all(
                torch.equal(a, b) for a, b in zip(outs["this"], outs["parent"]))
            ok &= row["same_bits_as_parent"]
        _timed_turns(calls, row, iters=20)
        for which, (module, fns, _) in trees.items():
            row[which]["graph_ms"] = _graph_ms(module, fns, "flash_fwd", (q, k, v, offsets),
                                               dict(save_residuals=lse, **kw))
        row["sdpa_ms"], row["sdpa_backend"] = cs._sdpa(q, k, v, is_causal=causal,
                                                       enable_gqa=hkv != H)
        if dt == torch.float32:  # beside SDPA in f32 (TF32 off), SDPA in bf16
            row["sdpa_bf16_ms"], row["sdpa_bf16_backend"] = cs._sdpa(
                *(x.to(torch.bfloat16) for x in (q, k, v)), is_causal=causal,
                enable_gqa=hkv != H)
        pairs = B * H * cs._visible_pairs(S, S, causal)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + (
            B * H * S * 4 if lse else 0)
        passes = 1 if dt == torch.bfloat16 else 6
        row["bound_ms"], row["bound_by"] = cs.bound(
            nbytes, {"bf16": passes * 4 * pairs * D, "exp": pairs})
        result["main"][name] = row
        del q, k, v, calls, outs
    # The coverage cases: the bf16 route's bits against the parent's; the
    # f32 route (and FLASH_FWD_PIECES) held to this tree's tolerance, each
    # library, the same bits twice.
    result["bf16_same_bits"], result["f32_coverage"] = {}, {}
    cases = [(f"flash_fwd{i}", c) for i, c in enumerate(cs.FLASH_FWD_COVERAGE)]
    cases += [(f"flash_fwd_pieces{i}", c) for i, c in enumerate(cs.FLASH_FWD_PIECES)]
    for name, case in cases:
        if name.startswith("flash_fwd_pieces"):
            q, k, v = cs.flash_fwd_pieces_inputs(g, case)
            offsets = fa._offsets(0, 0, case[0], q.device)
            masks = dict(causal=True, window=None, sinks=0, softcap=None)
        else:
            q, k, v, offsets, masks = cs.flash_fwd_coverage_inputs(g, case)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, block_kv=min(1024, k.shape[2]), **masks)
        if q.dtype == torch.bfloat16:
            outs = [launchers[w]((q, k, v, offsets), save_residuals=True, **kw)[0]
                    for w in ("parent", "this") if w in launchers]
            result["bf16_same_bits"][name] = all(
                torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other))
            continue
        plain = _flash_fwd_plain_tols(q, k, v, offsets, kw)
        row = result["f32_coverage"][name] = {}
        for which, launch in launchers.items():
            ratios, same, *_ = _flash_fwd_ratios(launch, (q, k, v, offsets), kw, plain)
            row[which] = ratios + [same]
            if which in ("this", "parent"):
                ok &= max(ratios) <= 1.0 and same
    return ok and all(result["bf16_same_bits"].values())


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


def _parent_has(module, mode, D):
    """Whether a parent tree (its ops module) has the route: MODE_INT8_P and
    MODE_BF16_P at d <= 128 every tree; MODE_BF16_P_F32L, and both bf16-P
    modes at d=256, the trees that have MODE_BF16_P_F32L's counter (they
    came together). Where it has not, the A/B of the route times this
    tree's library and its variants alone."""
    return mode == 0 or (mode == 1 and D <= 128) or hasattr(module, "FLASH_BF16_P_F32L")


def _flash_int8_ab(trees, g, result, mains_only=None, out=None):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    launchers = {w: _launcher(m, f, "flash_int8_fwd") for w, (m, f, _) in trees.items()}
    result["ptxas"] = {w: cs._ptxas_kernels(lib.with_suffix(".log").read_text())
                       for w, (_, _, lib) in trees.items()}
    t_start = time.perf_counter()
    ok = True
    # (mode, q shape, kv heads, q dtype, block_kv, causal, softcap[, window])
    mains = {"solve fa_int8 (bf16_p)": (1, (1, 32, 8192, 32), 32, torch.float32, 512, False,
                                        None),
             "d=128 not causal (bf16_p)": (1, (1, 32, 4096, 128), 32, torch.float32, 512, False,
                                           None),
             "serve prefill (int8_p)": (0, (1, 32, 256, 128), 8, torch.bfloat16, 256, True, None),
             "serve_w4 prefill (int8_p)": (0, (1, 32, 512, 128), 8, torch.bfloat16, 512, True,
                                           None),
             "solve shape (bf16_p_f32l)": (2, (1, 32, 8192, 32), 32, torch.float32, 512, False,
                                           None),
             "gemma2 full (bf16_p)": (1, (1, 16, 2048, 256), 8, torch.bfloat16, 512, True, 50.0),
             "gemma2 full no softcap (bf16_p)": (1, (1, 16, 2048, 256), 8, torch.bfloat16, 512,
                                                 True, None),
             "gemma2 sliding (bf16_p)": (1, (1, 16, 8192, 256), 8, torch.bfloat16, 512, True,
                                         50.0, 4096),
             "gemma2 full f32 q (bf16_p)": (1, (1, 16, 2048, 256), 8, torch.float32, 512, True,
                                            50.0),
             "gemma2 full (bf16_p_f32l)": (2, (1, 16, 2048, 256), 8, torch.bfloat16, 1024, True,
                                           50.0),
             "gemma2 full (int8_p)": (0, (1, 16, 2048, 256), 8, torch.bfloat16, 1024, True, 50.0),
             "gemma2 full no softcap (int8_p)": (0, (1, 16, 2048, 256), 8, torch.bfloat16, 1024,
                                                 True, None),
             "gemma2 sliding (int8_p)": (0, (1, 16, 8192, 256), 8, torch.bfloat16, 1024, True,
                                         50.0, 4096),
             "gemma2 full f32 q (int8_p)": (0, (1, 16, 2048, 256), 8, torch.float32, 1024, True,
                                            50.0)}
    if mains_only:
        mains = {name: mains[name] for name in mains_only}
    for name, (mode, shape, hkv, dt, bkv, causal, cap, *window) in mains.items():
        window = window[0] if window else None
        B, H, S, D = shape
        q = torch.randn(shape, generator=g, device="cuda").to(dt)
        k, v = torch.randn((2, B, hkv, S, D), generator=g, device="cuda").to(dt)
        k_i8, ks = quantize_kv_blocks(k, bkv)
        v_i8, vs = quantize_kv_blocks(v, bkv)
        operands = (q, k_i8, ks, v_i8, vs, fa8._offsets(0, 0, B, q.device))
        kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=S, block_kv=bkv, scale_clamp=1e-8,
                  p_scale=127.0, window=window, softcap=cap, sinks=0, mode=mode)
        p_out = fa8._flash_int8_plain(*operands, save_residuals=False, **kw)
        _, _, l = fa8._flash_int8_plain_state(*operands, **kw)
        tol, _ = cs.flash_tolerances(p_out, None, l, v_i8, vs, bkv, mode)
        row, calls, outs = {}, {}, {}
        for which, launch in launchers.items():
            if which == "parent" and not _parent_has(trees["parent"][0], mode, D):
                continue
            (o, _), call, keep = launch(operands, save_residuals=False, **kw)
            calls[which] = (call, (o, keep))
            outs[which] = o
            same = cs._same_bits_again(lambda: call[0](*call[1]), [o])
            row[which] = {"err_over_tol": cs.err_over_tol(o, p_out, tol), "same_bits_twice": same}
            if which in ("this", "parent"):
                ok &= row[which]["err_over_tol"] <= 1.0 and same
        row["same_bits_as_this"] = {w: torch.equal(o, outs["this"]) for w, o in outs.items()}
        if D <= 128:  # (rows 1-2 keep the parent's kernels there; d=256 is held to the plain)
            ok &= row["same_bits_as_this"].get("parent", True)
        _timed_turns(calls, row, iters=20)
        for which, (module, fns, _) in trees.items():
            if which in row:
                row[which]["graph_ms"] = _graph_ms(module, fns, "flash_int8_fwd", operands,
                                                   dict(save_residuals=False, **kw))
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        if window is None:
            sdpa_kw = dict(is_causal=causal)
            pairs = B * H * cs._visible_pairs(S, S, causal)
        else:
            i = torch.arange(S, device="cuda")
            sdpa_kw = dict(attn_mask=(i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))
            pairs = B * H * cs._int8p_window_pairs(S, window)
        row["sdpa_ms"], row["sdpa_backend"] = cs._sdpa(qb, kb, vb, enable_gqa=hkv != H, **sdpa_kw)
        nbytes = q.numel() * q.element_size() * 2 + 2 * k_i8.numel() + 2 * ks.numel() * 4
        ops = {"int8": 2 * pairs * D * (2 if mode == 0 else 1),
               "bf16": 0 if mode == 0 else 2 * pairs * D, "exp": pairs}
        row["bound_ms"], row["bound_by"] = cs.bound(nbytes, ops)
        result["main"][name] = row
        print(f"paged_prefill_ab: {name} at {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr, flush=True)
        if out is not None:  # (each main as it ends: a later hang keeps them)
            _write(out, result)
        del q, k, v, qb, kb, vb, calls, outs
    # The coverage cases: every mode's at d <= 128 held to the parent's bits
    # (where the parent has the route); every case but MODE_BF16_P's at d <=
    # 128 to the plain version (the same bits twice), each by every library
    # that has its route.
    result["plain_coverage"], result["parent_bits"] = {}, {}
    for i, case in enumerate(cs.FLASH_COVERAGE):
        *operands, kw = cs.flash_coverage_inputs(g, case)
        mode, D = case[12], case[6]
        if D <= 128:
            outs = [launchers[w](operands, **kw)[0] for w in ("parent", "this")
                    if w in launchers and (w == "this" or _parent_has(trees[w][0], mode, D))]
            result["parent_bits"][f"fa8_{i}"] = all(
                torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other))
            if mode == 1:
                continue
        p_out, p_lse = fa8._flash_int8_plain(*operands, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            *operands, **{k: x for k, x in kw.items() if k != "save_residuals"})
        tol, lse_tol = cs.flash_tolerances(p_out, p_lse, l, operands[3], operands[4],
                                           kw["block_kv"], mode)
        row = result["plain_coverage"][f"fa8_{i}"] = {}
        for which, launch in launchers.items():
            if which == "parent" and not _parent_has(trees["parent"][0], mode, D):
                continue
            (o, lse), call, _keep = launch(operands, **kw)
            same = cs._same_bits_again(lambda: call[0](*call[1]), [o, lse])
            row[which] = [cs.err_over_tol(o, p_out, tol), cs.err_over_tol(lse, p_lse, lse_tol),
                          same]
            if which in ("this", "parent"):
                ok &= max(row[which][:2]) <= 1.0 and same
    return ok and all(result["parent_bits"].values())


# Rows 6-7's shapes: (B, H, Hkv, S, D, dtype, softcap, dlse), causal.
FLASH_BWD_MAIN = {"train (f32)": (1, 32, 8, 2048, 128, torch.float32, None, False),
                  "train (bf16)": (1, 32, 8, 2048, 128, torch.bfloat16, None, False),
                  "train_gemma2_f32 full layer": (1, 16, 8, 8192, 256, torch.float32, 50.0,
                                                  True)}


def _flash_bwd_ab(trees, g, result):
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention as fa
    result["ptxas"] = {w: cs._ptxas_kernels(lib.with_suffix(".log").read_text())
                       for w, (_, _, lib) in trees.items()}

    def launch(which, q, k, v, o, lse, do, offsets, dlse, kw):
        """(grads, [(function, ctypes args) of dK/dV, of dQ], kept operands):
        both launches through a tree's wrapper and library, run once."""
        module, fns, _ = trees[which]
        launches, grads, keep = module._flash_bwd_launch(q, k, v, o, lse, do, offsets, dlse,
                                                         **kw)
        calls = [(fns[kernel.symbol], args) for kernel, args in launches]
        for fn, args in calls:
            err = fn(*args)
            if err:
                raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
        torch.cuda.synchronize()
        return grads, calls, keep

    ok = True
    for name, (B, H, Hkv, S, D, dt, cap, with_dlse) in FLASH_BWD_MAIN.items():
        q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dt)
        k, v = torch.randn((2, B, Hkv, S, D), generator=g, device="cuda").to(dt)
        do = torch.randn((B, H, S, D), generator=g, device="cuda").to(dt)
        dlse = torch.randn((B, H, S), generator=g, device="cuda") if with_dlse else None
        offsets = fa._offsets(0, 0, B, q.device)
        kw = dict(sm_scale=D**-0.5, causal=True, window=None, softcap=cap, sinks=0)
        o, lse = fa._flash_fwd_cuda(q, k, v, offsets, block_kv=min(1024, S),
                                    save_residuals=True, **kw)
        plain = fa._flash_bwd_plain(q, k, v, o, lse, do, offsets, dlse, **kw)
        tols = cs.flash_bwd_tolerances(q, k, v, o, lse, do, dlse, offsets, plain, **kw)
        row, calls, outs = {}, {}, {}
        for which in trees:
            grads, calls[which], keep = launch(which, q, k, v, o, lse, do, offsets, dlse, kw)
            outs[which] = (grads, keep)
            same = cs._same_bits_again(lambda: [fn(*a) for fn, a in calls[which]], list(grads))
            row[which] = {"err_over_tol": [cs.err_over_tol(x, p, t)
                                           for x, p, t in zip(grads, plain, tols)],
                          "same_bits_twice": same}
            ok &= max(row[which]["err_over_tol"]) <= 1.0 and same
        row["same_bits_as_this"] = {
            w: all(torch.equal(a, b) for a, b in zip(x[0], outs["this"][0]))
            for w, x in outs.items()}
        if dt == torch.bfloat16:  # (the f32 route is held to its tolerance)
            ok &= all(row["same_bits_as_this"].values())
        for i, kern in enumerate(("dkv", "dq")):  # each kernel's ms in turns
            row[kern] = {w: {} for w in trees}
            _timed_turns({w: (calls[w][i],) for w in trees}, row[kern],
                         iters=10 if S <= 2048 else 3)
        result["main"][name] = row
        del q, k, v, do, o, lse, plain, tols, calls, outs
    # Every coverage case and grid case: whether each library gives this
    # one's bits (dq, dk, dv); the bf16 cases must.
    result["coverage_same_bits"], bf16_cases = {}, []
    cases = [(f"flash_bwd{i}", c) for i, c in enumerate(cs.FLASH_BWD_COVERAGE)]
    cases += [(f"flash_bwd_grid{i}", c) for i, c in enumerate(cs.FLASH_BWD_GRID)]
    for name, case in cases:
        if name.startswith("flash_bwd_grid"):
            q, k, v, do, dlse, offsets = cs.flash_bwd_grid_inputs(g, case)
            masks = dict(causal=True, window=case[-1], sinks=0, softcap=50.0)
        else:
            q, k, v, do, dlse, offsets, masks = cs.flash_bwd_coverage_inputs(g, case)
        if q.dtype == torch.bfloat16:
            bf16_cases.append(name)
        kw = dict(sm_scale=q.shape[-1] ** -0.5, **masks)
        o, lse = fa._flash_fwd_cuda(q, k, v, offsets, block_kv=min(1024, k.shape[2]),
                                    save_residuals=True, **kw)
        outs = {w: launch(w, q, k, v, o, lse, do, offsets, dlse, kw) for w in trees}
        result["coverage_same_bits"][name] = all(
            torch.equal(a, b) for x in outs.values() for a, b in zip(x[0], outs["this"][0]))
    return ok and all(result["coverage_same_bits"][name] for name in bf16_cases)


def _write(path, result):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="root of the other tree (holds quantizedmha_tpu_torch/csrc)")
    ap.add_argument("--source", choices=sorted(OPS), default="paged_prefill")
    ap.add_argument("--variants", type=Path,
                    help="JSON {name: [[line, replacement], ...]} of this tree's source")
    ap.add_argument("--only", nargs="+", help="the variants of --variants to build")
    ap.add_argument("--variants-on", choices=("this", "parent"), default="this",
                    help="the tree whose source the variants edit (parent: needs --parent)")
    ap.add_argument("--mains", nargs="+",
                    help="flash_int8_fwd: the main shapes to time (default: every one)")
    ap.add_argument("--split-targets", nargs="+", type=int,
                    help="paged_prefill: prefill_splits' target_blocks to sweep at the "
                         "verify shapes, this tree's library")
    ap.add_argument("--rounds", type=int, default=1,
                    help="paged_prefill: rounds of timed turns at each main and verify shape")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.parent is None and args.variants is None:
        ap.error("give --parent, --variants or both")
    if args.variants_on == "parent" and args.parent is None:
        ap.error("--variants-on parent needs --parent")
    if not torch.cuda.is_available():
        print("paged_prefill_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = json.loads(args.variants.read_text()) if args.variants else None
    if variants is not None and args.only:
        variants = {name: variants[name] for name in args.only}
    trees = _trees(args.source, args.parent and args.parent.resolve(), variants, args.variants_on)
    g = torch.Generator(device="cuda").manual_seed(1)
    result = {"gpu": cs.gpu_line(), "parent": args.parent and str(args.parent),
              "variants": variants, "source": args.source, "main": {}}
    ab = {"paged_prefill": _prefill_ab, "paged_decode": _decode_ab,
          "flash_fwd": _flash_fwd_ab, "w4_matmul": _w4_ab,
          "flash_int8_fwd": _flash_int8_ab, "flash_bwd": _flash_bwd_ab}[args.source]
    if args.source == "flash_int8_fwd":
        result["ok"] = bool(ab(trees, g, result, args.mains, args.out))
    elif args.source == "paged_prefill":
        result["ok"] = bool(ab(trees, g, result, args.split_targets, args.rounds))
    else:
        result["ok"] = bool(ab(trees, g, result))
    if args.out is not None:
        _write(args.out, result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
