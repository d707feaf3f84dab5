"""A/B of an attention kernel source on one card: another tree's source,
such as a parent commit unpacked beside this one (`git archive <commit> |
tar -x -C build/parent`), against this tree's, in one process.

    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --parent build/parent \\
        [--source paged_prefill|paged_decode|flash_fwd] [--out ab.json]
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source paged_decode \\
        --variants quantizedmha_tpu_torch/harness/decode_ablations.json
    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --source flash_fwd \\
        --parent build/parent --variants quantizedmha_tpu_torch/harness/flash_fwd_variants.json

Each library is launched through its own tree's wrapper (`ops/<op>.py`'s
`_*_launch`, loaded from that tree), so a change of the C signature is
A/B'd as well; both are built with this tree's cuda_lib.NVCC_FLAGS. With
--variants (a JSON object {name: [[line as committed, line planted],
...]}), each named variant of this tree's source, its lines replaced, is
timed in turns against this tree's, beside the parent when one is given
(a variant that knocks a phase out fails its check by design: its
err_over_tol is reported, not gated).

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
       "flash_fwd": "flash_attention"}


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
    from quantizedmha_tpu_torch.ops import decode, flash_attention, paged_prefill
    this = {"paged_prefill": paged_prefill, "paged_decode": decode,
            "flash_fwd": flash_attention}[source]
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
    make = getattr(module, f"_{source}_launch")

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="root of the other tree (holds quantizedmha_tpu_torch/csrc)")
    ap.add_argument("--source", choices=sorted(OPS), default="paged_prefill")
    ap.add_argument("--variants", type=Path,
                    help="JSON {name: [[line, replacement], ...]} of this tree's source "
                         "(paged_decode, flash_fwd)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.parent is None and args.variants is None:
        ap.error("give --parent, --variants or both")
    if args.variants is not None and args.source == "paged_prefill":
        ap.error("--variants takes --source paged_decode or flash_fwd")
    if not torch.cuda.is_available():
        print("paged_prefill_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = json.loads(args.variants.read_text()) if args.variants else None
    trees = _trees(args.source, args.parent and args.parent.resolve(), variants)
    g = torch.Generator(device="cuda").manual_seed(1)
    result = {"gpu": cs.gpu_line(), "parent": args.parent and str(args.parent),
              "variants": variants, "source": args.source, "main": {}}
    ab = {"paged_prefill": _prefill_ab, "paged_decode": _decode_ab,
          "flash_fwd": _flash_fwd_ab}[args.source]
    result["ok"] = bool(ab(trees, g, result))
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
