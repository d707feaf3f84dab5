"""A/B of the paged prefill kernel source (csrc/paged_prefill.cu) on one
card: another tree's source, such as a parent commit unpacked beside this
one (`git archive <commit> | tar -x -C build/parent`), against this tree's,
in one process.

    python -m quantizedmha_tpu_torch.harness.paged_prefill_ab --parent build/parent \\
        [--out chiprun_out/paged_prefill_ab.json]

- Rows 10 (`paged_prefill`) and 11 (`paged_prefill_int4`) at chip_smoke.py's
  main shapes, bf16 q: each library's ms in turns (parent, this, this,
  parent; CUDA events over 20 launches) and its err_over_tol against the
  plain version under chip_smoke.py's tolerance.
- The f32-q route at each main shape and at every paged prefill coverage
  case of chip_smoke.py (INT8 and INT4), q taken in f32: whether the two
  libraries give the same bits (output and lse).

Prints one JSON object (and writes it to --out); exits 1 when the f32
route's bits differ or a library fails its check. Both libraries are built
with cuda_lib.NVCC_FLAGS and called through the same ctypes arguments.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]


def _bind(lib_path):
    """{symbol: ctypes function} of a paged prefill library."""
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for kern in (pp.PAGED_PREFILL, pp.PAGED_PREFILL_INT4):
        fn = getattr(lib, kern.symbol)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        fns[kern.symbol] = fn
    return fns


def _build_parent(parent: Path) -> Path:
    from quantizedmha_tpu_torch.ops import cuda_lib
    out = parent / "_ab" / "libpaged_prefill.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = parent / "quantizedmha_tpu_torch" / "csrc" / "paged_prefill.cu"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    return out


def _launch(fns, inputs, masks, int4):
    """One launch of a library's entry: (o, lse, (its function, ctypes
    args), the operands those raw pointers name)."""
    from quantizedmha_tpu_torch.ops import paged_prefill as pp
    q, cache, lengths, q_starts, tables = inputs
    kernel, args, (o, lse), keep = pp._paged_prefill_launch(
        q, *cache, lengths, q_starts, tables, sm_scale=q.shape[-1] ** -0.5,
        save_residuals=True, int4=int4, **masks)
    fn = fns[kernel.symbol]
    err = fn(*args)
    if err:
        raise RuntimeError(f"{kernel.symbol}: CUDA error {err}")
    torch.cuda.synchronize()
    return o, lse, (fn, args), keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other tree (holds quantizedmha_tpu_torch/csrc)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_prefill_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import cuda_lib
    from quantizedmha_tpu_torch.ops import paged_prefill as pp

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.build_all(["paged_prefill"])
    libs = {"parent": _bind(_build_parent(args.parent.resolve())),
            "this": _bind(cuda_lib.library_path("paged_prefill"))}
    g = torch.Generator(device="cuda").manual_seed(1)
    q8, cache8, len8, st8, tab8 = cs._paged_main_inputs(g)
    q4, cache4, len4, tab4, st4 = cs._int4_prefill_main_inputs(g)
    mains = {"paged_prefill": ((q8, cache8, len8, st8, tab8), False),
             "paged_prefill_int4": ((q4, cache4, len4, st4, tab4), True)}
    nomask = dict(window=None, sinks=0, softcap=None)
    result = {"gpu": cs.gpu_line(), "parent": str(args.parent), "main": {}, "f32_same_bits": {}}
    ok = True
    for name, (inputs, int4) in mains.items():
        q, cache, lengths, q_starts, tables = inputs
        kw = dict(sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **nomask)
        plain_fn = pp._paged_prefill_int4_plain if int4 else pp._paged_prefill_plain
        plain = plain_fn(q, *cache, lengths, q_starts, tables, **kw)
        w_abs = cs.prefill_w_abs(q, cache, lengths, q_starts, tables, int4=int4, **kw)
        tols = (cs.int4_tolerances if int4 else cs.paged_prefill_tolerances)(
            q, *cache, *plain, sm_scale=kw["sm_scale"], softcap=None, w_abs=w_abs)
        row, calls = {}, {}
        for which, fns in libs.items():
            # calls holds each launch's outputs and operands while it is timed.
            o, lse, call, keep = _launch(fns, inputs, nomask, int4)
            calls[which] = (call, (o, lse, keep))
            row[which] = {"err_over_tol": [cs.err_over_tol(o, plain[0], tols[0]),
                                           cs.err_over_tol(lse, plain[1], tols[1])]}
            ok &= max(row[which]["err_over_tol"]) <= 1.0
        for which in ("parent", "this", "this", "parent"):
            fn, fargs = calls[which][0]
            row[which].setdefault("ms", []).append(cs.cuda_ms(lambda: fn(*fargs), iters=20))
        row["speedup"] = min(row["parent"]["ms"]) / max(row["this"]["ms"])
        result["main"][name] = row
        # The f32 route at the main shape.
        f32 = (q.float(), cache, lengths, q_starts, tables)
        outs = [_launch(fns, f32, nomask, int4)[:2] for fns in libs.values()]
        result["f32_same_bits"][name] = all(torch.equal(a, b) for a, b in zip(*outs))
    cases = ([(f"paged_prefill{i}", c, False) for i, c in enumerate(cs.PAGED_PREFILL_COVERAGE)]
             + [(f"paged_prefill_int4_{i}", c, True)
                for i, c in enumerate(cs.PREFILL_INT4_COVERAGE)])
    for name, case, int4 in cases:
        *inputs, masks = cs.paged_prefill_coverage_inputs(g, case, int4=int4,
                                                          q_dtype=torch.float32)
        outs = [_launch(fns, inputs, masks, int4)[:2] for fns in libs.values()]
        result["f32_same_bits"][name] = all(torch.equal(a, b) for a, b in zip(*outs))
    ok &= all(result["f32_same_bits"].values())
    result["ok"] = ok
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
