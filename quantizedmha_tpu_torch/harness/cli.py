"""Benchmark CLI (counterpart of quantizedmha_tpu/harness/cli.py) — the
reference's `bin/profile_<kernel>` reborn on the H100.

    python -m quantizedmha_tpu_torch.harness --kernel all --n 8192 --d-model 1024 \\
        --heads 32 --json run.json

Kernel selection and the problem shape are runtime flags, and the run has
the reference driver's two phases (its drivers/main.cu:38-157):

  1. check phase   — run `solve` once per rung and verify it against the
                     float golden, `solve(kernel="reference")` in full f32
                     on the same device, with tol = max(abs, rel*|ref|)
                     (main.cu:73-104). Inputs and goldens are cached in
                     `--cache-dir` (main.cu:15-19/87-94). The inputs cache is
                     shared with the JAX package's CLI; this package's
                     golden keys end in `_torch`, so that it never reads a
                     golden the JAX CLI computed (on a TPU at default matmul
                     precision that is not an f32 golden). Default inputs are
                     random (`--constant` restores the reference's all-ones).
  2. profile phase — warmup + timed runs by CUDA events (harness/timing.py),
                     reporting ms, achieved TFLOP/s and the % of the card's
                     tensor-core and HBM speed of light (profiling/roofline.py),
                     with an optional torch.profiler trace (`--trace DIR`).

A rung that fails its check is not timed; a rung that raises is reported
with its error. Either makes the run exit 1. `--json FILE` writes the JSON
report with the JAX CLI's keys, so `profiling/compare.py` diffs a report
of either package against the other. `--device cpu` runs the plain PyTorch
versions (no roofline: the CPU has no tensor cores).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quantizedmha_tpu_torch.harness",
        description="Verify + benchmark the attention kernel ladder on the GPU.",
    )
    # Reference flags (main.cu:45-59).
    p.add_argument("--kernel", default="fa_int8",
                   help="kernel name or 'all' to sweep the ladder")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--runs", type=int, default=16,
                   help="calls in each timed sample")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed samples (the median is reported)")
    chk = p.add_mutually_exclusive_group()
    chk.add_argument("--check", dest="check", action="store_true", default=True)
    chk.add_argument("--no-check", dest="check", action="store_false")
    inp = p.add_mutually_exclusive_group()
    inp.add_argument("--random", dest="random", action="store_true", default=True,
                     help="random inputs for BOTH phases (default; fixes the "
                          "reference's constant-input verification blindness)")
    inp.add_argument("--constant", dest="random", action="store_false",
                     help="constant-1.0 check inputs (reference main.cu:76 parity)")
    # Problem shape — runtime here, compile-time in the reference (config.h).
    p.add_argument("--n", type=int, default=8192, help="sequence length N")
    p.add_argument("--d-model", type=int, default=1024)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--causal", action="store_true")
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window size (requires --causal)")
    p.add_argument("--softcap", type=float, default=None,
                   help="Gemma-2-style logit soft-cap")
    p.add_argument("--sinks", type=int, default=0,
                   help="StreamingLLM attention sinks (requires --window)")
    p.add_argument("--rope", action="store_true",
                   help="apply RoPE to Q,K in kernel AND golden")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--abs-tol", type=float, default=1e-3)
    p.add_argument("--rel-tol", type=float, default=1e-3)
    p.add_argument("--int8-tol", type=float, default=4e-2,
                   help="abs/rel tolerance used for int8 kernels (quantization "
                        "error budget)")
    p.add_argument("--bf16-tol", type=float, default=8e-3,
                   help="abs/rel tolerance for bf16 kernels (bf16 has ~3 "
                        "decimal digits)")
    p.add_argument("--block-q", type=int, default=None)
    p.add_argument("--block-kv", type=int, default=None)
    p.add_argument("--cache-dir", default=".cache",
                   help="golden/input binary cache (main.cu:15-19 parity)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of each rung into DIR/<kernel>")
    p.add_argument("--json", dest="json_out", default=None, metavar="FILE",
                   help="write machine-readable results (for profiling/compare.py)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where solve runs (cpu: the plain PyTorch versions)")
    return p


@dataclasses.dataclass
class KernelResult:
    kernel: str
    ms: Optional[float] = None
    tflops: Optional[float] = None
    pct_mxu_sol: Optional[float] = None  # share of the tensor cores' speed of light
    pct_hbm_sol: Optional[float] = None
    check: Optional[dict] = None
    error: Optional[str] = None
    skipped: Optional[str] = None  # deliberate skip — not a failure


def _dtype_for(kernel: str) -> str:
    if "int8" in kernel:
        return "int8"
    if "bf16" in kernel:
        return "bf16"
    return "fp32"


def golden_key(args) -> str:
    """The golden cache key: everything the float golden depends on, and
    `_torch`, which no key of the JAX package's CLI ends in."""
    return (f"N{args.n}_d{args.d_model}_h{args.heads}_s{args.seed}"
            f"_{'rand' if args.random else 'const'}"
            f"{'_causal' if args.causal else ''}{'_rope' if args.rope else ''}"
            + (f"_w{args.window}" if args.window else "")
            + (f"_cap{args.softcap}" if args.softcap else "")
            + (f"_sink{args.sinks}" if args.sinks else "")
            + "_torch")


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Import lazily so `--help` stays instant.
    import torch

    from quantizedmha_tpu_torch.api import KERNELS, solve
    from quantizedmha_tpu_torch.device import resolve_device
    from quantizedmha_tpu_torch.harness.data import cached_inputs, cached_reference
    from quantizedmha_tpu_torch.harness.timing import benchmark
    from quantizedmha_tpu_torch.harness.verify import compare
    from quantizedmha_tpu_torch.profiling.roofline import (
        attention_bytes,
        attention_flops,
        detect_chip,
        roofline,
    )

    if args.window is not None and not args.causal:
        print("error: --window requires --causal", file=sys.stderr)
        return 2
    if args.sinks and args.window is None:
        print("error: --sinks require --window", file=sys.stderr)
        return 2
    kernels = list(KERNELS) if args.kernel == "all" else [args.kernel]
    for k in kernels:
        if k not in KERNELS:
            print(f"error: unknown kernel {k!r}; choose from {KERNELS}", file=sys.stderr)
            return 2

    dev = resolve_device(args.device)
    # The golden and the fp32 rungs compute in full float32: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    chip = detect_chip(dev) if dev.type == "cuda" else None
    device_name = chip.name if chip else "cpu"
    n, d_model, h = args.n, args.d_model, args.heads
    print(f"device: {device_name} | workload: N={n} d_model={d_model} h={h} "
          f"(d={d_model // h}) causal={args.causal} rope={args.rope}"
          + (f" window={args.window}" if args.window else "")
          + (f" softcap={args.softcap}" if args.softcap else "")
          + (f" sinks={args.sinks}" if args.sinks else ""))
    masked_kw = dict(window=args.window, logit_softcap=args.softcap,
                     attention_sinks=args.sinks)

    cache = pathlib.Path(args.cache_dir)
    data = cached_inputs(cache, n, d_model, seed=args.seed, random=args.random)
    q, k_, v = (torch.from_numpy(x).to(dev) for x in (data.q, data.k, data.v))

    def solver(kern):
        return lambda q, k, v: solve(
            q, k, v, d_model, h, kernel=kern, causal=args.causal,
            use_rope=args.rope, block_q=args.block_q, block_kv=args.block_kv,
            device=dev, **masked_kw)

    golden = None
    if args.check:
        golden = cached_reference(
            cache, golden_key(args), (n, d_model),
            lambda: solver("reference")(q, k_, v).cpu().numpy())

    results = []
    for kernel in kernels:
        res = KernelResult(kernel=kernel)
        results.append(res)
        if kernel == "unfused" and (args.window or args.softcap):
            res.skipped = "unfused kernel has no window/softcap support"
            print(f"[{kernel:>10}] skipped: {res.skipped}")
            continue
        fn = solver(kernel)
        try:
            out = fn(q, k_, v)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — reported per rung, exits 1
            res.error = f"{type(e).__name__}: {e}"
            print(f"[{kernel:>10}] FAILED to run: {res.error}")
            continue

        if args.check:
            tol = None
            if "int8" in kernel:
                tol = args.int8_tol
            elif "bf16" in kernel:
                tol = args.bf16_tol
            report = compare(out, golden, abs_tol=tol or args.abs_tol,
                             rel_tol=tol or args.rel_tol)
            res.check = dataclasses.asdict(report)
            print(f"[{kernel:>10}] check {report}")
            if not report.ok:
                continue  # don't publish timings for wrong kernels
        del out

        timing = benchmark(fn, q, k_, v, warmup=args.warmup, runs=args.runs,
                           repeats=args.repeats)
        if args.trace:
            from quantizedmha_tpu_torch.profiling.trace import capture
            tdir = pathlib.Path(args.trace) / kernel
            capture(fn, q, k_, v, trace_dir=tdir, iters=max(args.warmup, 1))
            print(f"[{kernel:>10}] torch.profiler trace -> {tdir}")
        res.ms = timing.median_ms
        if chip is None:
            print(f"[{kernel:>10}] {timing.median_ms:8.3f} ms on the CPU (no roofline)")
            continue

        flops = attention_flops(1, h, n, n, d_model // h, causal=args.causal,
                                window=args.window, sinks=args.sinks)
        # Mixed precision: fa_int8 reads fp32 Q and writes fp32 O around
        # its int8 K/V; charging 1 B everywhere understates traffic ~2.5x.
        dt = _dtype_for(kernel)
        if dt == "int8":
            byts = attention_bytes(1, h, n, n, d_model // h,
                                   q_bytes=4, kv_bytes=1, o_bytes=4)
        else:
            byts = attention_bytes(1, h, n, n, d_model // h,
                                   bytes_per_el={"bf16": 2}.get(dt, 4))
        rl = roofline(timing.median_s, flops, byts, dtype=dt, chip=chip)
        res.tflops = rl.tflops_achieved
        res.pct_mxu_sol = rl.pct_of_compute_sol
        res.pct_hbm_sol = rl.pct_of_memory_sol
        print(f"[{kernel:>10}] {timing.median_ms:8.3f} ms | {rl}")

    if args.json_out:
        payload = {
            "device": device_name,
            "workload": {"n": n, "d_model": d_model, "heads": h,
                         "causal": args.causal, "rope": args.rope,
                         "window": args.window, "softcap": args.softcap,
                         "sinks": args.sinks,
                         "random": args.random, "seed": args.seed},
            "results": [dataclasses.asdict(r) for r in results],
        }
        pathlib.Path(args.json_out).write_text(json.dumps(payload, indent=2))
        print(f"wrote {args.json_out}")

    failed = [r for r in results
              if r.error or (r.check and not (r.check["n_mismatch"] == 0
                                              and r.check["n_nonfinite"] == 0))]
    return 1 if failed else 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
