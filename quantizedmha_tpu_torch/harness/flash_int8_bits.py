"""The INT8 flash forward's int8-P route (csrc/flash_int8_fwd.cu
MODE_INT8_P) at a few chosen launches, through one or more builds of its
library: whether each build gives the same bits as this tree's, launch
after launch, and its error against the plain version. Small enough to run
under compute-sanitizer.

    python -m quantizedmha_tpu_torch.harness.flash_int8_bits \\
        --variants quantizedmha_tpu_torch/harness/flash_int8_int8p_occupancy.json \\
        --cases fa8_2 fa8_7 serve --repeat 3
    compute-sanitizer --tool racecheck python -m quantizedmha_tpu_torch.harness.flash_int8_bits \\
        --cases fa8_2 fa8_7 serve [--lib path/to/libflash_int8_fwd.so]

Cases: `fa8_<i>`, FLASH_COVERAGE case i of chip_smoke.py (inputs drawn
from a generator seeded with i); `serve` (1 x 32 x 256 x 128, 8 kv heads,
bf16 q, block_kv 256, causal) and `serve_w4` (the same at 512 tokens,
block_kv 512). Variants: a JSON object {name: [[line as committed, line
planted], ...]} of this tree's source (harness/paged_prefill_ab.py's
form), built beside this tree's library. With --lib, that library alone is
bound (nothing is built). Prints one JSON object; exits 1 when a build's
bits differ from this tree's, or from its own first launch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
SERVE = {"serve": 256, "serve_w4": 512}


def _inputs(name):
    """(operands, kw) of one case, drawn on the card."""
    import chip_smoke as cs
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
    if name in SERVE:
        S = SERVE[name]
        g = torch.Generator(device="cuda").manual_seed(S)
        q = torch.randn((1, 32, S, 128), generator=g, device="cuda").to(torch.bfloat16)
        k, v = torch.randn((2, 1, 8, S, 128), generator=g, device="cuda").to(torch.bfloat16)
        k_i8, ks = quantize_kv_blocks(k, S)
        v_i8, vs = quantize_kv_blocks(v, S)
        kw = dict(sm_scale=128**-0.5, causal=True, kv_len=S, block_kv=S, scale_clamp=1e-8,
                  p_scale=127.0, window=None, softcap=None, sinks=0, mode=0,
                  save_residuals=True)
        return (q, k_i8, ks, v_i8, vs, fa8._offsets(0, 0, 1, q.device)), kw
    i = int(name.removeprefix("fa8_"))
    g = torch.Generator(device="cuda").manual_seed(i)
    *operands, kw = cs.flash_coverage_inputs(g, cs.FLASH_COVERAGE[i])
    if kw["mode"] != 0:
        raise ValueError(f"{name} is not a MODE_INT8_P case")
    return tuple(operands), kw


def _bind(lib_path):
    """A ctypes function of a library's flash_int8_fwd entry."""
    import ctypes
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8
    fn = getattr(ctypes.CDLL(str(lib_path)), "flash_int8_fwd")
    fn.argtypes, fn.restype = fa8.FLASH_INT8_P.argtypes, ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=["fa8_2", "fa8_7", "serve"])
    ap.add_argument("--variants", type=Path)
    ap.add_argument("--lib", type=Path, help="bind this library alone (no build)")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_int8_bits: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from quantizedmha_tpu_torch.harness import paged_prefill_ab as ab
    from quantizedmha_tpu_torch.ops import cuda_lib
    from quantizedmha_tpu_torch.ops import flash_attention_int8 as fa8

    if args.lib is not None:
        libs = {"lib": args.lib}
    else:
        variants = json.loads(args.variants.read_text()) if args.variants else {}
        builds = {name: ab._build_variant(name, edits, "flash_int8_fwd")
                  for name, edits in variants.items()}
        cuda_lib.build_all(["flash_int8_fwd"])
        libs = {"this": cuda_lib.library_path("flash_int8_fwd")}
        libs.update({name: ab._built(b) for name, b in builds.items()})
    fns = {name: _bind(lib) for name, lib in libs.items()}
    result = {"gpu": cs.gpu_line(), "libs": {k: str(v) for k, v in libs.items()}, "cases": {}}
    ok = True
    for name in args.cases:
        operands, kw = _inputs(name)
        p_out, p_lse = fa8._flash_int8_plain(*operands, **kw)
        _, _, l = fa8._flash_int8_plain_state(
            *operands, **{k: x for k, x in kw.items() if k != "save_residuals"})
        tol, lse_tol = cs.flash_tolerances(p_out, p_lse, l, operands[3], operands[4],
                                           kw["block_kv"], 0)
        row, first = {}, None
        for which, fn in fns.items():
            _, args_, (o, lse), _keep = fa8._flash_int8_launch(*operands, **kw)
            launches = []
            for _ in range(args.repeat):
                err = fn(*args_)
                if err:
                    raise RuntimeError(f"{which}: CUDA error {err}")
                torch.cuda.synchronize()
                launches.append((o.clone(), lse.clone()))
            first = first or launches[0]
            row[which] = {
                "err_over_tol": [cs.err_over_tol(o, p_out, tol), cs.err_over_tol(lse, p_lse, lse_tol)],
                "same_bits_every_launch": all(torch.equal(a, launches[0][0])
                                              and torch.equal(b, launches[0][1])
                                              for a, b in launches),
                "same_bits_as_first": torch.equal(launches[0][0], first[0])
                and torch.equal(launches[0][1], first[1]),
                "elements_differing_from_first": int((launches[0][0] != first[0]).sum()),
            }
            ok &= row[which]["same_bits_every_launch"] and row[which]["same_bits_as_first"]
        result["cases"][name] = row
    result["ok"] = bool(ok)
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
