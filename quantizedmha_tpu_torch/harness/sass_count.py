"""The SASS instructions a score of the INT8 flash forward's d=256 instances
(rows 1-2) on their softcap route, and the bound they set on the CUDA
cores.

    python -m quantizedmha_tpu_torch.harness.sass_count [--csrc DIR] [--out sass.json]

Builds csrc/flash_int8_fwd.cu (this tree's, or the one in --csrc, such as a
parent tree's) twice with cuda_lib's flags: as it is, and with the
unmasked softcap instance of each d=256 walk's per-score work emptied (the
int8-P consumers' and the bf16-P consumers' `exp_half`, or the bf16-P
kernel's one-consumer `exp_tile` of a tree from before its two consumers,
with UNMASKED and CAP: P' of a score, the mask-free select, the share of l
that the CUDA cores sum, the pack of P). Counts each d=256 instance's SASS
instructions (cuobjdump -sass); the difference over the scores a consumer
thread holds an item is the route's instructions a score. The bound on
the CUDA cores of Gemma-2's full layer (16 q heads, 2048 tokens, causal)
and sliding layer (8192 tokens under the 4096 window), for each numerics
mode, is then pairs x the mode's most instructions a score / (SMs x 4
sub-partitions x 32 lanes x the card's max SM clock, nvidia-smi's
clocks.max.sm): one instruction a lane a cycle, the exp sweep's per-score
work alone (the max sweep, S and P·V not counted). chip_smoke.py builds
the emptied copy behind its phases (`start_emptied`) and counts the built
library against it (`per_score`). Prints one JSON object; needs nvcc,
cuobjdump and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

# Each mode family's d=256 per-score work: (the lines that begin it, the
# scores of a consumer thread in an item), the first found in the source
# taken. Emptying inserts a return for its unmasked softcap instance.
_CAP_LINE = "constexpr bool CAP = decltype(cap_tag)::value;\n#pragma unroll\n"
ANCHORS = {
    # Row 1's two consumers (and row 2's since they took the same split):
    # 32 keys x 2 rows / 4 lanes.
    "int8_p": [("        " + _CAP_LINE + "        for (int hh = 0; hh < 2; ++hh)", 16)],
    "bf16_p": [("        " + _CAP_LINE + "        for (int kk = 0; kk < 2; ++kk)", 16),
               # Row 2's one consumer of 64 rows before (every key of a tile).
               ("      " + _CAP_LINE + "      for (int kk = 0; kk < 4; ++kk)", 32)],
}
RETURN = "if constexpr (UNMASKED && CAP) return;\n"
# (the symbol from the kernel's name on: the anonymous namespace's part
# differs from build to build)
KERNEL = re.compile(r"Function : \S*(flash_int8_(?:int8p|bf16p)_kernelILi256E\S*)")
INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S")
PAIRS = {"full": 16 * 2048 * 2049 // 2,
         "sliding": 16 * sum(min(i + 1, 4096) for i in range(8192))}


def _tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise RuntimeError(f"{name} not found: run on the machine with the GPU")
    return path


def sass_counts(binary: Path) -> dict:
    """{kernel symbol: SASS instructions} of a cubin's or a library's d=256
    INT8 flash instances."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(binary)], check=True,
                          capture_output=True, text=True).stdout
    return count_instructions(text)


def count_instructions(text: str) -> dict:
    """{kernel symbol: instructions} of the d=256 INT8 flash instances in
    cuobjdump -sass's text (one line an instruction, at its address)."""
    counts, name = {}, None
    for line in text.splitlines():
        m = KERNEL.search(line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif "Function :" in line:
            name = None
        elif name and INSTR.match(line):
            counts[name] += 1
    return counts


def family(symbol: str) -> str:
    """The numerics mode of a d=256 instance's symbol: int8_p, bf16_p or
    bf16_p_f32l (flash_int8_bf16p_kernel<256, QBF16, F32L>)."""
    if symbol.startswith("flash_int8_int8p"):
        return "int8_p"
    return "bf16_p_f32l" if re.match(r"flash_int8_bf16p_kernelILi256ELb[01]ELb1E", symbol) \
        else "bf16_p"


def emptied(text: str) -> tuple:
    """(the source with each family's per-score work emptied, {family:
    scores a thread an item})."""
    scores = {}
    for fam, anchors in ANCHORS.items():
        for anchor, n in anchors:
            if text.count(anchor) == 1:
                cap, rest = anchor.split("#pragma unroll\n", 1)
                indent = cap[:len(cap) - len(cap.lstrip())]
                text = text.replace(anchor, cap + indent + RETURN + "#pragma unroll\n" + rest)
                scores[fam] = n
                break
        else:
            raise ValueError(f"no d=256 {fam} per-score lines in flash_int8_fwd.cu")
    return text, scores


def _build(src: Path, out: Path, nice=False):
    """nvcc started on one source with cuda_lib's flags (a library), in a
    session of its own (stop ends its compiler's children too)."""
    from quantizedmha_tpu_torch.ops import cuda_lib
    return subprocess.Popen(["nice", "-n", "10"] * nice + [_tool("nvcc"), *cuda_lib.NVCC_FLAGS,
                                                           "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def stop(build):
    """Ends a start_emptied build still running (a failed run)."""
    proc = build[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()


def start_emptied(csrc: Path, workdir: Path, nice=False):
    """The emptied copy of csrc/ in workdir, its library's build started:
    (process, library, {family: scores})."""
    shutil.rmtree(workdir, ignore_errors=True)
    shutil.copytree(csrc, workdir)
    src = workdir / "flash_int8_fwd.cu"
    text, scores = emptied(src.read_text())
    src.write_text(text)
    lib = workdir / "libflash_int8_fwd_emptied.so"
    return _build(src, lib, nice), lib, scores


def _wait(proc):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")


def per_score(this_lib: Path, build) -> dict:
    """{kernel symbol: instructions a score} of a built library against its
    emptied copy (start_emptied's, waited for here)."""
    proc, lib, scores = build
    _wait(proc)
    this, empty = sass_counts(this_lib), sass_counts(lib)
    return {k: (this[k] - empty[k]) / scores["int8_p" if family(k) == "int8_p" else "bf16_p"]
            for k in this}


def clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return float(out.split()[0])


def cuda_core_ms(pairs: int, instructions: float, sms: int, mhz: float) -> float:
    """pairs x instructions a score on every lane of every sub-partition at
    one instruction a cycle, in ms."""
    return pairs * instructions / (sms * 4 * 32 * mhz * 1e6) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="the csrc/ to count (default: this tree's)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    from quantizedmha_tpu_torch.ops import cuda_lib
    csrc = (args.csrc or cuda_lib.CSRC).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copytree(csrc, tmp / "this")
        this = _build(tmp / "this" / "flash_int8_fwd.cu", tmp / "this.so")
        build = start_emptied(csrc, tmp / "emptied")
        _wait(this)
        per = per_score(tmp / "this.so", build)
        counts = sass_counts(tmp / "this.so")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("sass_count: no CUDA device is available")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = clock_mhz()
    bound = {}
    for fam in ("int8_p", "bf16_p", "bf16_p_f32l"):
        worst = max(n for k, n in per.items() if family(k) == fam)
        bound[fam] = {kind: cuda_core_ms(n, worst, sm, mhz) for kind, n in PAIRS.items()}
    result = {"csrc": str(csrc), "sass_instructions": counts, "instructions_a_score": per,
              "sms": sm, "max_sm_clock_mhz": mhz, "cuda_core_bound_ms": bound}
    text = json.dumps(result)
    if args.out is not None:
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
