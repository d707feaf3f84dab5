"""The SASS instructions a score of row 1's d=256 int8-P kernel on its
softcap route, and the bound they set on the CUDA cores.

    python -m quantizedmha_tpu_torch.harness.sass_count [--out sass.json]

Builds csrc/flash_int8_fwd.cu to two cubins with cuda_lib's flags (sm_90a,
-O3): as committed, and with the unmasked softcap instance of the d=256
consumers' per-score work (`exp_half` with UNMASKED and CAP: P' of a
score, the mask-free select, its share of l, the pack of P to int8)
emptied. Counts each `flash_int8_int8p_kernel<256, ...>` instance's SASS
instructions (cuobjdump -sass); the difference over the 16 scores a
consumer thread holds an item is the route's instructions a score. The
bound on the CUDA cores of Gemma-2's full layer (16 q heads, 2048 tokens,
causal) and sliding layer (8192 tokens under the 4096 window) is then
pairs x instructions a score / (SMs x 4 sub-partitions x 32 lanes x the
card's max SM clock, nvidia-smi's clocks.max.sm): one instruction a lane
a cycle, the exp sweep's per-score work alone (the max sweep, S and P·V
not counted). Prints one JSON object; needs nvcc, cuobjdump and the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

# The d=256 consumers' per-score work, and the line that empties its
# unmasked softcap instance.
ANCHOR = ("        constexpr bool CAP = decltype(cap_tag)::value;\n#pragma unroll\n"
          "        for (int hh = 0; hh < 2; ++hh)")
EMPTIED = ("        constexpr bool CAP = decltype(cap_tag)::value;\n"
           "        if constexpr (UNMASKED && CAP) return;\n#pragma unroll\n"
           "        for (int hh = 0; hh < 2; ++hh)")
SCORES = 16  # scores of a consumer thread in an item (its 32 keys x 2 rows / 4 lanes)
# (the symbol from the kernel's name on: the anonymous namespace's part
# differs from build to build)
KERNEL = re.compile(r"Function : \S*(flash_int8_int8p_kernelILi256E\S*)")
INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S")


def _tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise RuntimeError(f"{name} not found: run on the machine with the GPU")
    return path


def sass_counts(cubin: Path) -> dict:
    """{kernel symbol: SASS instructions} of a cubin's d=256 int8-P instances."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    return count_instructions(text)


def count_instructions(text: str) -> dict:
    """{kernel symbol: instructions} of the d=256 int8-P instances in
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


def _cubin(src: Path, out: Path):
    """nvcc started on one source: the process."""
    from quantizedmha_tpu_torch.ops import cuda_lib
    arch = [f for f in cuda_lib.NVCC_FLAGS if f.startswith("arch=")]
    return subprocess.Popen([_tool("nvcc"), "-gencode", arch[0], "-std=c++17", "-O3", "-cubin",
                             "-o", str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return float(out.split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    from quantizedmha_tpu_torch.ops import cuda_lib
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copytree(cuda_lib.CSRC, tmp / "this")
        shutil.copytree(cuda_lib.CSRC, tmp / "emptied")
        src = tmp / "emptied" / "flash_int8_fwd.cu"
        text = src.read_text()
        if text.count(ANCHOR) != 1:
            raise ValueError("the d=256 per-score lines are not one block of flash_int8_fwd.cu")
        src.write_text(text.replace(ANCHOR, EMPTIED))
        builds = {w: _cubin(tmp / w / "flash_int8_fwd.cu", tmp / f"{w}.cubin")
                  for w in ("this", "emptied")}
        counts = {}
        for which, proc in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed:\n{log}")
            counts[which] = sass_counts(tmp / f"{which}.cubin")
    per_score = {k: (counts["this"][k] - counts["emptied"][k]) / SCORES for k in counts["this"]}
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("sass_count: no CUDA device is available")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = _clock_mhz()
    rate = sm * 4 * 32 * mhz * 1e6  # lane-instructions a second
    pairs = {"full": 16 * 2048 * 2049 // 2,
             "sliding": 16 * sum(min(i + 1, 4096) for i in range(8192))}
    worst = max(per_score.values())
    result = {"sass_instructions": counts, "instructions_a_score": per_score, "sms": sm,
              "max_sm_clock_mhz": mhz,
              "cuda_core_bound_ms": {k: n * worst / rate * 1e3 for k, n in pairs.items()}}
    text = json.dumps(result)
    if args.out is not None:
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
