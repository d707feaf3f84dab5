"""Device info dump (counterpart of quantizedmha_tpu/profiling/device_info.py,
tools/device_info.cu reborn).

The reference dumped the GPU limits that bound kernel design (SM count,
shared memory per block, L2 size) to profiles/txt/device_info.txt
(tools/device_info.cu:6-36). This is that dump for the card the port runs
on, with the roofline peaks of profiling.roofline and the power limit that
`nvidia-smi` reports (a card set below its full limit runs slower under
load, so every measurement is kept beside it).

    python -m quantizedmha_tpu_torch.profiling.device_info
"""

from __future__ import annotations

import json
import os
import pathlib
import platform
import subprocess
from typing import Optional

import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.profiling.roofline import detect_chip


def power_limit(index: int = 0) -> Optional[str]:
    """`name, power.limit` of one card as nvidia-smi prints them, or None
    where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30)
    except (FileNotFoundError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def device_info(device="cuda") -> dict:
    """Hardware facts of a CUDA device (default the current one), or of
    the host when device="cpu" (no peaks: the port's kernels do not run
    there)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"platform": "cpu", "device_kind": platform.processor() or platform.machine(),
                "num_devices": 1, "cpu_count": os.cpu_count(),
                "peak_bf16_tflops": None, "peak_int8_tops": None, "peak_hbm_gbps": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    free, total = torch.cuda.mem_get_info(index)
    chip = detect_chip(torch.device("cuda", index))
    return {
        "platform": "gpu",
        "device_kind": props.name,
        "id": index,
        "num_devices": torch.cuda.device_count(),
        "compute_capability": f"{props.major}.{props.minor}",
        "sm_count": props.multi_processor_count,
        "smem_bytes_per_block_optin": getattr(props, "shared_memory_per_block_optin", None),
        "smem_bytes_per_sm": getattr(props, "shared_memory_per_multiprocessor", None),
        "l2_bytes": getattr(props, "L2_cache_size", None),
        "hbm_bytes_total": total,
        "hbm_bytes_in_use": total - free,  # every process on the card
        "torch_bytes_allocated": torch.cuda.memory_allocated(index),
        "peak_bf16_tflops": chip.bf16_tflops,
        "peak_int8_tops": chip.int8_tops,
        "peak_fp32_tflops": chip.peak_for("fp32"),
        "peak_cuda_core_fp32_tflops": chip.cuda_core_tflops,
        "peak_hbm_gbps": chip.hbm_gbps,
        "exp_per_s": chip.exp_per_s,
        "nvidia_smi_name_power_limit": power_limit(index),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def format_info(info: dict) -> str:
    lines = [f"=== {info['platform'].upper()} device info (tools/device_info.cu analog) ==="]
    for key, val in info.items():
        if isinstance(val, int) and "bytes" in key:
            lines.append(f"{key:>28}: {val} ({val / 2**30:.2f} GiB)")
        else:
            lines.append(f"{key:>28}: {val}")
    return "\n".join(lines) + "\n"


def dump(path="profiles/txt/device_info_torch.txt", device="cuda") -> pathlib.Path:
    """Write the dump as text and, beside it, as JSON."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    info = device_info(device)
    path.write_text(format_info(info))
    path.with_suffix(".json").write_text(json.dumps(info, indent=2, default=str))
    return path


if __name__ == "__main__":
    print(format_info(device_info()), end="")
    dump()
