"""Device selection for the port's entry points.

Every entry point that creates or moves tensors takes `device`, defaulting
to "cuda". Without a card the request raises: nothing quietly falls back to
the CPU. The CPU is used only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU unless "
            "the caller passes device='cpu' (the plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
