"""Block quantization of K/V (counterpart of quantizedmha_tpu/ops/quantize.py).

K/V are quantized once per sequence in an O(S*D) pass into int8 payloads
plus one symmetric max-abs scale per (batch, head, seq block) — the format
the fused int8 attention kernel reads and the storage format of the INT8
KV cache. torch.round rounds half to even, as jnp.round does, so payloads
and scales are bit-identical to the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=None)
def _divisor(c: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.full((), c, dtype=dtype, device=device)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as IEEE division on every device. On CUDA, PyTorch
    divides by a Python scalar through its reciprocal, which misrounds a
    few percent of quotients (amax / 127 among them); a 0-dim tensor
    divisor takes the exact division, as the CPU, XLA and the kernels do."""
    return x / _divisor(float(c), x.dtype, x.device)


def quantize_kv_blocks(
    x: torch.Tensor, block: int, *, scale_clamp: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(seq block) max-abs int8 quantization.

    x: [batch, heads, seq, head_dim] (seq a multiple of `block`).
    Returns (values int8 same shape, scales f32 [batch, heads, seq/block]).
    """
    b, h, s, d = x.shape
    if s % block:
        raise ValueError(f"seq {s} not a multiple of block {block}")
    xr = x.reshape(b, h, s // block, block, d).float()
    amax = xr.abs().amax(dim=(-2, -1))
    scale = true_div(torch.clamp(amax, min=scale_clamp), 127.0)
    q = torch.clamp(torch.round(xr / scale[..., None, None]), -127, 127)
    return q.to(torch.int8).reshape(b, h, s, d), scale


def dequantize_kv_blocks(values: torch.Tensor, scales: torch.Tensor,
                         block: int) -> torch.Tensor:
    b, h, s, d = values.shape
    xr = values.reshape(b, h, s // block, block, d).float()
    return (xr * scales[..., None, None]).reshape(b, h, s, d)
