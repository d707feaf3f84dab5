"""Block quantization of K/V (counterpart of quantizedmha_tpu/ops/quantize.py).

K/V are quantized once per sequence in an O(S*D) pass into int8 payloads
plus one symmetric max-abs scale per (batch, head, seq block) — the format
the fused int8 attention kernel reads and the storage format of the INT8
KV cache — or into nibble-packed INT4 payloads (the bulk of the mixed KV
cache). torch.round rounds half to even, as jnp.round does, so payloads
and scales are bit-identical to the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def pack_int4_halves(q: torch.Tensor) -> torch.Tensor:
    """Integer values in [-7, 7], [..., d] -> int8 [..., d//2]: byte j holds
    element j in its low nibble and element j + d//2 in its high nibble."""
    q = q.to(torch.int32)
    half = q.shape[-1] // 2
    return ((q[..., :half] & 0xF) | (q[..., half:] << 4)).to(torch.int8)


def quantize_kv_blocks_int4(
    x: torch.Tensor, block: int, *, scale_clamp: float = 1e-8,
    scale_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(seq block) max-abs INT4 quantization, nibble-packed.

    x: [batch, heads, seq, head_dim] (seq a multiple of `block`, head_dim
    even). Returns (packed int8 [b, h, s, head_dim//2], scales f32
    [b, h, s/scale_block]) in pack_int4_halves's deinterleaved layout.
    scale_block (default `block`, must divide it) is the scale tile."""
    b, h, s, d = x.shape
    scale_block = block if scale_block is None else scale_block
    if s % block:
        raise ValueError(f"seq {s} not a multiple of block {block}")
    if block % scale_block:
        raise ValueError(f"scale_block {scale_block} must divide block {block}")
    if d % 2:
        raise ValueError(f"head_dim {d} must be even for nibble packing")
    xr = x.reshape(b, h, s // scale_block, scale_block, d).float()
    amax = xr.abs().amax(dim=(-2, -1))
    scale = true_div(torch.clamp(amax, min=scale_clamp), 7.0)
    q = torch.clamp(torch.round(xr / scale[..., None, None]), -7, 7)
    return pack_int4_halves(q.reshape(b, h, s, d)), scale


def unpack_int4_halves(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed int8 [..., d//2] -> (lo, hi) int32 halves: elements [0, d/2)
    and [d/2, d), sign-extended by arithmetic shifts."""
    p = packed.to(torch.int32)
    return (p << 28) >> 28, p >> 4


def dequantize_kv_blocks_int4(packed: torch.Tensor, scales: torch.Tensor,
                              block: int) -> torch.Tensor:
    """`block` is the SCALE tile (scales.shape[-1] * block == seq)."""
    b, h, s, d2 = packed.shape
    vals = torch.cat(unpack_int4_halves(packed), dim=-1).float()
    xr = vals.reshape(b, h, s // block, block, 2 * d2)
    return (xr * scales[..., None, None]).reshape(b, h, s, 2 * d2)
