"""Fused dequant-matmul for packed-INT4 weights, the w4a16 decode matmul
(counterpart of quantizedmha_tpu/ops/w4_matmul.py:w4_matmul).

x [R, in] @ dequant(packed [in/2, out] int8 nibbles, scale [in/group, out]
f32) -> [R, out] in x's dtype. Nibble layouts (quant/weights.QuantizedWeight4):
"pairs", byte i = weight rows 2i (low nibble, stored +8) | 2i+1 (high
nibble, two's complement); "halves", byte i = rows i | k2+i.

One numerics, kernel and plain version alike: w = round-to-x-dtype(q * s)
with q the signed nibble and s its f32 group scale (the product in f32,
rounded to nearest even into bf16, kept for f32 x); an f32 accumulation of
x * w over the whole contraction; one final cast to x's dtype. It is the
exact-lo fold of the JAX kernel's folded branch. The JAX kernel's other
branches (raw nibbles dotted and the partial sums scaled; the xsum-dot that
rounds (lo+8)*s) agree with it within one bf16 rounding of w.

This module owns the nibble layout: quant/weights.py and the benchmark's
weight draw pack, unpack and split planes through its public helpers.

On a CUDA tensor the call launches `csrc/w4_matmul.cu` (one kernel for the
per-layer `_w4_kernel` and the layer-stacked `_w4_kernel_stacked`: a stacked
weight is passed as the view `packed[layer]`, no copy); on a CPU tensor it
runs `_w4_matmul_plain`. The JAX package's TPU tile rules (`pick_w4_blocks`,
`block_k2`, `block_n`) have no counterpart: the kernel picks its own split.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from quantizedmha_tpu_torch.ops import cuda_lib

W4_MATMUL = cuda_lib.CudaKernel(
    "w4_matmul", "w4_matmul", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

PACKINGS = ("pairs", "halves")
# The kernel's tiles: 256 output columns and up to 8 rows of x per block;
# the contraction is split into chunks of a multiple of 16 packed rows
# until about two blocks per SM of the H100 (132 SMs) are in the grid.
_TILE_N = 256
_ROW_TILE = 8
_CHUNK_ALIGN = 16
_TARGET_BLOCKS = 2 * 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Signed int8 planes in [-7, 7] -> one int8 byte each: lo stored +8 in
    the low nibble, hi two's complement in the high one."""
    return ((lo + 8) & 0x0F) | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., k2, out] int8 -> (lo, hi) int8 in [-8, 7]: the low nibble
    stored +8, the high nibble two's complement (an arithmetic shift)."""
    return (packed & 15) - 8, packed >> 4


@functools.lru_cache(maxsize=None)
def check_w4_layout(in_dim: int, group: int, packing: str) -> None:
    """The layouts quantize_weight4 and the kernel take (cached: a model
    has a few layouts and the decode loop asks on every call)."""
    if packing not in PACKINGS:
        raise ValueError(f"unknown packing {packing!r}")
    if group <= 0 or group % 2 or in_dim % group:
        raise ValueError(f"need even group | in_dim, got group={group} in_dim={in_dim}")
    if packing == "halves" and in_dim % (2 * group):
        # Packed row i holds input rows i and k2+i: each half must be whole
        # scale groups, or the hi plane's rows straddle two of them.
        raise ValueError(f"halves packing needs 2*group | in_dim, got group={group} "
                         f"in_dim={in_dim}")


def nibble_planes(x, packed, scale, group, packing):
    """Per nibble plane: (x's matching columns, the signed plane, its scale
    rows, packed rows per scale group)."""
    k2 = packed.shape[0]
    gn = scale.shape[0]
    lo, hi = unpack_nibbles(packed)
    if packing == "halves":
        return ((x[:, :k2], lo, scale[:gn // 2], group),
                (x[:, k2:], hi, scale[gn // 2:], group))
    return ((x[:, 0::2], lo, scale, group // 2),
            (x[:, 1::2], hi, scale, group // 2))


def _w4_matmul_plain(x, packed, scale, *, group, packing):
    """The kernel's numerics in PyTorch: w = (q * s) rounded to x's dtype,
    an f32 product of each plane with its columns of x, one final cast."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products on the card
    k2, n = packed.shape
    out = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for xp, q, s, rpg in nibble_planes(x, packed, scale, group, packing):
        w = (q.float().reshape(-1, rpg, n) * s[:, None, :]).to(x.dtype)
        out += xp.float() @ w.float().reshape(k2, n)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def split_k(rows: int, k2: int, n: int) -> Tuple[int, int]:
    """(chunk, splits): the kernel's contraction chunk in packed rows and
    the number of chunks, enough blocks to fill the card; worked out once
    per (rows, weight shape)."""
    tiles = _cdiv(n, _TILE_N) * _cdiv(rows, _ROW_TILE)
    splits = min(_cdiv(k2, _CHUNK_ALIGN), max(1, _cdiv(_TARGET_BLOCKS, tiles)))
    chunk = _cdiv(_cdiv(k2, splits), _CHUNK_ALIGN) * _CHUNK_ALIGN
    return chunk, _cdiv(k2, chunk)


def _w4_matmul_launch(x, packed, scale, *, group, packing):
    """Checked operands of one kernel launch: (kernel, ctypes args, output,
    operands kept alive)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"packed must be int8 and scale float32, got {packed.dtype}, "
                         f"{scale.dtype}")
    dev = x.get_device()
    if packed.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, packed and scale must be on one device")
    # The weight is never copied: a non-contiguous view is the caller's bug.
    if not (packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("packed and scale must be contiguous")
    rows = x.shape[0]
    k2, n = packed.shape
    x = x.contiguous()
    chunk, splits = split_k(rows, k2, n)
    device = x.device
    out = torch.empty((rows, n), dtype=x.dtype, device=device)
    ws = (torch.empty((splits, rows, n), dtype=torch.float32, device=device)
          if splits > 1 else None)
    ptr = cuda_lib.ptr
    args = (ptr(x), ptr(packed), ptr(scale), ptr(out), ptr(ws),
            rows, k2, n, group, int(packing == "halves"), int(x.dtype == torch.bfloat16),
            chunk, splits, cuda_lib.stream_of(x))
    return W4_MATMUL, args, out, (x, packed, scale, ws)


def _w4_matmul_cuda(x, packed, scale, *, group, packing):
    kernel, args, out, _ = _w4_matmul_launch(x, packed, scale, group=group, packing=packing)
    kernel(*args)
    return out


def w4_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    group: int,
    layer: Optional[int] = None,
    packing: str = "pairs",
) -> torch.Tensor:
    """x [R, in] @ dequant(packed [in/2, out], scale [in/group, out]).

    Layer-stacked form: packed [L, in/2, out] and scale [L, in/group, out]
    with `layer` choosing one; the kernel reads that layer's view in place.
    Returns [R, out] in x's dtype."""
    stacked = packed.ndim == 3
    if stacked and layer is None:
        raise ValueError("layer-stacked packed weights need `layer`")
    if not stacked and layer is not None:
        raise ValueError("`layer` is only meaningful for stacked weights")
    if stacked:
        packed, scale = packed[layer], scale[layer]
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"need x [R, in] and packed [in/2, out], got {tuple(x.shape)}, "
                         f"{tuple(packed.shape)}")
    rows, in_dim = x.shape
    k2, n = packed.shape
    if in_dim != 2 * k2:
        raise ValueError(f"x in_dim {in_dim} != 2 * packed rows {k2}")
    check_w4_layout(in_dim, group, packing)
    if tuple(scale.shape) != (in_dim // group, n):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {(in_dim // group, n)}")
    fn = _w4_matmul_cuda if x.is_cuda else _w4_matmul_plain
    return fn(x, packed, scale, group=group, packing=packing)
