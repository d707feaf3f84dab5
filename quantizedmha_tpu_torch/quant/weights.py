"""Weight quantization for the model/serving path (counterpart of
quantizedmha_tpu/quant/weights.py).

  - w8a16: symmetric per-output-channel INT8 weights + f32 channel scales;
    the matmul runs in the activation dtype and the channel scales commute
    to the output, x @ (W·s) == (x @ W)·s. The JAX package leaves this to
    XLA; here it is plain PyTorch, which makes a transient copy of the
    weight in the activation dtype per call.
  - w4a16: group-wise symmetric INT4 weights, nibble-packed two per int8
    byte (QuantizedWeight4), with one f32 scale per (group of input rows,
    output channel). Up to _W4_DECODE_ROWS rows go through the fused
    dequant-matmul kernel (ops/w4_matmul.py); larger products (prefill)
    take the JAX package's dequantize-then-matmul lowering.

  - w8a8: the same INT8 weights; each activation row is quantized to int8
    by its own max-abs scale, the int8 x int8 product sums in int32 and
    the result is scaled by row scale x channel scale. The JAX package
    leaves that product to XLA's dot_general; here a CUDA tensor takes
    torch._int_mm (rows padded with zeros to the least count it takes),
    a CPU tensor the exact plain product `_w8a8_plain`.

Norms, embeddings and (unless lm_head_bits=8) the lm_head stay float. Not
ported: the JAX package's TPU A/B controls W4_USE_PALLAS and LayerIndexed4
(a per-layer view does here what LayerIndexed4 does under lax.scan).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from quantizedmha_tpu_torch.ops.quantize import true_div
from quantizedmha_tpu_torch.ops.w4_matmul import (
    check_w4_layout,
    nibble_planes,
    pack_nibbles,
    unpack_nibbles,
    w4_matmul,
)


@dataclasses.dataclass
class QuantizedWeight:
    """Symmetric per-output-channel int8 weight: w ≈ values * scale[None, :].

    values: [..., in_dim, out_dim] int8; scale: [..., out_dim] f32. Leading
    dims stack layers; `layer(i)` is a view of one. quantize_weight stores
    values out-major (each output channel's inputs contiguous, the
    transpose of a contiguous [..., out, in]): the layout that
    torch._int_mm's int8 tensor-core GEMM takes. On a row-major weight it
    took 6.9x as long at 2048 x 4096 x 14336 on an H100 (torch 2.11, CUDA
    12.8); the w8a16 matmul takes either.
    """

    values: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    @property
    def out_features(self) -> int:
        return self.values.shape[-1]

    def layer(self, i: int) -> "QuantizedWeight":
        return QuantizedWeight(self.values[i], self.scale[i])


@dataclasses.dataclass
class QuantizedWeight4:
    """Symmetric group-wise INT4 weight, nibble-packed two per byte.

    packed: [..., in_dim // 2, out_dim] int8, the low nibble stored +8 (in
    [1, 15]) and the high nibble two's complement (in [-7, 7]); "pairs"
    packs input rows (2i, 2i+1) into packed row i, "halves" rows (i, k2+i).
    scale: [..., in_dim // group, out_dim] f32. Leading dims stack layers;
    `layer(i)` is a view of one.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    group: int = 128
    packing: str = "pairs"

    @property
    def in_features(self) -> int:
        return self.packed.shape[-2] * 2

    @property
    def out_features(self) -> int:
        return self.packed.shape[-1]

    @property
    def shape(self):
        return (*self.packed.shape[:-2], self.in_features, self.out_features)

    def layer(self, i: int) -> "QuantizedWeight4":
        return QuantizedWeight4(self.packed[i], self.scale[i], self.group, self.packing)


def quantize_weight(w: torch.Tensor, *, scale_clamp: float = 1e-8) -> QuantizedWeight:
    """Per-output-channel symmetric max-abs quantization of [..., in, out]."""
    wf = w.to(torch.float32, copy=True)  # scratch for the in-place steps
    amax = wf.abs().amax(dim=-2)
    scale = true_div(torch.clamp(amax, min=scale_clamp), 127.0)
    wf = torch.round_(wf.div_(scale[..., None, :]))
    q = torch.clamp_(wf, -127, 127).to(torch.int8)
    out_major = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    return QuantizedWeight(values=out_major, scale=scale)


def quantize_weight4(
    w: torch.Tensor, *, group: int = 128, scale_clamp: float = 1e-8,
    packing: str = "pairs",
) -> QuantizedWeight4:
    """Group-wise symmetric max-abs INT4 quantization of [..., in, out]: one
    scale per (contiguous group of `group` input rows, output channel).
    Raises for a layout the packing cannot hold (halves needs 2*group | in)."""
    *lead, in_dim, out_dim = w.shape
    check_w4_layout(in_dim, group, packing)
    gn = in_dim // group
    wf = w.to(torch.float32, copy=True).reshape(*lead, gn, group, out_dim)
    amax = wf.abs().amax(dim=-2)  # [..., gn, out]
    scale = true_div(torch.clamp(amax, min=scale_clamp), 7.0)
    wf = torch.clamp_(torch.round_(wf.div_(scale[..., None, :])), -7, 7)
    q = wf.reshape(*lead, in_dim, out_dim).to(torch.int8)
    if packing == "pairs":
        lo, hi = q[..., 0::2, :], q[..., 1::2, :]
    else:
        lo, hi = q[..., :in_dim // 2, :], q[..., in_dim // 2:, :]
    return QuantizedWeight4(packed=pack_nibbles(lo, hi), scale=scale, group=group,
                            packing=packing)


def unpack_weight4(w: QuantizedWeight4) -> torch.Tensor:
    """The signed INT4 values [..., in, out] (int8 in [-7, 7]) of a
    QuantizedWeight4, rows in input order."""
    lo, hi = unpack_nibbles(w.packed)
    *lead, half, out = lo.shape
    if w.packing == "halves":
        return torch.cat([lo, hi], dim=-2)
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * half, out)


def dequantize_weight4(w: QuantizedWeight4) -> torch.Tensor:
    """Exact f32 reconstruction [..., in, out] of a QuantizedWeight4."""
    q = unpack_weight4(w)
    *lead, in_dim, out = q.shape
    qf = q.float().reshape(*lead, in_dim // w.group, w.group, out)
    return (qf * w.scale[..., :, None, :]).reshape(*lead, in_dim, out)


def concat_w4(parts) -> QuantizedWeight4:
    """Concatenate QuantizedWeight4 parts along the out dim. Scales are per
    (group, out channel), so quantize-then-concat equals concat-then-quantize:
    fusing projections is a layout change of quantized weights."""
    first = parts[0]
    if any(p.group != first.group for p in parts):
        raise ValueError("concat_w4: mismatched scale groups")
    if any(p.packing != first.packing for p in parts):
        raise ValueError("concat_w4: mismatched packings")
    if any(p.packed.shape[:-1] != first.packed.shape[:-1] for p in parts):
        raise ValueError("concat_w4: mismatched in/layer dims")
    return QuantizedWeight4(packed=torch.cat([p.packed for p in parts], dim=-1),
                            scale=torch.cat([p.scale for p in parts], dim=-1),
                            group=first.group, packing=first.packing)


def fuse_w4_projections(layers: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse wq|wk|wv -> wqkv and w_gate|w_up -> w_gateup in a (possibly
    layer-stacked) layer dict of QuantizedWeight4s, so that a decode step
    launches one kernel where it launched three or two. Callers split the
    output (models.llama.qkv_triple / mlp_gate_up). Keys that are not
    QuantizedWeight4 stay as they are."""
    out = dict(layers)
    if all(isinstance(layers.get(k), QuantizedWeight4) for k in ("wq", "wk", "wv")):
        out["wqkv"] = concat_w4([layers["wq"], layers["wk"], layers["wv"]])
        del out["wq"], out["wk"], out["wv"]
    if all(isinstance(layers.get(k), QuantizedWeight4) for k in ("w_gate", "w_up")):
        out["w_gateup"] = concat_w4([layers["w_gate"], layers["w_up"]])
        del out["w_gate"], out["w_up"]
    return out


# Rows at or below which a w4a16 product goes through the fused kernel
# (decode: the packed weight is read once against a few rows of x). Above
# it (prefill) the JAX package's own lowering runs: each nibble plane is
# dequantized to an activation-dtype weight and multiplied by torch.matmul,
# a plain large product. That is the reference's prefill path, not a
# fallback: a CUDA tensor at or below the threshold always launches the
# kernel.
_W4_DECODE_ROWS = 64


def _w4a16(x: torch.Tensor, w: QuantizedWeight4) -> torch.Tensor:
    *lead, in_dim = x.shape
    if in_dim != w.in_features:
        raise ValueError(f"x in_dim {in_dim} != weight in {w.in_features}")
    rows = x.numel() // in_dim
    xr = x.reshape(rows, in_dim)
    if rows <= _W4_DECODE_ROWS:
        out = w4_matmul(xr, w.packed, w.scale, group=w.group, packing=w.packing)
        return out.reshape(*lead, w.out_features)
    # Prefill (JAX quant/weights.py:313-321): the weight of each plane in
    # x's dtype, q and s both cast before their product, and the two
    # products added in x's dtype.
    out = None
    for xp, q, s, rpg in nibble_planes(xr, w.packed, w.scale, w.group, w.packing):
        wf = (q.to(x.dtype).reshape(-1, rpg, w.out_features) * s.to(x.dtype)[:, None, :])
        part = xp @ wf.reshape(-1, w.out_features)
        out = part if out is None else out + part
    return out.reshape(*lead, w.out_features)


# torch._int_mm's shape rules on CUDA: more than 16 rows, inner and outer
# dims multiples of 8. Decode's 1-8 rows are padded with zero rows up to
# _INT_MM_MIN_ROWS and sliced off again, which is exact: a zero row adds
# nothing to any other row's sums.
_INT_MM_MIN_ROWS = 17


def _w8a8_plain(xq: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 [M, K] and int8 [K, N]: summed in
    float64, which holds every partial sum exactly (integers below 2^53;
    |sum| <= 127^2 K < 2^31 for K <= 133144), on the CPU and on the card
    (which has no integer matmul of its own but torch._int_mm)."""
    return (xq.double() @ wv.double()).to(torch.int32)


def _int_mm_padded(xq: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wv [K, N] int8 -> [M, N] int32 through torch._int_mm,
    rows padded with zeros to its least count. A shape it cannot take
    raises ValueError: there is no float fallback."""
    m, k = xq.shape
    n = wv.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"w8a8's int8 product (torch._int_mm) takes inner and outer dims "
                         f"that are multiples of 8, got [{m}, {k}] x [{k}, {n}]")
    if m < _INT_MM_MIN_ROWS:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, wv)[:m]


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric max-abs int8 quantization of x [..., in] (JAX
    quant/weights.py:354-357): (xq int8, row_scale f32 [..., 1])."""
    xf = x.float()
    row_amax = xf.abs().amax(dim=-1, keepdim=True)
    row_scale = true_div(torch.clamp(row_amax, min=1e-8), 127.0)
    xq = torch.clamp(torch.round(xf / row_scale), -127, 127).to(torch.int8)
    return xq, row_scale


def _w8a8(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    *lead, in_dim = x.shape
    xq, row_scale = quantize_rows(x)
    product = _int_mm_padded if x.is_cuda else _w8a8_plain
    acc = product(xq.reshape(-1, in_dim), w.values).reshape(*lead, w.out_features)
    return (acc.float() * row_scale * w.scale).to(x.dtype)


def qdense(x: torch.Tensor, w, *, mode: str = "w8a16") -> torch.Tensor:
    """Matmul dispatch: plain tensors multiply as-is; a QuantizedWeight runs
    the selected quantized path and a QuantizedWeight4 (any mode) w4a16.
    x: [..., in] -> [..., out] in x.dtype."""
    if isinstance(w, QuantizedWeight4):
        if w.packed.ndim != 2:
            raise ValueError(
                "w4a16 matmuls take per-layer [in/2, out] packed weights; "
                f"got {tuple(w.packed.shape)}: take a layer view first")
        return _w4a16(x, w)
    if not isinstance(w, QuantizedWeight):
        return x @ w
    if mode == "w8a16":
        out = x @ w.values.to(x.dtype)
        return out * w.scale.to(x.dtype)
    if mode == "w8a8":
        return _w8a8(x, w)
    raise ValueError(f"unknown quantized matmul mode {mode!r}")


_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_stack4(w: torch.Tensor, group: int, packing: str) -> QuantizedWeight4:
    """quantize_weight4 of a layer-stacked [L, in, out] weight, one layer
    at a time into the stacked result (no f32 copy of the whole stack)."""
    L, in_dim, out_dim = w.shape
    check_w4_layout(in_dim, group, packing)
    packed = torch.empty((L, in_dim // 2, out_dim), dtype=torch.int8, device=w.device)
    scale = torch.empty((L, in_dim // group, out_dim), dtype=torch.float32, device=w.device)
    for i in range(L):
        qi = quantize_weight4(w[i], group=group, packing=packing)
        packed[i].copy_(qi.packed)
        scale[i].copy_(qi.scale)
    return QuantizedWeight4(packed, scale, group, packing)


def quantize_llama_params(
    params: Dict[str, Any], *, bits: int = 8, group: int = 128,
    lm_head_bits: Optional[int] = None, packing: str = "pairs",
) -> Dict[str, Any]:
    """Quantize every decoder-layer matmul weight of a models.llama params
    tree to INT8 (per channel) or INT4 (group-wise, `group` and `packing`);
    embed and norms stay float. lm_head_bits=8 also quantizes the output
    projection per channel."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if lm_head_bits not in (None, 8):
        raise ValueError(f"lm_head_bits must be None or 8, got {lm_head_bits}")
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_MATMULS:
        if bits == 8:
            layers[name] = quantize_weight(layers[name])
        else:
            layers[name] = _quantize_stack4(layers[name], group, packing)
    out["layers"] = layers
    if lm_head_bits == 8:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def weight_bytes(params: Dict[str, Any]) -> int:
    """Total parameter bytes (int8 and packed int4 payloads + scales + float
    leaves)."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, QuantizedWeight):
            yield t.values
            yield t.scale
        elif isinstance(t, QuantizedWeight4):
            yield t.packed
            yield t.scale
        else:
            yield t
    return sum(x.numel() * x.element_size() for x in leaves(params))
