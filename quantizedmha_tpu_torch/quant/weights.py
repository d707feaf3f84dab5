"""INT8 weight quantization for the model/serving path (counterpart of the
int8 half of quantizedmha_tpu/quant/weights.py).

Symmetric per-output-channel INT8 weights with the w8a16 matmul: weights
stored int8 + f32 channel scales, the matmul runs in the activation dtype
and the channel scales commute to the output, x @ (W·s) == (x @ W)·s. The
JAX package leaves this to XLA; here it is plain PyTorch, which makes a
transient copy of the weight in the activation dtype per call. Norms,
embeddings and (unless lm_head_bits=8) the lm_head stay float.

Not ported yet: w8a8 (its home is torch._int_mm) and the INT4 weights with
their fused dequant-matmul kernel (ops/w4_matmul.py), ROADMAP.md slice 2.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from quantizedmha_tpu_torch.ops.quantize import true_div

_W4_TODO = ("INT4 weights need ops/w4_matmul.py's fused dequant-matmul "
            "kernel, not ported yet (ROADMAP.md queue 1 item 4, slice 2)")


@dataclasses.dataclass
class QuantizedWeight:
    """Symmetric per-output-channel int8 weight: w ≈ values * scale[None, :].

    values: [..., in_dim, out_dim] int8; scale: [..., out_dim] f32. Leading
    dims stack layers; `layer(i)` is a view of one.
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


def quantize_weight(w: torch.Tensor, *, scale_clamp: float = 1e-8) -> QuantizedWeight:
    """Per-output-channel symmetric max-abs quantization of [..., in, out]."""
    wf = w.to(torch.float32, copy=True)  # scratch for the in-place steps
    amax = wf.abs().amax(dim=-2)
    scale = true_div(torch.clamp(amax, min=scale_clamp), 127.0)
    wf = torch.round_(wf.div_(scale[..., None, :]))
    q = torch.clamp_(wf, -127, 127).to(torch.int8)
    return QuantizedWeight(values=q, scale=scale)


def qdense(x: torch.Tensor, w, *, mode: str = "w8a16") -> torch.Tensor:
    """Matmul dispatch: plain tensors multiply as-is; a QuantizedWeight runs
    the selected quantized path. x: [..., in] -> [..., out] in x.dtype."""
    if not isinstance(w, QuantizedWeight):
        return x @ w
    if mode == "w8a16":
        out = x @ w.values.to(x.dtype)
        return out * w.scale.to(x.dtype)
    if mode == "w8a8":
        raise NotImplementedError(
            "weight_quant_mode='w8a8' is not ported yet (its home is "
            "torch._int_mm; ROADMAP.md queue 1 item 4)")
    raise ValueError(f"unknown quantized matmul mode {mode!r}")


_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llama_params(
    params: Dict[str, Any], *, bits: int = 8, group: int = 128,
    lm_head_bits: Optional[int] = None, packing: str = "pairs",
) -> Dict[str, Any]:
    """Quantize every decoder-layer matmul weight of a models.llama params
    tree to per-channel INT8; embed and norms stay float. lm_head_bits=8
    also quantizes the output projection."""
    del group, packing  # INT4 knobs, kept for signature parity
    if bits == 4:
        raise NotImplementedError(_W4_TODO)
    if bits != 8:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if lm_head_bits not in (None, 8):
        raise ValueError(f"lm_head_bits must be None or 8, got {lm_head_bits}")
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_MATMULS:
        layers[name] = quantize_weight(layers[name])
    out["layers"] = layers
    if lm_head_bits == 8:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def weight_bytes(params: Dict[str, Any]) -> int:
    """Total parameter bytes (int8 payloads + scales + float leaves)."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, QuantizedWeight):
            yield t.values
            yield t.scale
        else:
            yield t
    return sum(x.numel() * x.element_size() for x in leaves(params))
