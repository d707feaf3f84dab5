"""Quantization: KV block quantization (ops.quantize) and INT8 / INT4
weight quantization with the w8a16 and w4a16 matmuls (quant.weights)."""

from quantizedmha_tpu_torch.ops.quantize import dequantize_kv_blocks, quantize_kv_blocks
from quantizedmha_tpu_torch.quant.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    dequantize_weight4,
    fuse_w4_projections,
    qdense,
    quantize_llama_params,
    quantize_weight,
    quantize_weight4,
    weight_bytes,
)

__all__ = [
    "dequantize_kv_blocks",
    "quantize_kv_blocks",
    "QuantizedWeight",
    "QuantizedWeight4",
    "dequantize_weight4",
    "fuse_w4_projections",
    "qdense",
    "quantize_llama_params",
    "quantize_weight",
    "quantize_weight4",
    "weight_bytes",
]
