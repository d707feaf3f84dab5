"""Quantization: KV block quantization (ops.quantize) and INT8 weight
quantization with the w8a16 matmul (quant.weights)."""

from quantizedmha_tpu_torch.ops.quantize import dequantize_kv_blocks, quantize_kv_blocks
from quantizedmha_tpu_torch.quant.weights import (
    QuantizedWeight,
    qdense,
    quantize_llama_params,
    quantize_weight,
    weight_bytes,
)

__all__ = [
    "dequantize_kv_blocks",
    "quantize_kv_blocks",
    "QuantizedWeight",
    "qdense",
    "quantize_llama_params",
    "quantize_weight",
    "weight_bytes",
]
