"""quantizedmha_tpu_torch — the PyTorch/CUDA port of the JAX package.

A quantized flash-attention inference engine for an NVIDIA H100: the JAX
package `quantizedmha_tpu` is the reference, and every Pallas TPU kernel on
a ported path becomes a kernel written by hand for Hopper
(`quantizedmha_tpu_torch/csrc/`), built with nvcc at first use. Plain
tensor work (projections, norms, RoPE, quantize passes) is PyTorch. The
package imports nothing of JAX. Entry points run on the GPU unless the
caller passes device="cpu", where each kernel's plain PyTorch version runs.
"""

__version__ = "0.1.0"

from quantizedmha_tpu_torch.api import solve
from quantizedmha_tpu_torch.configs import (
    AttentionConfig,
    BlockSizes,
    QuantConfig,
    ReferenceWorkload,
)
from quantizedmha_tpu_torch.ops.decode import paged_decode_attention
from quantizedmha_tpu_torch.ops.flash_attention_int8 import flash_attention_int8

__all__ = [
    "__version__",
    "AttentionConfig",
    "BlockSizes",
    "QuantConfig",
    "ReferenceWorkload",
    "flash_attention_int8",
    "paged_decode_attention",
    "solve",
]
