"""Runtime configuration dataclasses.

PyTorch counterpart of quantizedmha_tpu/configs/attention.py: the reference
CUDA study's compile-time problem shape and tile sizes (its
include/config.h:7-33) as plain dataclasses whose `validate()` methods stand
in for the `static_assert`s. On the GPU the tile sizes of the hand-written
kernels are the kernels' own business; `BlockSizes.block_kv` stays a
NUMERICS parameter (the K/V quantization block and the online-softmax step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Attention block sizes: block_kv is the K/V quantization block (one
    scale per (head, block)) and the online-softmax step of the int8
    kernels; block_q has no numerical effect (the CUDA kernel picks its
    own q tile) and is kept for the JAX package's signature."""

    block_q: int = 256
    block_kv: int = 256

    def validate(self, q_len: int, kv_len: int) -> "BlockSizes":
        _check(self.block_q >= 1 and self.block_kv >= 1, "blocks must be >= 1")
        return BlockSizes(
            block_q=min(self.block_q, q_len),
            block_kv=min(self.block_kv, kv_len),
        )


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """INT8 quantization policy of the fused kernel: symmetric max-abs
    scales clamped below at `scale_clamp`, and the static scale that maps
    softmax probabilities (0, 1] onto (0, p_static_scale]."""

    scale_clamp: float = 1e-8
    p_static_scale: float = 127.0

    def validate(self) -> "QuantConfig":
        _check(self.scale_clamp > 0, "scale_clamp must be positive")
        _check(self.p_static_scale > 0, "p_static_scale must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Problem-shape + numerics config (reference include/config.h reborn)."""

    num_heads: int = 32
    # None -> derived from the call-site d_model // num_heads; set it to
    # DECLARE the head dim and solve() will cross-check it.
    head_dim: Optional[int] = None
    causal: bool = False
    sm_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    use_rope: bool = False
    rope_theta: float = 10000.0
    blocks: BlockSizes = dataclasses.field(default_factory=BlockSizes)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    @property
    def d_model(self) -> int:
        if self.head_dim is None:
            raise ValueError("d_model needs an explicit head_dim")
        return self.num_heads * self.head_dim

    def scale(self) -> float:
        if self.sm_scale is not None:
            return self.sm_scale
        if self.head_dim is None:
            raise ValueError("scale() needs sm_scale or an explicit head_dim")
        return self.head_dim**-0.5

    def validate(self) -> "AttentionConfig":
        _check(self.num_heads >= 1, "num_heads must be >= 1")
        _check(self.head_dim is None or self.head_dim >= 1,
               "head_dim must be >= 1")
        self.quant.validate()
        return self


# The reference's published workload: N=8192, d_model=1024, h=32 => d=32,
# FP32 in/out (reference include/config.h:22-28). Its fa_tc_int8_b kernel
# solves it in 7.70 ms on an NVIDIA L4 (reference README.md:19).

@dataclasses.dataclass(frozen=True)
class ReferenceWorkload:
    seq_len: int = 8192
    d_model: int = 1024
    num_heads: int = 32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads
