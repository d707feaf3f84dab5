"""Reference-ABI entry point (counterpart of quantizedmha_tpu/api.py:solve).

The reference CUDA study exposes one C ABI, `solve(Q, K, V, out, N,
d_model, h)` over flat [N, d_model] float32 matrices; here it is a PyTorch
function. Only the rungs whose kernels are ported are served: "fa_int8"
(the fused INT8 attention, csrc/flash_int8_fwd.cu) and "reference" (the
plain golden). The other rungs raise NotImplementedError until their
kernels land (ROADMAP.md queue 2). The JAX package's `abi_fast` layout
path is a TPU relayout with bitwise-equal output and has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantizedmha_tpu_torch.configs.attention import AttentionConfig
from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.ops.flash_attention import validate_masking
from quantizedmha_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from quantizedmha_tpu_torch.reference.mha import (
    apply_rope,
    mha_masked_reference,
    mha_reference_shaped,
)

KERNELS = ("unfused", "fa", "fa_bf16", "fa_int8", "reference")
PORTED_KERNELS = ("fa_int8", "reference")


def solve(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    d_model: int,
    num_heads: Optional[int] = None,
    *,
    kernel: str = "fa_int8",
    config: Optional[AttentionConfig] = None,
    causal: Optional[bool] = None,
    use_rope: Optional[bool] = None,
    rope_theta: Optional[float] = None,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Multi-head attention over flat [N, d_model] Q/K/V (reference ABI).

    Moves the inputs to `device` (default "cuda"; pass "cpu" for the plain
    PyTorch versions), splits heads, optionally applies RoPE to Q and K,
    runs the selected kernel over all heads in one launch, and merges the
    heads back. Returns [N, d_model] in q's dtype on `device`.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; choose from {KERNELS}")
    if kernel not in PORTED_KERNELS:
        raise NotImplementedError(
            f"kernel {kernel!r} is not ported to PyTorch/CUDA yet "
            "(ROADMAP.md queue 1 item 3, queue 2: ops/flash_attention.py "
            "_fwd_kernel); ported rungs: " + ", ".join(PORTED_KERNELS))
    dev = resolve_device(device)
    quant_kw = {}
    if config is not None:
        config.validate()
        num_heads = num_heads if num_heads is not None else config.num_heads
        causal = causal if causal is not None else config.causal
        use_rope = use_rope if use_rope is not None else config.use_rope
        rope_theta = rope_theta if rope_theta is not None else config.rope_theta
        sm_scale = sm_scale if sm_scale is not None else config.sm_scale
        if config.head_dim is not None and config.head_dim * num_heads != d_model:
            raise ValueError(
                f"config.head_dim {config.head_dim} * num_heads {num_heads} "
                f"!= d_model {d_model}")
        blocks = config.blocks.validate(q.shape[0], k.shape[0])
        block_q = block_q if block_q is not None else blocks.block_q
        block_kv = block_kv if block_kv is not None else blocks.block_kv
        quant_kw = dict(scale_clamp=config.quant.scale_clamp,
                        p_static_scale=config.quant.p_static_scale)
    if num_heads is None:
        raise ValueError("pass num_heads or a config")
    causal = bool(causal) if causal is not None else False
    use_rope = bool(use_rope) if use_rope is not None else False
    rope_theta = float(rope_theta) if rope_theta is not None else 10000.0
    validate_masking(causal, window, attention_sinks)
    n = q.shape[0]
    d = d_model // num_heads
    if d * num_heads != d_model:
        raise ValueError("num_heads must divide d_model")

    def split(x):
        x = x.to(dev)
        return x.reshape(x.shape[0], num_heads, d).transpose(0, 1)[None]  # [1, h, N, d]

    qh, kh, vh = split(q), split(k), split(v)
    if use_rope:
        qh = apply_rope(qh, rope_theta)
        kh = apply_rope(kh, rope_theta)

    if kernel == "fa_int8":
        oh = flash_attention_int8(
            qh, kh, vh, sm_scale=sm_scale, causal=causal,
            block_q=block_q, block_kv=block_kv, window=window,
            logit_softcap=logit_softcap, attention_sinks=attention_sinks,
            **quant_kw)
    elif window is not None or logit_softcap is not None:
        oh = mha_masked_reference(
            qh, kh, vh, sm_scale=sm_scale, causal=causal,
            window=window, softcap=logit_softcap, sinks=attention_sinks)
    else:
        oh = mha_reference_shaped(qh, kh, vh, sm_scale=sm_scale, causal=causal)
    return oh[0].transpose(0, 1).reshape(n, d_model)
