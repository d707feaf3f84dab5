"""PyTorch frontend (counterpart of
quantizedmha_tpu/frontends/torch_frontend.py) — extensions/torch/torch_ext.cpp
reborn.

The reference exposed `torch_ext.flash_solve(Q, K, V, d_model, num_heads,
kernel=...)` over flat [N, d_model] fp32 CUDA tensors, validating dtype and
shape (torch_ext.cpp:11-43). Here the same call runs `api.solve` on the
tensors' own device (the kernels on the card, their plain versions on the
CPU) and returns a tensor there: no host copies. As in the JAX package,
`kernel` really routes, and batched [..., N, d_model] inputs are accepted.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantizedmha_tpu_torch.api import KERNELS, solve


def flash_solve(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    d_model: int,
    num_heads: int,
    *,
    kernel: str = "fa_int8",
    causal: bool = False,
    use_rope: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention on torch tensors.

    q, k, v: torch.Tensor [..., N, d_model] float32 on one device (the
    reference ABI was the flat 2-D case). Returns a float32 tensor of the
    same shape on that device; the sequences of a batch are independent.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            # torch_ext.cpp:16 TORCH_CHECK(dtype == kFloat32) parity.
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError("q, k, v must have identical shapes")
    if q.ndim < 2:
        raise ValueError(f"expected [..., N, d_model], got {tuple(q.shape)}")
    if q.shape[-1] != d_model:
        raise ValueError(f"last dim {q.shape[-1]} != d_model {d_model}")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; choose from {KERNELS}")

    def one(qi, ki, vi):
        return solve(qi, ki, vi, d_model, num_heads, kernel=kernel, causal=causal,
                     use_rope=use_rope, sm_scale=sm_scale, device=q.device)

    if q.ndim == 2:
        return one(q, k, v)
    n = q.shape[-2]
    qs, ks, vs = (x.reshape(-1, n, d_model) for x in (q, k, v))
    out = torch.stack([one(qs[i], ks[i], vs[i]) for i in range(qs.shape[0])])
    return out.reshape(q.shape)
