"""The guard of the kernels that have no backward.

A wrapper that fills a `torch.empty` through a ctypes launch returns a
tensor with no autograd history: a gradient through it would be dropped
without a word. Where the JAX package has no gradient either (`jax.grad`
through its Pallas kernel fails), the port's entry point raises instead.
"""

from __future__ import annotations

import torch


def refuse_grad(message: str, *tensors: torch.Tensor) -> None:
    """Raise NotImplementedError(message) when grad is enabled and one of
    `tensors` requires grad, on the CPU as on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(message)
