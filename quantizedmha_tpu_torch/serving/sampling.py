"""Token sampling for the serving engine (counterpart of
quantizedmha_tpu/serving/sampling.py).

Greedy argmax, temperature, top-k and top-p (nucleus) sampling on device.
Randomness comes from an explicit `torch.Generator`; with the same seed
the draws differ from the JAX package's (different generators), greedy
decoding is identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy argmax (top_k/top_p ignored).
    top_k == 0 -> no k-truncation; top_p == 1.0 -> no nucleus truncation.
    Both set -> top-k first, then the nucleus over the survivors."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def validate(self) -> "SamplingParams":
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        return self

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def warp_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature / top-k / top-p over [..., vocab] logits; the softmax of
    the result is the sampling distribution. Requires temperature > 0."""
    scaled = logits.float() / params.temperature
    if params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])
        kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if params.top_p < 1.0:
        # Keep the smallest set whose mass reaches top_p: mask everything
        # softer than the last kept logit (the first is always kept).
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < params.top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    return scaled


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           params: SamplingParams) -> torch.Tensor:
    """logits: [batch, vocab] -> tokens [batch] int32."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(warp_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
