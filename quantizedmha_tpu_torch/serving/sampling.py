"""Token sampling for the serving engine (counterpart of
quantizedmha_tpu/serving/sampling.py).

Greedy argmax, temperature, top-k and top-p (nucleus) sampling on device,
and speculative decoding's rejection sampling. Randomness comes from an explicit `torch.Generator`; with the same seed
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


def rejection_sample(draft_logits: torch.Tensor, target_logits: torch.Tensor,
                     drafts: torch.Tensor, generator: Optional[torch.Generator],
                     params: SamplingParams):
    """Speculative rejection sampling (Leviathan et al.): accept draft token
    x_j with probability min(1, p_j(x) / q_j(x)); at the first rejection
    draw the replacement from the residual max(p_j - q_j, 0), renormalized.
    p and q are the warped (temperature / top-k / top-p) distributions, so
    the emitted [accepted drafts] + [replacement] is distributed as
    sampling the target token by token with `params`.

    draft_logits, target_logits: [B, k, vocab] at the same positions;
    drafts: [B, k] the draft's tokens. Returns (n_accepted [B] int32,
    replacement [B] int32); the replacement means something only where
    n_accepted < k."""
    if params.greedy:
        raise ValueError("rejection_sample requires temperature > 0")
    B, k, _ = draft_logits.shape
    q = torch.softmax(warp_logits(draft_logits, params), dim=-1)
    p = torch.softmax(warp_logits(target_logits, params), dim=-1)
    idx = drafts.long()[..., None]
    qd = torch.gather(q, -1, idx)[..., 0]  # [B, k]
    pd = torch.gather(p, -1, idx)[..., 0]
    u = torch.rand((B, k), generator=generator, device=q.device)
    # u < p / q  <=>  u·q < p, with no division.
    acc = (u * qd) < pd
    n_accepted = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    # The residual at the first rejected position (clamped for rows that
    # accept everything, where it is unused).
    j = torch.clamp(n_accepted, max=k - 1)[:, None, None].expand(B, 1, p.shape[-1])
    p_j = torch.gather(p, 1, j)[:, 0]  # [B, vocab]
    q_j = torch.gather(q, 1, j)[:, 0]
    resid = torch.clamp(p_j - q_j, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    # p == q everywhere leaves no residual: any draw from p is right then.
    resid = torch.where(rs > 0.0, resid / torch.clamp(rs, min=1e-20), p_j)
    replacement = torch.multinomial(resid, 1, generator=generator)[:, 0]
    return n_accepted.to(torch.int32), replacement.to(torch.int32)
