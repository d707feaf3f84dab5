"""Mixed-precision paged KV: INT8 sink pages + INT4 bulk pages (counterpart
of quantizedmha_tpu/serving/mixed_kv.py).

Positions below a page-aligned `boundary_tokens` (the attention sinks and
early context, where outliers concentrate) live in an INT8 page pool; the
rest live nibble-packed in an INT4 pool, half the bytes. Attention runs
two partial softmaxes, the INT8 kernel over [0, min(length, boundary)) and
the INT4 kernel over [boundary, length) in its own frame (positions and
q_starts less the boundary), each with its lse; `merge_two_partials`
merges them exactly. A sequence shorter than the boundary has an empty
INT4 partial (lse = -inf) that drops out of the merge.

Device state is updated in place, as in serving/kv_cache.py. The JAX
package's `write_pages_mixed_routed` (both pools written, the non-owning
one at its scrap page, so that a jitted chunk keeps static shapes) has no
counterpart: the port's chunk start is a host int, so the adapter splits a
chunk's pages between the pools on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.ops.decode import (
    paged_decode_attention,
    paged_decode_attention_int4,
)
from quantizedmha_tpu_torch.ops.paged_prefill import (
    paged_prefill_attention,
    paged_prefill_attention_int4,
)
from quantizedmha_tpu_torch.ops.quantize import (
    pack_int4_halves,
    quantize_kv_blocks_int4,
    true_div,
)
from quantizedmha_tpu_torch.parallel.combine import merge_two_partials
from quantizedmha_tpu_torch.serving.kv_cache import (
    PagedKVCacheState,
    append_tokens_batched,
    write_pages,
)


@dataclasses.dataclass
class MixedPagedKVState:
    """Device tensors of one layer's mixed cache, or of all layers with a
    leading num_layers dim (`layer(i)` returns views of one layer). The
    pools are separate page spaces with separate block tables."""

    k8: torch.Tensor         # [(L,) Hkv, n8, page, hd] int8
    v8: torch.Tensor
    k8_scales: torch.Tensor  # [(L,) Hkv, n8] f32
    v8_scales: torch.Tensor
    k4: torch.Tensor         # [(L,) Hkv, n4, page, hd // 2] int8, nibble-packed
    v4: torch.Tensor
    k4_scales: torch.Tensor  # [(L,) Hkv, n4, subs] f32
    v4_scales: torch.Tensor

    @staticmethod
    def create(num_kv_heads: int, n8_pages: int, n4_pages: int, page_size: int,
               head_dim: int, subs: int = 4, num_layers: Optional[int] = None,
               device="cuda") -> "MixedPagedKVState":
        if head_dim % 2:
            raise ValueError("head_dim must be even for nibble packing")
        if page_size % subs:
            raise ValueError(f"page_size {page_size} not a multiple of subs {subs}")
        dev = resolve_device(device)
        lead = (num_layers,) if num_layers is not None else ()

        def zeros(*shape):
            return torch.zeros(lead + shape, dtype=torch.int8, device=dev)

        def ones(*shape):
            return torch.ones(lead + shape, dtype=torch.float32, device=dev)
        return MixedPagedKVState(
            k8=zeros(num_kv_heads, n8_pages, page_size, head_dim),
            v8=zeros(num_kv_heads, n8_pages, page_size, head_dim),
            k8_scales=ones(num_kv_heads, n8_pages), v8_scales=ones(num_kv_heads, n8_pages),
            k4=zeros(num_kv_heads, n4_pages, page_size, head_dim // 2),
            v4=zeros(num_kv_heads, n4_pages, page_size, head_dim // 2),
            k4_scales=ones(num_kv_heads, n4_pages, subs),
            v4_scales=ones(num_kv_heads, n4_pages, subs))

    def layer(self, i: int) -> "MixedPagedKVState":
        return MixedPagedKVState(*(getattr(self, f.name)[i]
                                   for f in dataclasses.fields(self)))

    @property
    def page_size(self) -> int:
        return self.k8.shape[-2]

    @property
    def subs(self) -> int:
        return self.k4_scales.shape[-1]

    def int8_view(self) -> PagedKVCacheState:
        """The INT8 pool as a plain paged cache (views, written in place)."""
        return PagedKVCacheState(self.k8, self.v8, self.k8_scales, self.v8_scales)


def quantize_page_int4(x: torch.Tensor, subs: int, scale_clamp: float = 1e-8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., Hkv, page_size, head_dim] -> (nibble-packed [..., Hkv,
    page_size, head_dim // 2] int8, per-(head, sub-tile) scales [..., Hkv,
    subs] f32): quantize_kv_blocks_int4 on each page."""
    *lead, h, p, d = x.shape
    if p % subs:
        raise ValueError(f"page_size {p} not a multiple of subs {subs}")
    packed, scale = quantize_kv_blocks_int4(x.reshape(-1, h, p, d), p,
                                            scale_clamp=scale_clamp, scale_block=p // subs)
    return packed.reshape(*lead, h, p, d // 2), scale.reshape(*lead, h, subs)


def write_pages_mixed(
    state: MixedPagedKVState,
    k_new: torch.Tensor,      # [Hkv, n_tokens, hd], whole pages of one sequence
    v_new: torch.Tensor,
    page_ids8: torch.Tensor,  # [p8] int8-pool pages (the first p8 pages of tokens)
    page_ids4: torch.Tensor,  # [p4] int4-pool pages (the rest)
) -> MixedPagedKVState:
    """Prefill write of one layer: the first len(page_ids8) pages of tokens
    land in the INT8 pool, the rest nibble-packed in the INT4 pool.
    n_tokens must be (p8 + p4) * page_size (pad first)."""
    page = state.page_size
    h, n_tokens, d = k_new.shape
    p8, p4 = page_ids8.shape[0], page_ids4.shape[0]
    if n_tokens != (p8 + p4) * page:
        raise ValueError(f"n_tokens {n_tokens} != ({p8}+{p4}) pages x {page}")
    if p8:
        write_pages(state.int8_view(), k_new[:, :p8 * page], v_new[:, :p8 * page],
                    page_ids8, page)
    if p4:
        ids = page_ids4.long()
        for new, pages, scales in ((k_new, state.k4, state.k4_scales),
                                   (v_new, state.v4, state.v4_scales)):
            x = new[:, p8 * page:].reshape(h, p4, page, d).transpose(0, 1)
            q, s = quantize_page_int4(x, state.subs)      # [p4, Hkv, ...]
            pages[:, ids] = q.transpose(0, 1)
            scales[:, ids] = s.transpose(0, 1)
    return state


def append_tokens_batched_int4(
    state: MixedPagedKVState,
    k_tok: torch.Tensor,     # [B, Hkv, hd]
    v_tok: torch.Tensor,
    page_ids: torch.Tensor,  # [B] int4-pool pages
    slots: torch.Tensor,     # [B]
) -> MixedPagedKVState:
    """One decoded token per sequence into the INT4 bulk. Scale policy: the
    first token of a sub-tile (slot % (page / subs) == 0) fits the
    sub-tile's scale; later tokens are quantized with it and clamped."""
    sub_w = state.page_size // state.subs
    ids, slots = page_ids.long(), slots.long()
    sub = slots // sub_w
    first = (slots % sub_w == 0)[None, :]
    for tok, pages, scales in ((k_tok, state.k4, state.k4_scales),
                               (v_tok, state.v4, state.v4_scales)):
        tf = tok.float().transpose(0, 1)                                    # [Hkv, B, hd]
        fit = true_div(torch.clamp(tf.abs().amax(dim=-1), min=1e-8), 7.0)  # [Hkv, B]
        sc = torch.where(first, fit, scales[:, ids, sub])
        q = torch.clamp(torch.round(tf / sc[..., None]), -7, 7)
        pages[:, ids, slots] = pack_int4_halves(q)
        scales[:, ids, sub] = sc
    return state


def append_token_int4(state: MixedPagedKVState, k_tok: torch.Tensor, v_tok: torch.Tensor,
                      page_id: int, slot: int) -> MixedPagedKVState:
    """append_tokens_batched_int4 for one token [Hkv, hd]."""
    dev = k_tok.device
    return append_tokens_batched_int4(state, k_tok[None], v_tok[None],
                                      torch.tensor([page_id], device=dev),
                                      torch.tensor([slot], device=dev))


def append_token_mixed(state: MixedPagedKVState, k_tok: torch.Tensor, v_tok: torch.Tensor, *,
                       position: int, boundary_tokens: int, page_id: int,
                       slot: int) -> MixedPagedKVState:
    """Route one decode-time append ([Hkv, hd]) to the pool that owns
    `position` (a host int): below the boundary INT8, at or past it INT4."""
    if position >= boundary_tokens:
        return append_token_int4(state, k_tok, v_tok, page_id, slot)
    dev = k_tok.device
    append_tokens_batched(state.int8_view(), k_tok[None], v_tok[None],
                          torch.tensor([page_id], device=dev), torch.tensor([slot], device=dev))
    return state


def append_tokens_batched_mixed(
    state: MixedPagedKVState,
    k_tok: torch.Tensor,      # [B, Hkv, hd]
    v_tok: torch.Tensor,
    positions: torch.Tensor,  # [B] absolute position per lane
    boundary_tokens: int,
    page_ids8: torch.Tensor,  # [B] int8-pool page owning the slot
    page_ids4: torch.Tensor,  # [B] int4-pool page owning the slot
    slots: torch.Tensor,      # [B] position % page (the boundary is page-aligned)
    scrap8: int = 0,
    scrap4: int = 0,
) -> MixedPagedKVState:
    """Batched mixed append: every lane writes both pools, the pool that
    does not own its position at that pool's scrap page, whose contents no
    kernel reads unmasked."""
    below = positions < boundary_tokens
    pid8 = torch.where(below, page_ids8, torch.full_like(page_ids8, scrap8))
    pid4 = torch.where(below, torch.full_like(page_ids4, scrap4), page_ids4)
    append_tokens_batched(state.int8_view(), k_tok, v_tok, pid8, slots)
    return append_tokens_batched_int4(state, k_tok, v_tok, pid4, slots)


def _check_mixed(page: int, boundary_tokens: int, window: Optional[int],
                 attention_sinks: int) -> None:
    if boundary_tokens % page:
        raise ValueError(f"boundary_tokens {boundary_tokens} not page-aligned ({page})")
    if window is None and attention_sinks:
        raise ValueError("attention_sinks requires a window (same contract as the "
                         "paged kernels)")
    if window is not None and attention_sinks != boundary_tokens:
        raise ValueError(
            f"windowed mixed attention needs attention_sinks ({attention_sinks}) == "
            f"boundary_tokens ({boundary_tokens}): the int8 region must be exactly the "
            "always-visible sink region for the two partial masks to compose exactly")


def mixed_paged_decode_attention(
    q: torch.Tensor,          # [batch, num_q_heads, head_dim]
    state: MixedPagedKVState,  # one layer
    lengths: torch.Tensor,    # [batch] total live context
    tables8: torch.Tensor,    # [batch, max_pages8] into the int8 pool
    tables4: torch.Tensor,    # [batch, max_pages4] into the int4 pool
    boundary_tokens: int,
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
) -> torch.Tensor:
    """Decode attention over the mixed cache: len8 = min(length, boundary)
    positions from the INT8 pool (no window: with a window the int8 region
    is the sinks), len4 = max(length - boundary, 0) from the INT4 pool with
    the window in its own frame and no sinks; merged by lse. Windowed use
    requires attention_sinks == boundary_tokens."""
    _check_mixed(state.page_size, boundary_tokens, window, attention_sinks)
    len8 = torch.clamp(lengths, max=boundary_tokens)
    len4 = torch.clamp(lengths - boundary_tokens, min=0)
    o8, lse8 = paged_decode_attention(
        q, state.k8, state.v8, state.k8_scales, state.v8_scales, len8, tables8,
        sm_scale=sm_scale, logit_softcap=logit_softcap, save_residuals=True)
    o4, lse4 = paged_decode_attention_int4(
        q, state.k4, state.v4, state.k4_scales, state.v4_scales, len4, tables4,
        sm_scale=sm_scale, window=window, logit_softcap=logit_softcap, save_residuals=True)
    return merge_two_partials(o8, lse8, o4, lse4)[0]


def mixed_paged_prefill_attention(
    q: torch.Tensor,          # [batch, num_q_heads, q_len, head_dim]
    state: MixedPagedKVState,  # one layer
    lengths: torch.Tensor,    # [batch] total visible context
    q_starts: torch.Tensor,   # [batch] absolute position of q row 0
    tables8: torch.Tensor,
    tables4: torch.Tensor,
    boundary_tokens: int,
    *,
    sm_scale: Optional[float] = None,
    block_q: int = 256,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    attention_sinks: int = 0,
) -> torch.Tensor:
    """The q_len > 1 form of mixed_paged_decode_attention: the INT8 partial
    in absolute positions, the INT4 partial with positions and q_starts
    less the boundary (rows below the boundary sit at negative positions
    there, see nothing and drop out of the merge)."""
    del block_q
    _check_mixed(state.page_size, boundary_tokens, window, attention_sinks)
    len8 = torch.clamp(lengths, max=boundary_tokens)
    len4 = torch.clamp(lengths - boundary_tokens, min=0)
    o8, lse8 = paged_prefill_attention(
        q, state.k8, state.v8, state.k8_scales, state.v8_scales, len8, q_starts, tables8,
        sm_scale=sm_scale, logit_softcap=logit_softcap, save_residuals=True)
    o4, lse4 = paged_prefill_attention_int4(
        q, state.k4, state.v4, state.k4_scales, state.v4_scales, len4,
        q_starts - boundary_tokens, tables4, sm_scale=sm_scale, window=window,
        logit_softcap=logit_softcap, save_residuals=True)
    return merge_two_partials(o8, lse8, o4, lse4)[0]
