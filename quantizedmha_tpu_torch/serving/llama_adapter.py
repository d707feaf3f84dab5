"""Llama model adapter for the serving engine: prefill + paged decode
(counterpart of quantizedmha_tpu/serving/llama_adapter.py).

  - prefill: causal attention over the (right-padded) prompt through the
    fused INT8 kernel; returns the per-layer K/V (post-RoPE) for cache
    insertion plus the logits of the last real token.
  - decode_step: one token per sequence: project q/k/v, RoPE at the
    absolute position, append K/V to the paged INT8 cache in place, attend
    with ops.decode.paged_decode_attention.
  - decode_loop: n_steps of decode_step with on-device sampling feeding
    the next step, no host round-trip per token.
  - prefill_chunk: one chunk of a prompt (past the largest bucket, or the
    suffix past a cached prefix): its K/V are written to their pages
    first, then its queries attend from the pages with
    ops.paged_prefill.paged_prefill_attention.
  - verify_step: speculative decoding's verification, k + 1 tokens a
    sequence in one forward (appended token by token, then attended with
    per-sequence offsets through paged_prefill_attention).

The mixed-precision cache (serving/mixed_kv.py: INT8 pages below a
boundary, INT4 past it) takes (INT8, INT4) pairs of page ids and tables
and boundary_tokens in decode_step, decode_loop and prefill_chunk;
write_prefill_mixed writes a prompt to it.

The cache is layer-stacked ([num_layers, ...] tensors); each layer works on
views of its slice. The hybrid cache (make_cache_hybrid) is a dict of such
caches, one a window group, each with its own page pool: decode_step,
decode_loop, prefill_chunk and verify_step take it with per-group page ids
and tables. make_cache_hybrid_mixed makes the full-attention group a mixed
cache, whose ids and tables travel as pairs inside the group dicts.

Tensor parallelism: prefill_at, prefill, prefill_chunk, decode_step,
decode_loop and verify_step take a `group` (JAX's axis_name: a
torch.distributed process group, None for one rank). With it, the call runs
on this rank's shard of Megatron-sharded weights (wq / wk / wv / w_gate /
w_up cut on contiguous head groups, wo / w_down on their input rows;
serving/sharded.py) and of a kv-head-sharded cache, given the LOCAL config
(sharded.local_config); the wo and w_down products are all-reduced over the
group before the residual add, the only two collectives of a TP decoder
layer. Norms, embeddings and the lm_head are replicated, so every rank
computes the same logits.

Context parallelism: prefill_cp_at runs a prompt's sequence shard on each
rank of a group with ring attention a layer and gathers the whole prompt's
K/V (and the last token's hidden row) once at the end.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from quantizedmha_tpu_torch.models.llama import (
    LlamaConfig,
    _act,
    _attention,
    check_attention_impl,
    embed_tokens,
    final_logits,
    layer_params,
    mlp_gate_up,
    qkv_triple,
    rms_norm,
)
from quantizedmha_tpu_torch.ops.decode import paged_decode_attention
from quantizedmha_tpu_torch.ops.paged_prefill import paged_prefill_attention
from quantizedmha_tpu_torch.quant.weights import qdense
from quantizedmha_tpu_torch.reference.mha import apply_rope
from quantizedmha_tpu_torch.serving.kv_cache import (
    PagedKVCacheState,
    append_tokens_batched,
    write_pages,
)
from quantizedmha_tpu_torch.serving.mixed_kv import (
    MixedPagedKVState,
    append_tokens_batched_mixed,
    mixed_paged_decode_attention,
    mixed_paged_prefill_attention,
    write_pages_mixed,
)
from quantizedmha_tpu_torch.serving.sampling import SamplingParams, sample


def ensure_serving_supported(cfg: LlamaConfig) -> None:
    """Validate the knob values early (at cache creation, not mid-step)."""
    check_attention_impl(cfg)
    _act(cfg, torch.zeros(1))  # raises on an unknown hidden_act
    cfg.layer_windows  # raises on a mis-sized window_pattern


def _tp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum a row-parallel product's partials over the TP group, in its own
    dtype (JAX's psum), in place; no-op without a group."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _attn_residual(cfg: LlamaConfig, dense, p, x, o_flat, group=None):
    o = _tp_sum(dense(o_flat.to(cfg.dtype), p["wo"]), group)
    if cfg.sandwich_norms:
        o = rms_norm(o, p["post_attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return x + o


def _mlp_residual(cfg: LlamaConfig, dense, p, x, group=None):
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps, cfg.rms_plus_one)
    g_pre, up = mlp_gate_up(cfg, dense, h, p)
    gate = _act(cfg, g_pre.float()).to(x.dtype)
    m = _tp_sum(dense(gate * up, p["w_down"]), group)
    if cfg.sandwich_norms:
        m = rms_norm(m, p["post_mlp_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return x + m


def make_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
               device="cuda") -> PagedKVCacheState:
    """Layer-stacked cache: every tensor has a leading num_layers dim."""
    ensure_serving_supported(cfg)
    return PagedKVCacheState.create(cfg.num_kv_heads, num_pages, page_size,
                                    cfg.hd, num_layers=cfg.num_layers,
                                    device=device)


# --- Hybrid (per-window-group) KV cache -------------------------------------
#
# A window pattern splits the layers into groups by window value. Each group
# gets its own layer-stacked cache and page pool, so the engine recycles a
# sliding group's pages behind its window while the full-attention group
# keeps all of its own: a sequence holds L_full * O(context) + L_slide *
# O(window + sinks) of KV instead of L * O(context). Group keys are strings
# ("full", "w4096").

def group_key(window: Optional[int]) -> str:
    return "full" if window is None else f"w{window}"


def window_groups(cfg: LlamaConfig) -> Dict[str, List[int]]:
    """Group layout: key -> ascending global layer indices with that window."""
    groups: Dict[str, List[int]] = {}
    for i, w in enumerate(cfg.layer_windows):
        groups.setdefault(group_key(w), []).append(i)
    return groups


def make_cache_hybrid(cfg: LlamaConfig, pages_by_group: Dict[str, int], page_size: int,
                      device="cuda") -> Dict[str, PagedKVCacheState]:
    """One layer-stacked cache per window group (leading dim the group's
    layer count, stacked in ascending global layer order)."""
    ensure_serving_supported(cfg)
    groups = window_groups(cfg)
    missing = set(groups) - set(pages_by_group)
    if missing:
        raise ValueError(f"pages_by_group missing groups {sorted(missing)}")
    return {key: PagedKVCacheState.create(cfg.num_kv_heads, pages_by_group[key], page_size,
                                          cfg.hd, num_layers=len(idxs), device=device)
            for key, idxs in groups.items()}


def make_cache_hybrid_mixed(cfg: LlamaConfig, pages_by_group: Dict[str, int], page_size: int,
                            *, n8_pages: int, n4_pages: int, subs: int = 4,
                            device="cuda") -> Dict[str, Any]:
    """make_cache_hybrid with the full-attention group a layer-stacked
    MixedPagedKVState (INT8 sinks, INT4 bulk) and the sliding groups plain
    INT8: the full layers are the group whose KV grows with the context
    (trims hold a sliding group to its window and sinks), so the INT4
    capacity goes there."""
    ensure_serving_supported(cfg)
    groups = window_groups(cfg)
    if "full" not in groups:
        raise ValueError("mixed_kv x hybrid_kv puts the int8/int4 split on the full-attention "
                         f"group; this window pattern has none (groups: {sorted(groups)})")
    missing = set(groups) - set(pages_by_group) - {"full"}
    if missing:
        raise ValueError(f"pages_by_group missing groups {sorted(missing)}")
    return {key: (MixedPagedKVState.create(cfg.num_kv_heads, n8_pages, n4_pages, page_size,
                                           cfg.hd, subs, num_layers=len(idxs), device=device)
                  if key == "full" else
                  PagedKVCacheState.create(cfg.num_kv_heads, pages_by_group[key], page_size,
                                           cfg.hd, num_layers=len(idxs), device=device))
            for key, idxs in groups.items()}


def _g(d, window):
    """A maybe-grouped argument: a dict gives the window group's entry,
    anything else is shared by every group."""
    return d[group_key(window)] if isinstance(d, dict) else d


def layer_stacks(cfg: LlamaConfig, cache) -> List[Tuple[Any, int]]:
    """For each layer, (the layer-stacked cache that holds it, its index
    there): a group dict gives a layer its group's stack and its rank in the
    group; a single cache, itself and the layer's index."""
    if not isinstance(cache, dict):
        return [(cache, i) for i in range(cfg.num_layers)]
    stacks: List[Tuple[Any, int]] = [None] * cfg.num_layers
    for key, idxs in window_groups(cfg).items():
        if key not in cache:
            raise ValueError(f"the hybrid cache has no group {key!r} for layers {idxs} "
                             f"(groups given: {sorted(cache)})")
        for rank, i in enumerate(idxs):
            stacks[i] = (cache[key], rank)
    return stacks


def prefill_at(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
               last_index, *, group=None):
    """Prefill over a (possibly right-padded) prompt.

    tokens: [1, n_pad]; last_index: index of the final REAL token (causal
    attention makes its logits independent of the padding).
    Returns (logits [1, vocab], k_all, v_all [L, Hkv, n_pad, hd], post-RoPE).
    """
    b, n = tokens.shape
    hd = cfg.hd
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    x = embed_tokens(cfg, params, tokens)
    k_all, v_all = [], []
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = q.reshape(b, n, cfg.num_heads, hd).transpose(1, 2)
        k = k.reshape(b, n, cfg.num_kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, n, cfg.num_kv_heads, hd).transpose(1, 2)
        q = apply_rope(q, cfg.rope_theta)
        k = apply_rope(k, cfg.rope_theta)
        k_all.append(k[0])
        v_all.append(v[0])
        o = _attention(cfg, q, k, v, causal=True, window=window)
        o = o.transpose(1, 2).reshape(b, n, cfg.num_heads * hd)
        x = _attn_residual(cfg, dense, p, x, o, group)
        x = _mlp_residual(cfg, dense, p, x, group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    # Project ONLY the requested position (the full [n, vocab] logits would
    # be discarded but for one row).
    logits = final_logits(cfg, x[:, last_index], params["lm_head"])
    return logits, torch.stack(k_all), torch.stack(v_all)


def prefill(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor, *, group=None):
    """tokens: [1, n] -> (last_logits [1, vocab], k_all, v_all [L, Hkv, n, hd])."""
    return prefill_at(cfg, params, tokens, tokens.shape[1] - 1, group=group)


def _cp_positions(idx: int, n_shard: int, device) -> torch.Tensor:
    """Global positions of rank idx's contiguous shard of a CP prefill."""
    return idx * n_shard + torch.arange(n_shard, device=device)


def prefill_cp_at(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
                  last_index: int, *, group):
    """Context-parallel prefill over the ranks of `group` (JAX's axis_name),
    parameters replicated: `tokens` is this rank's contiguous shard [1,
    n_shard] of the (right-padded) prompt, shard r at positions [r n_shard,
    (r + 1) n_shard); last_index the final REAL token's GLOBAL index.

    A rank's embeddings, norms, projections and MLP are local; RoPE takes
    global positions; each layer's attention is the ring
    (parallel.ring.ring_attention: K/V shards rotate, windows, sinks and
    softcap on global positions). At the end one all-gather brings every
    rank's K/V and, from the last token's owner, its normed hidden row, so
    every rank computes the same logits and holds the whole prompt's K/V
    for its cache (JAX returns them sharded and gathers them implicitly).

    Returns (logits [1, vocab], k_all, v_all [L, Hkv, n_shard * ranks, hd],
    post-RoPE)."""
    from quantizedmha_tpu_torch.parallel.ring import gather_shards, ring_attention

    b, n_shard = tokens.shape
    if b != 1:
        raise ValueError("context-parallel prefill is per-sequence")
    hd = cfg.hd
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    idx, size = dist.get_rank(group), dist.get_world_size(group)
    positions = _cp_positions(idx, n_shard, tokens.device)[None, :]  # [1, S]
    x = embed_tokens(cfg, params, tokens)
    k_all, v_all = [], []
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = q.reshape(b, n_shard, cfg.num_heads, hd).transpose(1, 2)
        k = k.reshape(b, n_shard, cfg.num_kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, n_shard, cfg.num_kv_heads, hd).transpose(1, 2)
        q = _rope_positions(q, positions, cfg.rope_theta)
        k = _rope_positions(k, positions, cfg.rope_theta)
        k_all.append(k[0])
        v_all.append(v[0])
        o = ring_attention(q, k, v, group=group, causal=True, **_attn_masks(cfg, window))
        o = o.transpose(1, 2).reshape(b, n_shard, cfg.num_heads * hd)
        x = _attn_residual(cfg, dense, p, x, o)
        x = _mlp_residual(cfg, dense, p, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    owner, row = divmod(int(last_index), n_shard)
    x_last = x[0, row] if idx == owner else torch.zeros_like(x[0, 0])
    kv = torch.stack([torch.stack(k_all), torch.stack(v_all)])  # [2, L, Hkv, S, hd]
    del k_all, v_all
    parts = gather_shards(torch.cat([kv.flatten(), x_last]), group)
    n_kv = kv.numel()
    kv = parts[:, :n_kv].reshape(size, *kv.shape).permute(1, 2, 3, 0, 4, 5)
    kv = kv.reshape(2, cfg.num_layers, cfg.num_kv_heads, size * n_shard, hd)
    logits = final_logits(cfg, parts[owner, n_kv:][None], params["lm_head"])
    return logits, kv[0], kv[1]


def write_prefill(
    cfg: LlamaConfig,
    cache: PagedKVCacheState,  # layer-stacked
    k_all: torch.Tensor,  # [L, Hkv, n_tokens, hd] (n_tokens multiple of page_size)
    v_all: torch.Tensor,
    page_ids: torch.Tensor,  # [n_pages] — same physical ids for every layer
    *,
    page_size: int,
) -> PagedKVCacheState:
    """Quantize + write a prompt's K/V into the paged cache, all layers."""
    for i in range(cfg.num_layers):
        write_pages(cache.layer(i), k_all[i], v_all[i], page_ids, page_size)
    return cache


def write_prefill_hybrid(
    cfg: LlamaConfig,
    caches: Dict[str, PagedKVCacheState],
    k_all: torch.Tensor,  # [L, Hkv, n_tokens, hd], every layer
    v_all: torch.Tensor,
    page_ids: Dict[str, Any],  # per group: [n_pages] its pool's ids; mixed: (ids8, ids4)
    *,
    page_size: int,
) -> Dict[str, Any]:
    """write_prefill into the hybrid cache: each group receives its own
    layers' K/V, written into its own page pool (a mixed group's first
    len(ids8) pages INT8, the rest INT4)."""
    for (cache, rank), k, v, window in zip(layer_stacks(cfg, caches), k_all, v_all,
                                           cfg.layer_windows):
        ids = page_ids[group_key(window)]
        if isinstance(ids, tuple):
            write_pages_mixed(cache.layer(rank), k, v, *ids)
        else:
            write_pages(cache.layer(rank), k, v, ids, page_size)
    return caches


def _chunk_page_ids(table, chunk_start: int, C: int, page_size: int,
                    boundary_tokens: Optional[int]):
    """The pages a chunk [chunk_start, +C) writes: a slice of a plain
    table; for a mixed (table8, table4) pair the (INT8 ids, INT4 ids) split
    on the host (a table index past the INT4 table clips to its last slot,
    as the JAX package's routed write does)."""
    first, last = chunk_start // page_size, (chunk_start + C) // page_size
    if not isinstance(table, tuple):
        return table[first:last]
    if boundary_tokens is None:
        raise ValueError("a mixed-cache chunk needs boundary_tokens")
    t8, t4 = table
    bp = boundary_tokens // page_size
    return (t8[[i for i in range(first, last) if i < bp]],
            t4[[min(i - bp, t4.shape[0] - 1) for i in range(first, last) if i >= bp]])


def _attn_masks(cfg: LlamaConfig, window: Optional[int]) -> Dict[str, Any]:
    return dict(sm_scale=cfg.sm_scale, window=window, logit_softcap=cfg.logit_softcap,
                attention_sinks=cfg.attention_sinks if window is not None else 0)


def prefill_chunk(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    cache,                     # layer-stacked (or a group dict), updated in place
    tokens: torch.Tensor,      # [1, C] one chunk, right-padded
    chunk_start: int,          # multiple of page_size
    table,                     # [max_pages] this sequence's block table
    last_index: int,           # last REAL token index within the chunk
    *,
    page_size: int,
    boundary_tokens: Optional[int] = None,
    group=None,
) -> Tuple[torch.Tensor, Any]:
    """One chunk of a chunked prefill: per layer, project and RoPE the
    chunk at its global positions, write its K/V into its pages (padding
    rows zeroed, so they cannot coarsen the per-page scales), then attend
    its queries from the pages: the prefix and the chunk's own keys, INT8
    as decode reads them, causal by global position (q_starts =
    chunk_start, lengths = chunk_start + C). A hybrid cache (a group dict)
    takes a group dict of tables. A mixed cache (a mixed group) takes a
    (table8, table4) pair and boundary_tokens: the chunk's pages below the
    boundary are written INT8 and the rest INT4, and its queries attend
    through mixed_paged_prefill_attention.

    Returns (logits [1, vocab] at last_index, cache)."""
    b, C = tokens.shape
    if b != 1:
        raise ValueError("chunked prefill is per-sequence")
    if chunk_start % page_size or C % page_size:
        raise ValueError(f"chunk [{chunk_start}, +{C}) is not page-aligned ({page_size})")
    hd = cfg.hd
    dev = tokens.device
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    positions = chunk_start + torch.arange(C, device=dev)
    keep = (torch.arange(C, device=dev) <= last_index)[None, :, None]
    lengths = torch.tensor([chunk_start + C], dtype=torch.int32, device=dev)
    q_starts = torch.tensor([chunk_start], dtype=torch.int32, device=dev)
    stacks = layer_stacks(cfg, cache)
    chunk_ids = {}  # group key -> the pages this chunk writes in that group
    x = embed_tokens(cfg, params, tokens)
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = q.reshape(b, C, cfg.num_heads, hd).transpose(1, 2)
        k = k.reshape(b, C, cfg.num_kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, C, cfg.num_kv_heads, hd).transpose(1, 2)
        q = apply_rope(q, cfg.rope_theta, positions)
        k = apply_rope(k, cfg.rope_theta, positions)
        stack, li = stacks[i]
        layer = stack.layer(li)
        tbl = _g(table, window)
        key = group_key(window)
        if key not in chunk_ids:
            chunk_ids[key] = _chunk_page_ids(tbl, chunk_start, C, page_size, boundary_tokens)
        if isinstance(stack, MixedPagedKVState):
            write_pages_mixed(layer, k[0] * keep, v[0] * keep, *chunk_ids[key])
            o = mixed_paged_prefill_attention(q, layer, lengths, q_starts, tbl[0][None],
                                              tbl[1][None], boundary_tokens,
                                              **_attn_masks(cfg, window))
        else:
            write_pages(layer, k[0] * keep, v[0] * keep, chunk_ids[key], page_size)
            o = paged_prefill_attention(
                q, layer.k_pages, layer.v_pages, layer.k_scales, layer.v_scales,
                lengths, q_starts, tbl[None], **_attn_masks(cfg, window))
        o = o.transpose(1, 2).reshape(b, C, cfg.num_heads * hd)
        x = _attn_residual(cfg, dense, p, x, o, group)
        x = _mlp_residual(cfg, dense, p, x, group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x[0, last_index], params["lm_head"])[None], cache


def _rope_positions(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE with per-sequence absolute positions. x: [B, H, S, hd];
    positions: [B, S]."""
    return apply_rope(x, theta, positions[:, None, :])


def _rope_single(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE for one token per sequence. x: [B, H, hd]; positions: [B]."""
    return _rope_positions(x[:, :, None, :], positions[:, None], theta)[:, :, 0, :]


def decode_step(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    cache,                    # layer-stacked (or a group dict), updated in place
    tokens: torch.Tensor,     # [B] the tokens just sampled
    positions: torch.Tensor,  # [B] their absolute positions
    page_ids,                 # [B] page receiving each token's K/V
    slots: torch.Tensor,      # [B] slot within that page
    lengths: torch.Tensor,    # [B] context length INCLUDING this token
    tables,                   # [B, max_pages]
    *,
    boundary_tokens: Optional[int] = None,
    group=None,
) -> Tuple[torch.Tensor, Any]:
    """One decode step for a batch of sequences -> (logits [B, vocab], cache).

    A hybrid cache (a group dict, make_cache_hybrid) takes group dicts of
    page_ids and tables (each group has its own pool); slots and lengths
    follow from the positions and are shared. A mixed cache or group
    (make_cache_mixed, make_cache_hybrid_mixed) takes (pid8, pid4) and
    (tables8, tables4) pairs and boundary_tokens: each lane's append goes to
    the pool that owns its position (the other pool's scrap page takes its
    copy) and attention merges the two partials by lse."""
    b = tokens.shape[0]
    hd = cfg.hd
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    stacks = layer_stacks(cfg, cache)
    x = embed_tokens(cfg, params, tokens)[:, None, :]  # [B, 1, hid]
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = _rope_single(q.reshape(b, cfg.num_heads, hd), positions, cfg.rope_theta)
        k = _rope_single(k.reshape(b, cfg.num_kv_heads, hd), positions, cfg.rope_theta)
        v = v.reshape(b, cfg.num_kv_heads, hd)
        stack, li = stacks[i]
        if isinstance(stack, MixedPagedKVState):
            if boundary_tokens is None:
                raise ValueError("a mixed-cache decode step needs boundary_tokens")
            layer = stack.layer(li)
            pid8, pid4 = _g(page_ids, window)
            t8, t4 = _g(tables, window)
            append_tokens_batched_mixed(layer, k, v, positions, boundary_tokens, pid8, pid4,
                                        slots)
            o = mixed_paged_decode_attention(q, layer, lengths, t8, t4, boundary_tokens,
                                             **_attn_masks(cfg, window))
        else:
            append_tokens_batched(stack.layer(li), k, v, _g(page_ids, window), slots)
            o = paged_decode_attention(
                q, stack.k_pages, stack.v_pages, stack.k_scales, stack.v_scales,
                lengths, _g(tables, window), layer=li, **_attn_masks(cfg, window))
        o = o.reshape(b, 1, cfg.num_heads * hd)
        x = _attn_residual(cfg, dense, p, x, o, group)
        x = _mlp_residual(cfg, dense, p, x, group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x[:, 0], params["lm_head"]), cache


def decode_loop(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    cache,                   # layer-stacked (or a group dict)
    tokens: torch.Tensor,    # [B] pending tokens (K/V not yet cached)
    lengths: torch.Tensor,   # [B] context length EXCLUDING the pending token
    tables,                  # [B, max_pages] covering lengths + n_steps slots; hybrid: per group
    generator: Optional[torch.Generator] = None,  # used only when sampling
    *,
    n_steps: int,
    page_size: int,
    sampling: Optional[SamplingParams] = None,
    return_logits: bool = False,
    boundary_tokens: Optional[int] = None,
    group=None,
):
    """Decode `n_steps` tokens per sequence on device: the sampled token
    feeds the next step and each step's (page, slot) comes from the block
    table and the running length. The host pre-reserves the pages. A mixed
    (tables8, tables4) pair picks each lane's pool on the device (below =
    position < boundary_tokens selects which table feeds the append, the
    other pool gets scrap page 0), so a chunk crosses the boundary without
    a host round-trip.

    Returns (tokens [n_steps, B], cache), plus logits [n_steps, B, vocab]
    with return_logits. tokens[i] is the token sampled after the i-th
    cached append."""
    sampling = sampling or SamplingParams()
    toks, lens = tokens, lengths.long()

    def take(t, idx):
        return torch.gather(t.long(), 1, idx.clamp(0, t.shape[1] - 1)[:, None])[:, 0]

    def pids_of(t):
        if not isinstance(t, tuple):
            return take(t, lens // page_size)
        below = lens < boundary_tokens
        return (torch.where(below, take(t[0], lens // page_size), 0),
                torch.where(below, 0, take(t[1], torch.div(lens - boundary_tokens, page_size,
                                                           rounding_mode="floor"))))
    out, all_logits = [], []
    for _ in range(n_steps):
        pids = ({k: pids_of(t) for k, t in tables.items()} if isinstance(tables, dict)
                else pids_of(tables))
        logits, cache = decode_step(cfg, params, cache, toks, lens, pids, lens % page_size,
                                    lens + 1, tables, boundary_tokens=boundary_tokens,
                                    group=group)
        toks = sample(logits, generator, sampling)
        out.append(toks)
        if return_logits:
            all_logits.append(logits)
        lens = lens + 1
    if return_logits:
        return torch.stack(out), cache, torch.stack(all_logits)
    return torch.stack(out), cache


def verify_step(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    cache,                      # layer-stacked (or a group dict), updated in place
    tokens: torch.Tensor,       # [B, S] the pending token + S - 1 draft tokens
    positions0: torch.Tensor,   # [B] absolute position of tokens[:, 0]
    page_sched,                 # [B, S] page receiving token j's K/V; hybrid: per group
    slot_sched: torch.Tensor,   # [B, S] slot within that page
    tables,                     # [B, max_pages]; hybrid: per group
    *,
    page_size: int,
    group=None,
) -> Tuple[torch.Tensor, Any]:
    """Speculative decoding's verification: S tokens a sequence in one
    forward. Their K/V are appended to the paged cache token by token (so
    each page's scale is fitted by its slot-0 token, as plain decode fits
    it; the slots are position-indexed, so a rejected draft's K/V is
    overwritten after the host rolls back), then the queries attend from
    the pages with per-sequence offsets (q_starts = positions0, lengths =
    positions0 + S) through paged_prefill_attention.

    Returns (logits [B, S, vocab], cache)."""
    del page_size
    b, S = tokens.shape
    hd = cfg.hd
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    positions = positions0.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
    lengths = (positions0 + S).to(torch.int32)
    q_starts = positions0.to(torch.int32)
    slot_sched = slot_sched.long()
    stacks = layer_stacks(cfg, cache)
    x = embed_tokens(cfg, params, tokens)  # [B, S, hid]
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = q.reshape(b, S, cfg.num_heads, hd).transpose(1, 2)
        k = k.reshape(b, S, cfg.num_kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, S, cfg.num_kv_heads, hd).transpose(1, 2)
        q = _rope_positions(q, positions, cfg.rope_theta)
        k = _rope_positions(k, positions, cfg.rope_theta)
        stack, li = stacks[i]
        if isinstance(stack, MixedPagedKVState):
            raise ValueError("verify_step takes plain INT8 caches (speculation refuses mixed_kv)")
        layer = stack.layer(li)
        psched = _g(page_sched, window)
        for j in range(S):
            append_tokens_batched(layer, k[:, :, j], v[:, :, j], psched[:, j], slot_sched[:, j])
        o = paged_prefill_attention(
            q, layer.k_pages, layer.v_pages, layer.k_scales, layer.v_scales,
            lengths, q_starts, _g(tables, window), **_attn_masks(cfg, window))
        o = o.transpose(1, 2).reshape(b, S, cfg.num_heads * hd)
        x = _attn_residual(cfg, dense, p, x, o, group)
        x = _mlp_residual(cfg, dense, p, x, group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x, params["lm_head"]), cache


# --- Mixed-precision KV (INT8 sinks + INT4 bulk, serving/mixed_kv.py) -------
#
# Positions below boundary_tokens live in an INT8 page pool, the rest
# nibble-packed INT4; attention merges the two partial softmaxes exactly by
# lse. The uniform-pattern cache below needs one window for every layer
# (hybrid pools put the split on the full group: make_cache_hybrid_mixed).

def ensure_mixed_supported(cfg: LlamaConfig) -> None:
    if len(set(cfg.layer_windows)) != 1:
        raise ValueError(
            "mixed KV needs a uniform window pattern (hybrid_kv covers per-layer "
            "patterns: make_cache_hybrid_mixed)")


def make_cache_mixed(cfg: LlamaConfig, n8_pages: int, n4_pages: int, page_size: int,
                     subs: int = 4, device="cuda") -> MixedPagedKVState:
    """Layer-stacked MixedPagedKVState (leading num_layers dim)."""
    ensure_serving_supported(cfg)
    ensure_mixed_supported(cfg)
    return MixedPagedKVState.create(cfg.num_kv_heads, n8_pages, n4_pages, page_size, cfg.hd,
                                    subs, num_layers=cfg.num_layers, device=device)


def write_prefill_mixed(
    cfg: LlamaConfig,
    cache: MixedPagedKVState,  # layer-stacked
    k_all: torch.Tensor,       # [L, Hkv, n_tokens, hd]
    v_all: torch.Tensor,
    page_ids8: torch.Tensor,   # [p8] the prompt's below-boundary pages
    page_ids4: torch.Tensor,   # [p4] the rest (p8 + p4 pages in all)
    *,
    page_size: int,
) -> MixedPagedKVState:
    """write_prefill for the mixed cache, all layers."""
    del page_size
    for i in range(cfg.num_layers):
        write_pages_mixed(cache.layer(i), k_all[i], v_all[i], page_ids8, page_ids4)
    return cache
