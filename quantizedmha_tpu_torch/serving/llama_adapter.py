"""Llama model adapter for the serving engine: prefill + paged decode
(counterpart of the plain-cache half of quantizedmha_tpu/serving/llama_adapter.py).

  - prefill: causal attention over the (right-padded) prompt through the
    fused INT8 kernel; returns the per-layer K/V (post-RoPE) for cache
    insertion plus the logits of the last real token.
  - decode_step: one token per sequence: project q/k/v, RoPE at the
    absolute position, append K/V to the paged INT8 cache in place, attend
    with ops.decode.paged_decode_attention.
  - decode_loop: n_steps of decode_step with on-device sampling feeding
    the next step, no host round-trip per token.

The cache is layer-stacked ([num_layers, ...] tensors); each layer works on
views of its slice. Not ported yet: chunked prefill and speculative verify
(ops/paged_prefill.py), the hybrid and mixed-precision caches, tensor and
context parallelism.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

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
from quantizedmha_tpu_torch.quant.weights import qdense
from quantizedmha_tpu_torch.reference.mha import apply_rope
from quantizedmha_tpu_torch.serving.kv_cache import (
    PagedKVCacheState,
    append_tokens_batched,
    write_pages,
)
from quantizedmha_tpu_torch.serving.sampling import SamplingParams, sample


def ensure_serving_supported(cfg: LlamaConfig) -> None:
    """Validate the knob values early (at cache creation, not mid-step)."""
    check_attention_impl(cfg)
    _act(cfg, torch.zeros(1))  # raises on an unknown hidden_act
    cfg.layer_windows  # raises on a mis-sized window_pattern


def _attn_residual(cfg: LlamaConfig, dense, p, x, o_flat):
    o = dense(o_flat.to(cfg.dtype), p["wo"])
    if cfg.sandwich_norms:
        o = rms_norm(o, p["post_attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return x + o


def _mlp_residual(cfg: LlamaConfig, dense, p, x):
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps, cfg.rms_plus_one)
    g_pre, up = mlp_gate_up(cfg, dense, h, p)
    gate = _act(cfg, g_pre.float()).to(x.dtype)
    m = dense(gate * up, p["w_down"])
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


def prefill_at(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
               last_index):
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
        x = _attn_residual(cfg, dense, p, x, o)
        x = _mlp_residual(cfg, dense, p, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    # Project ONLY the requested position (the full [n, vocab] logits would
    # be discarded but for one row).
    logits = final_logits(cfg, x[:, last_index], params["lm_head"])
    return logits, torch.stack(k_all), torch.stack(v_all)


def prefill(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor):
    """tokens: [1, n] -> (last_logits [1, vocab], k_all, v_all [L, Hkv, n, hd])."""
    return prefill_at(cfg, params, tokens, tokens.shape[1] - 1)


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


def _rope_single(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE for one token per sequence. x: [B, H, hd]; positions: [B]."""
    return apply_rope(x[:, :, None, :], theta, positions[:, None, None])[:, :, 0, :]


def decode_step(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    cache: PagedKVCacheState,  # layer-stacked, updated in place
    tokens: torch.Tensor,     # [B] the tokens just sampled
    positions: torch.Tensor,  # [B] their absolute positions
    page_ids: torch.Tensor,   # [B] page receiving each token's K/V
    slots: torch.Tensor,      # [B] slot within that page
    lengths: torch.Tensor,    # [B] context length INCLUDING this token
    tables: torch.Tensor,     # [B, max_pages]
) -> Tuple[torch.Tensor, PagedKVCacheState]:
    """One decode step for a batch of sequences -> (logits [B, vocab], cache)."""
    b = tokens.shape[0]
    hd = cfg.hd
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    x = embed_tokens(cfg, params, tokens)[:, None, :]  # [B, 1, hid]
    for i, window in enumerate(cfg.layer_windows):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.rms_plus_one)
        q, k, v = qkv_triple(cfg, dense, h, p)
        q = _rope_single(q.reshape(b, cfg.num_heads, hd), positions, cfg.rope_theta)
        k = _rope_single(k.reshape(b, cfg.num_kv_heads, hd), positions, cfg.rope_theta)
        v = v.reshape(b, cfg.num_kv_heads, hd)
        append_tokens_batched(cache.layer(i), k, v, page_ids, slots)
        o = paged_decode_attention(
            q, cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
            lengths, tables, sm_scale=cfg.sm_scale, window=window,
            logit_softcap=cfg.logit_softcap,
            attention_sinks=cfg.attention_sinks if window is not None else 0,
            layer=i,
        )
        o = o.reshape(b, 1, cfg.num_heads * hd)
        x = _attn_residual(cfg, dense, p, x, o)
        x = _mlp_residual(cfg, dense, p, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x[:, 0], params["lm_head"]), cache


def decode_loop(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    cache: PagedKVCacheState,  # layer-stacked
    tokens: torch.Tensor,    # [B] pending tokens (K/V not yet cached)
    lengths: torch.Tensor,   # [B] context length EXCLUDING the pending token
    tables: torch.Tensor,    # [B, max_pages] covering lengths + n_steps slots
    generator: Optional[torch.Generator] = None,  # used only when sampling
    *,
    n_steps: int,
    page_size: int,
    sampling: Optional[SamplingParams] = None,
    return_logits: bool = False,
):
    """Decode `n_steps` tokens per sequence on device: the sampled token
    feeds the next step and each step's (page, slot) comes from the block
    table and the running length. The host pre-reserves the pages.

    Returns (tokens [n_steps, B], cache), plus logits [n_steps, B, vocab]
    with return_logits. tokens[i] is the token sampled after the i-th
    cached append."""
    sampling = sampling or SamplingParams()
    toks, lens = tokens, lengths.long()
    tables_l = tables.long()
    out, all_logits = [], []
    for _ in range(n_steps):
        pids = torch.gather(tables_l, 1, (lens // page_size)[:, None])[:, 0]
        logits, cache = decode_step(cfg, params, cache, toks, lens, pids,
                                    lens % page_size, lens + 1, tables)
        toks = sample(logits, generator, sampling)
        out.append(toks)
        if return_logits:
            all_logits.append(logits)
        lens = lens + 1
    if return_logits:
        return torch.stack(out), cache, torch.stack(all_logits)
    return torch.stack(out), cache
