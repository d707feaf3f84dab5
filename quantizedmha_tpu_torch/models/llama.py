"""Llama-3-style decoder on the port's attention kernels (counterpart of
quantizedmha_tpu/models/llama.py).

RMSNorm + interleaved RoPE + GQA attention + SwiGLU MLP, parameters as a
plain dict of layer-stacked tensors (the JAX package's pytree, so
models.convert.params_from_numpy maps one onto the other leaf by leaf).
Layers run in a Python loop. attention_impl "flash_int8" goes through the
fused INT8 kernel and "reference" through the plain golden; "flash" (the
floating-point `_fwd_kernel`) is not ported yet. The JAX package's 8-row
lm_head pad is a TPU lowering trick with bitwise-equal logits and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from quantizedmha_tpu_torch.ops.quantize import true_div
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight, QuantizedWeight4, qdense
from quantizedmha_tpu_torch.reference.mha import apply_rope, mha_masked_reference

_FLASH_TODO = ("attention_impl='flash' needs ops/flash_attention.py's "
               "floating-point _fwd_kernel, not ported yet (ROADMAP.md queue 2 "
               "item 3); use 'flash_int8' or 'reference'")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1408
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attention_impl: str = "flash"  # flash | flash_int8 | reference
    block_q: Optional[int] = None
    block_kv: Optional[int] = None  # int8 K/V quant block (numerics)
    weight_quant_mode: str = "w8a16"
    sliding_window: Optional[int] = None
    logit_softcap: Optional[float] = None
    attention_sinks: int = 0
    attention_bias: bool = False
    window_pattern: Optional[Tuple[Optional[int], ...]] = None
    hidden_act: str = "silu"        # "silu" | "gelu_tanh" | "gelu"
    sandwich_norms: bool = False
    rms_plus_one: bool = False
    embed_scale: bool = False
    query_pre_attn_scalar: Optional[float] = None
    final_logit_softcap: Optional[float] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def layer_windows(self) -> Tuple[Optional[int], ...]:
        """Per-layer window tuple (len num_layers)."""
        if self.window_pattern is not None:
            if len(self.window_pattern) != self.num_layers:
                raise ValueError(
                    f"window_pattern has {len(self.window_pattern)} entries "
                    f"for {self.num_layers} layers")
            return tuple(self.window_pattern)
        return (self.sliding_window,) * self.num_layers

    @property
    def recyclable_window(self) -> Optional[int]:
        """The single window shared by EVERY layer, or None (rolling page
        recycling is sound only when no layer needs pages behind it)."""
        ws = set(self.layer_windows)
        if len(ws) == 1:
            return next(iter(ws))
        return None

    @property
    def sm_scale(self) -> Optional[float]:
        if self.query_pre_attn_scalar is None:
            return None
        return float(self.query_pre_attn_scalar) ** -0.5

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,
        )

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8,
        )

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,
            rope_theta=10000.0, sliding_window=4096,
        )

    @staticmethod
    def qwen2_7b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4,
            rope_theta=1000000.0, attention_bias=True,
        )

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=256000, hidden_size=3584, intermediate_size=14336,
            num_layers=42, num_heads=16, num_kv_heads=8, head_dim=256,
            rope_theta=10000.0,
            window_pattern=tuple(
                4096 if i % 2 == 0 else None for i in range(42)),
            hidden_act="gelu_tanh", sandwich_norms=True, rms_plus_one=True,
            embed_scale=True, query_pre_attn_scalar=256.0,
            logit_softcap=50.0, final_logit_softcap=30.0,
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2,
        )
        base.update(kw)
        return LlamaConfig(**base)


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in the JAX package's layout, made on `device` from
    `generator` (seed 0 when None). Layer matmul weights are drawn one layer
    at a time into their stacked tensor, so no float32 copy of a whole
    stack is ever live. The numbers differ from the JAX package's
    jax.random draws; tests convert JAX parameters with params_from_numpy."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    hd, L, dt = cfg.hd, cfg.num_layers, cfg.dtype

    def dense(shape, scale=None, layers=None):
        scale = scale if scale is not None else shape[0] ** -0.5
        out = torch.empty(((layers,) if layers else ()) + shape, dtype=dt, device=dev)
        for i in range(layers or 1):
            draw = torch.randn(shape, generator=generator, device=dev) * scale
            (out[i] if layers else out).copy_(draw)
        return out

    norm = (torch.zeros if cfg.rms_plus_one else torch.ones)
    h = cfg.hidden_size
    layers = dict(
        attn_norm=norm((L, h), dtype=dt, device=dev),
        wq=dense((h, cfg.num_heads * hd), layers=L),
        wk=dense((h, cfg.num_kv_heads * hd), layers=L),
        wv=dense((h, cfg.num_kv_heads * hd), layers=L),
        wo=dense((cfg.num_heads * hd, h), layers=L),
        mlp_norm=norm((L, h), dtype=dt, device=dev),
        w_gate=dense((h, cfg.intermediate_size), layers=L),
        w_up=dense((h, cfg.intermediate_size), layers=L),
        w_down=dense((cfg.intermediate_size, h), layers=L),
    )
    if cfg.sandwich_norms:
        layers["post_attn_norm"] = norm((L, h), dtype=dt, device=dev)
        layers["post_mlp_norm"] = norm((L, h), dtype=dt, device=dev)
    if cfg.attention_bias:
        layers["bq"] = torch.zeros((L, cfg.num_heads * hd), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((L, cfg.num_kv_heads * hd), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((L, cfg.num_kv_heads * hd), dtype=dt, device=dev)
    return dict(
        embed=dense((cfg.vocab_size, h), scale=0.02),
        layers=layers,
        final_norm=norm((h,), dtype=dt, device=dev),
        lm_head=dense((h, cfg.vocab_size)),
    )


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer i of the layer-stacked parameter dict."""
    return {k: (v.layer(i) if isinstance(v, (QuantizedWeight, QuantizedWeight4)) else v[i])
            for k, v in layers.items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    if plus_one:
        # Gemma convention: scale by (1 + w) in float32, then cast.
        return (normed * (1.0 + w.float())).to(x.dtype)
    return normed.to(x.dtype) * w


def _act(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Gate activation (callers pass float32)."""
    if cfg.hidden_act == "silu":
        return F.silu(x)
    if cfg.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if cfg.hidden_act == "gelu":
        return F.gelu(x)
    raise ValueError(f"unknown hidden_act {cfg.hidden_act!r}")


def _with_bias(out, p: Dict[str, Any], b: str):
    return out + p[b] if b in p else out


def qkv_proj(dense, h, p: Dict[str, Any], w: str, b: str):
    return _with_bias(dense(h, p[w]), p, b)


def qkv_triple(cfg, dense, h, p: Dict[str, Any]):
    """The (q, k, v) flat projections, with optional Qwen2-style biases; one
    matmul when the layer carries a fused `wqkv`
    (quant.weights.fuse_w4_projections), split at static widths."""
    if "wqkv" in p:
        nkv = cfg.num_kv_heads * cfg.hd
        qkv = torch.split(dense(h, p["wqkv"]), (cfg.num_heads * cfg.hd, nkv, nkv), dim=-1)
        return tuple(_with_bias(t, p, b) for t, b in zip(qkv, ("bq", "bk", "bv")))
    return (qkv_proj(dense, h, p, "wq", "bq"),
            qkv_proj(dense, h, p, "wk", "bk"),
            qkv_proj(dense, h, p, "wv", "bv"))


def mlp_gate_up(cfg, dense, h, p: Dict[str, Any]):
    """(pre-activation gate, up) MLP projections, one matmul when the layer
    carries a fused `w_gateup`."""
    if "w_gateup" in p:
        gu = dense(h, p["w_gateup"])
        inter = gu.shape[-1] // 2
        return gu[..., :inter], gu[..., inter:]
    return dense(h, p["w_gate"]), dense(h, p["w_up"])


_UNSET = object()  # sentinel: "use cfg.sliding_window" for window overrides


def check_attention_impl(cfg: LlamaConfig) -> None:
    if cfg.attention_impl == "flash":
        raise NotImplementedError(_FLASH_TODO)
    if cfg.attention_impl not in ("flash_int8", "reference"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


def _attention(cfg: LlamaConfig, q, k, v, *, causal=True, window=_UNSET):
    """k/v may carry num_kv_heads < num_heads (the int8 kernel is GQA-native;
    the golden expands). window: per-layer override, else cfg.sliding_window."""
    if window is _UNSET:
        window = cfg.sliding_window
    window = window if causal else None
    sinks = cfg.attention_sinks if window is not None else 0
    check_attention_impl(cfg)
    if cfg.attention_impl == "flash_int8":
        return flash_attention_int8(
            q, k, v, sm_scale=cfg.sm_scale, causal=causal,
            block_q=cfg.block_q, block_kv=cfg.block_kv,
            window=window, logit_softcap=cfg.logit_softcap,
            attention_sinks=sinks,
        )
    return mha_masked_reference(
        q, k, v, sm_scale=cfg.sm_scale, causal=causal, window=window,
        softcap=cfg.logit_softcap, sinks=sinks)


def decoder_layer(cfg: LlamaConfig, p: Dict[str, Any], x: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  window=_UNSET) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.hd
    plus1 = cfg.rms_plus_one
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps, plus1)
    q, k, v = qkv_triple(cfg, dense, h, p)
    q = q.reshape(b, s, cfg.num_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, cfg.rope_theta, positions)
    k = apply_rope(k, cfg.rope_theta, positions)
    o = _attention(cfg, q, k, v, causal=True, window=window)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
    o = dense(o, p["wo"])
    if cfg.sandwich_norms:
        o = rms_norm(o, p["post_attn_norm"], cfg.rms_eps, plus1)
    x = x + o

    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps, plus1)
    g_pre, up = mlp_gate_up(cfg, dense, h, p)
    gate = _act(cfg, g_pre.float()).to(x.dtype)
    m = dense(gate * up, p["w_down"])
    if cfg.sandwich_norms:
        m = rms_norm(m, p["post_mlp_norm"], cfg.rms_eps, plus1)
    return x + m


def embed_tokens(cfg: LlamaConfig, params: Dict[str, Any],
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        # Gemma scales by sqrt(hidden) rounded to the model dtype.
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype)
    return x


def final_logits(cfg: LlamaConfig, x: torch.Tensor, lm_head) -> torch.Tensor:
    logits = qdense(x, lm_head, mode=cfg.weight_quant_mode).float()
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(true_div(logits, cap)) * cap
    return logits


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: [batch, seq] int -> logits [batch, seq, vocab] f32."""
    x = embed_tokens(cfg, params, tokens)
    for i, window in enumerate(cfg.layer_windows):
        x = decoder_layer(cfg, layer_params(params["layers"], i), x, positions,
                          window=window)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one)
    return final_logits(cfg, x, params["lm_head"])
