"""Llama-3-style decoder on the port's attention kernels (counterpart of
quantizedmha_tpu/models/llama.py).

RMSNorm + interleaved RoPE + GQA attention + SwiGLU MLP, parameters as a
plain dict of layer-stacked tensors (the JAX package's pytree, so
models.convert.params_from_numpy maps one onto the other leaf by leaf).
Layers run in a Python loop. attention_impl "flash" (the default) goes
through the float FlashAttention kernel, "flash_int8" through the fused
INT8 kernel and "reference" through the plain golden. The JAX package's 8-row
lm_head pad is a TPU lowering trick with bitwise-equal logits and has no
counterpart here. `loss_fn` and `sgd_train_step` train through the flash
kernel's backward (or autograd of the golden); the INT8 kernel raises
under grad, as its JAX counterpart does. `param_shardings` gives the
("dp", "tp") training layout as PartitionSpecs; serving.sharded.shard_params
cuts a rank's shard by it.

Training across ranks (`sgd_train_step(..., mesh=)`): Megatron's tensor
parallelism over "tp" and data parallelism over "dp", with the gradient
convention of parallel/combine.py. Each tp rank runs the layers on its
heads and MLP columns (`local_config`): the inputs of the column-parallel
products (wq / wk / wv, w_gate / w_up, the vocab-sharded lm_head) enter
through `copy_to_group`, whose backward all-reduces their gradient, and
the row-parallel products' outputs (wo, w_down) leave through
`reduce_from_group`, an all-reduce in cfg.dtype. The loss over the whole
vocabulary is a vocab-parallel log-softmax (`_vocab_parallel_nll`): the
logits stay sharded, one all-reduce MAX of the detached row maxima and one
all-reduce SUM of each row's [sum of exp | target logit] give every rank
the loss, with no all-gather of the logits. Then every gradient is
averaged over "dp" (`_dp_average`: one flattened all-reduce a dtype).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
from quantizedmha_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from quantizedmha_tpu_torch.ops.quantize import true_div
from quantizedmha_tpu_torch.parallel.combine import copy_to_group, reduce_from_group
from quantizedmha_tpu_torch.parallel.mesh import P
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight, QuantizedWeight4, qdense
from quantizedmha_tpu_torch.reference.mha import apply_rope, mha_masked_reference

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
    block_kv: Optional[int] = None  # numerics: int8 quant block, softmax step
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
    jax.random draws; tests convert JAX parameters with params_from_numpy.
    device="meta" gives the tree's shapes and dtypes and allocates nothing
    (the abstract parameters that sharding plans are sized from)."""
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if generator is None and not meta:
        generator = torch.Generator(device=dev).manual_seed(0)
    hd, L, dt = cfg.hd, cfg.num_layers, cfg.dtype

    def dense(shape, scale=None, layers=None):
        scale = scale if scale is not None else shape[0] ** -0.5
        out = torch.empty(((layers,) if layers else ()) + shape, dtype=dt, device=dev)
        for i in range(0 if meta else layers or 1):
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


def param_shardings(cfg: LlamaConfig) -> Dict[str, Any]:
    """PartitionSpecs for a ("dp", "tp") mesh: attention heads and the MLP
    hidden dim cut over "tp" (Megatron column / row parallel), the lm_head
    over its vocab columns, everything else replicated (JAX
    models/llama.py:211). The row-parallel products (wo, w_down) need an
    all-reduce after them (serving.llama_adapter's `group`)."""
    layer = dict(
        attn_norm=P(None, None),
        wq=P(None, None, "tp"),
        wk=P(None, None, "tp"),
        wv=P(None, None, "tp"),
        wo=P(None, "tp", None),
        mlp_norm=P(None, None),
        w_gate=P(None, None, "tp"),
        w_up=P(None, None, "tp"),
        w_down=P(None, "tp", None),
    )
    if cfg.sandwich_norms:
        layer["post_attn_norm"] = P(None, None)
        layer["post_mlp_norm"] = P(None, None)
    if cfg.attention_bias:
        # biases shard with their projection's output (column) dim
        layer["bq"] = P(None, "tp")
        layer["bk"] = P(None, "tp")
        layer["bv"] = P(None, "tp")
    return dict(
        embed=P(None, None),
        layers=layer,
        final_norm=P(None),
        lm_head=P(None, "tp"),
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
    if cfg.attention_impl not in ("flash", "flash_int8", "reference"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


def _attention(cfg: LlamaConfig, q, k, v, *, causal=True, window=_UNSET):
    """k/v may carry num_kv_heads < num_heads (both kernels are GQA-native;
    the golden expands). window: per-layer override, else cfg.sliding_window."""
    if window is _UNSET:
        window = cfg.sliding_window
    window = window if causal else None
    sinks = cfg.attention_sinks if window is not None else 0
    check_attention_impl(cfg)
    if cfg.attention_impl == "flash":
        return flash_attention(
            q, k, v, sm_scale=cfg.sm_scale, causal=causal,
            block_q=cfg.block_q, block_kv=cfg.block_kv,
            window=window, logit_softcap=cfg.logit_softcap,
            attention_sinks=sinks,
        )
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


def _tp_in(h: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel product's input under tensor parallelism."""
    return h if group is None else copy_to_group(h, group)


def _tp_out(y: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel product's output under tensor parallelism: the ranks'
    partial sums added, in y's dtype."""
    return y if group is None else reduce_from_group(y, group)


def decoder_layer(cfg: LlamaConfig, p: Dict[str, Any], x: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  window=_UNSET, group=None) -> torch.Tensor:
    """One decoder layer. group: the tensor-parallel process group (p this
    rank's shard, cfg its local_config), or None."""
    b, s, _ = x.shape
    hd = cfg.hd
    plus1 = cfg.rms_plus_one
    dense = functools.partial(qdense, mode=cfg.weight_quant_mode)
    h = _tp_in(rms_norm(x, p["attn_norm"], cfg.rms_eps, plus1), group)
    q, k, v = qkv_triple(cfg, dense, h, p)
    q = q.reshape(b, s, cfg.num_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, cfg.rope_theta, positions)
    k = apply_rope(k, cfg.rope_theta, positions)
    o = _attention(cfg, q, k, v, causal=True, window=window)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * hd)
    o = _tp_out(dense(o, p["wo"]), group)
    if cfg.sandwich_norms:
        o = rms_norm(o, p["post_attn_norm"], cfg.rms_eps, plus1)
    x = x + o

    h = _tp_in(rms_norm(x, p["mlp_norm"], cfg.rms_eps, plus1), group)
    g_pre, up = mlp_gate_up(cfg, dense, h, p)
    gate = _act(cfg, g_pre.float()).to(x.dtype)
    m = _tp_out(dense(gate * up, p["w_down"]), group)
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
            positions: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """tokens: [batch, seq] int -> logits [batch, seq, vocab] f32. group:
    the tensor-parallel group (params this rank's shard, cfg its
    local_config): the logits are this rank's vocabulary columns."""
    x = embed_tokens(cfg, params, tokens)
    for i, window in enumerate(cfg.layer_windows):
        x = decoder_layer(cfg, layer_params(params["layers"], i), x, positions,
                          window=window, group=group)
    x = _tp_in(rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.rms_plus_one), group)
    return final_logits(cfg, x, params["lm_head"])


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, group) -> torch.Tensor:
    """The mean negative log-likelihood of `targets` under the softmax over
    the whole vocabulary, from each rank's contiguous block of its columns
    (logits [..., V / tp] f32): log_softmax's formula (the shift a constant)
    with the row max, the sum of exp and the target's logit reduced over
    the group."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    v_local = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    shifted = logits - m[..., None]
    local = targets.long() - rank * v_local
    inside = (local >= 0) & (local < v_local)
    picked = shifted.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    sums = reduce_from_group(torch.stack([shifted.exp().sum(dim=-1),
                                          torch.where(inside, picked, torch.zeros_like(picked))],
                                         dim=-1), group)
    return -(sums[..., 1] - torch.log(sums[..., 0])).mean()


def loss_fn(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            group=None) -> torch.Tensor:
    """Next-token cross-entropy (shifted): log_softmax of the f32 logits,
    the target's entry, minus the mean. group: the tensor-parallel group
    (the vocab-parallel form, _vocab_parallel_nll)."""
    logits = forward(cfg, params, tokens, group=group)[:, :-1]
    if group is not None:
        return _vocab_parallel_nll(logits, tokens[:, 1:], group)
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def float_leaves(params: Dict[str, Any]) -> Dict[str, Any]:
    """params with every float tensor an autograd leaf that shares its
    storage, each layer-stacked tensor split into a list of one leaf a
    layer (layer_params indexes it as it indexes the stack). A layer's leaf
    is a detached view of its row, so its gradient is that layer's alone
    (the backward of a select on a stacked leaf would write a zero-filled
    gradient of the whole stack for every layer), and an in-place update of
    a leaf writes the stack. Quantized weights hold no float leaf and raise,
    as jax.value_and_grad refuses integer leaves."""
    for v in list(params["layers"].values()) + [params[k] for k in params if k != "layers"]:
        if isinstance(v, (QuantizedWeight, QuantizedWeight4)) or not v.is_floating_point():
            raise TypeError(
                "sgd_train_step differentiates float parameters only: quantized "
                "weights hold integer leaves (jax.value_and_grad refuses them too)")
    leaves = {k: v.detach().requires_grad_() for k, v in params.items() if k != "layers"}
    leaves["layers"] = {k: [row.detach().requires_grad_() for row in v.unbind(0)]
                        for k, v in params["layers"].items()}
    return leaves


def _leaf_list(leaves: Dict[str, Any]):
    return [v for k, v in leaves.items() if k != "layers"] + [
        p for rows in leaves["layers"].values() for p in rows]


def _dp_average(leaves, loss: torch.Tensor, group) -> torch.Tensor:
    """Every leaf's gradient averaged over the data-parallel `group` (the
    global mean loss is the mean of the ranks' equal-sized means), in one
    flattened all-reduce a dtype; the loss rides in the float32 buffer (a
    buffer of its own when no gradient is float32). Returns the global
    loss."""
    size = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in leaves:
        if p.grad is None:  # a leaf the loss does not reach: zero gradient
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    by_dtype.setdefault(torch.float32, [])
    for dtype, ps in by_dtype.items():
        parts = [p.grad.reshape(-1) for p in ps]
        if dtype == torch.float32:
            parts.append(loss.detach().reshape(1).float())
        flat = torch.cat(parts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(torch.tensor(float(size), dtype=dtype, device=flat.device))
        sizes = [p.numel() for p in ps]
        for p, g in zip(ps, flat[:sum(sizes)].split(sizes)):
            p.grad = g.view_as(p.grad)
        if dtype == torch.float32:
            loss = flat[-1]
    return loss


def sgd_train_step(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
                   lr: float = 1e-3, *, mesh=None) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One SGD step: the loss and the gradient of every float leaf, then p
    <- p - lr * g in the parameter's dtype, lr rounded to that dtype first
    (JAX's weakly typed Python float becomes a constant of the leaf's dtype,
    as scaled_q rounds sm_scale). Unlike JAX's fresh pytree, the update is
    in place: the same dict comes back, its tensors updated (no second copy
    of the weights). Raises on quantized weights.

    mesh: a ("dp", "tp") DeviceMesh (parallel.distributed.hybrid_mesh) for
    training across ranks: params are this rank's shards
    (serving.sharded.shard_params(params, param_shardings(cfg), mesh)) and
    tokens this dp rank's rows, an equal share of the global batch. The
    step runs tensor-parallel over "tp" and averages the gradients over
    "dp" (module docstring); it returns the global batch's loss, and each
    rank's update is its shard of JAX's step on the whole batch. None: one
    process, as before."""
    leaves = float_leaves(params)
    if mesh is None:
        loss = loss_fn(cfg, leaves, tokens)
    else:
        from quantizedmha_tpu_torch.serving.sharded import local_config
        tp = mesh.get_group("tp")
        loss = loss_fn(local_config(cfg, dist.get_world_size(tp)), leaves, tokens, group=tp)
    loss.backward()
    if mesh is not None:
        loss = _dp_average(_leaf_list(leaves), loss, mesh.get_group("dp"))
    with torch.no_grad():
        for p in _leaf_list(leaves):
            if p.grad is None:  # a leaf the loss does not reach: zero gradient
                continue
            p.sub_(torch.tensor(lr, dtype=p.dtype, device=p.device) * p.grad.to(p.dtype))
    return params, loss.detach()
