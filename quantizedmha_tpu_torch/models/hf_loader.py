"""HuggingFace safetensors -> the port's Llama params (counterpart of
quantizedmha_tpu/models/hf_loader.py).

Maps a HF Llama / Mistral / Qwen2 / Gemma-2 checkpoint directory
(config.json + *.safetensors [+ model.safetensors.index.json]) onto the
parameter dict `models/llama.py` uses, with:

  * the HF tensor names (model.layers.{i}.self_attn.q_proj...), Gemma-2's
    sandwich norms among them;
  * the RoPE convention: HF stores q/k projections permuted for rotate-half
    RoPE; the port rotates interleaved (even, odd) pairs
    (reference/mha.apply_rope), so q/k rows are unpermuted on load;
  * optional INT8 per-output-channel or INT4 group-wise quantization on
    load (quant/weights.quantize_weight / quantize_weight4) of every
    projection; norms, embedding and lm_head stay float;
  * optional shard-on-load for tensor parallelism (`mesh`): each leaf is
    cut by serving.sharded.tp_param_specs as it is read, layer by layer, so
    a rank never holds the whole model.

Files are read with utils/safetensors_io (no `safetensors` package; bf16
through torch). Tensors are views of the mapped files until a layer is
converted to `dtype` on `device`; a float or column-parallel leaf is cut to
the rank's block before that, so the rank reads only its rows. A quantized
row-parallel projection (wo, w_down) is quantized whole a layer at a time
and then cut: its channel scales need every input row.

The card's attention kernels take head_dim 32, 64, 128 and 256: on CUDA,
`load_llama` refuses any other head_dim before it reads a tensor.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.models.llama import LlamaConfig
from quantizedmha_tpu_torch.ops import decode, flash_attention, flash_attention_int8, paged_prefill
from quantizedmha_tpu_torch.parallel.mesh import P
from quantizedmha_tpu_torch.quant.weights import quantize_weight, quantize_weight4
from quantizedmha_tpu_torch.utils.safetensors_io import SafetensorsFile, save_file

# The head dims every attention kernel of the card takes.
CARD_HEAD_DIMS = tuple(sorted(
    set(decode._HEAD_DIMS) & set(paged_prefill._HEAD_DIMS)
    & set(flash_attention._HEAD_DIMS) & set(flash_attention_int8._HEAD_DIMS)))


def _window_pattern_from_hf(cfg: dict, archs: str):
    """(sliding_window, window_pattern) from a HF config dict.

    Configs that carry `layer_types` ("sliding_attention" /
    "full_attention" a layer) give it; otherwise each family's default:
    Qwen2 slides on layers >= max_window_layers (28 when absent), Gemma-2
    slides on its even layers. use_sliding_window=false disables the
    window. A uniform pattern collapses to the one sliding_window."""
    L = cfg["num_hidden_layers"]
    win = cfg.get("sliding_window")
    if not cfg.get("use_sliding_window", True):
        win = None
    layer_types = cfg.get("layer_types")
    if layer_types is None and win is not None:
        if "Qwen2" in archs:
            mwl = cfg.get("max_window_layers", 28)
            layer_types = ["full_attention" if i < mwl else
                           "sliding_attention" for i in range(L)]
        elif "Gemma2" in archs:
            layer_types = ["sliding_attention" if i % 2 == 0 else
                           "full_attention" for i in range(L)]
    if layer_types is None:
        return win, None
    if len(layer_types) != L:
        raise ValueError(
            f"layer_types has {len(layer_types)} entries for {L} layers")
    if win is None and "sliding_attention" in layer_types:
        # Loading those layers as full attention would change the model's
        # masking: refuse.
        raise ValueError(
            "layer_types marks sliding_attention layers but the effective "
            "sliding_window is None (missing, null, or disabled by "
            "use_sliding_window=false)")
    pattern = tuple(
        win if t == "sliding_attention" else None for t in layer_types)
    if len(set(pattern)) == 1:
        return pattern[0], None
    return None, pattern


def config_from_hf(path) -> LlamaConfig:
    """A LlamaConfig from a HF config.json (llama / mistral / qwen2 /
    gemma2 families). Any head_dim is accepted here."""
    cfg = json.loads((pathlib.Path(path) / "config.json").read_text())
    n_heads = cfg["num_attention_heads"]
    archs = " ".join(cfg.get("architectures", []) or [])
    gemma2 = "Gemma2" in archs
    win, pattern = _window_pattern_from_hf(cfg, archs)
    kw = {}
    if gemma2:
        # "gelu" (erf) and "gelu_pytorch_tanh" are different curves: map
        # exactly and refuse anything else.
        act_map = {"gelu_pytorch_tanh": "gelu_tanh", "gelu_tanh": "gelu_tanh",
                   "gelu": "gelu", "silu": "silu"}
        act_hf = cfg.get("hidden_activation", "gelu_pytorch_tanh")
        if act_hf not in act_map:
            raise ValueError(f"unsupported hidden_activation {act_hf!r}")
        kw = dict(
            hidden_act=act_map[act_hf],
            sandwich_norms=True,
            rms_plus_one=True,
            embed_scale=True,
            # transformers' Gemma2Config default is 256, not hidden / heads.
            query_pre_attn_scalar=float(cfg.get("query_pre_attn_scalar", 256)),
            logit_softcap=cfg.get("attn_logit_softcapping"),
            final_logit_softcap=cfg.get("final_logit_softcapping"),
        )
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=n_heads,
        num_kv_heads=cfg.get("num_key_value_heads", n_heads),
        head_dim=cfg.get("head_dim"),
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rms_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        sliding_window=win,
        window_pattern=pattern,
        # Llama configs carry an explicit flag; Qwen2's bias is implicit.
        attention_bias=bool(cfg.get("attention_bias", "Qwen2" in archs)),
        **kw,
    )


class _ShardedReader:
    """Reads tensors by HF name across one or many safetensors files, each
    a CPU tensor viewing its file's map."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._files: Dict[str, SafetensorsFile] = {}
        index = self.path / "model.safetensors.index.json"
        if index.exists():
            self.weight_map = json.loads(index.read_text())["weight_map"]
        else:
            files = sorted(self.path.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"no .safetensors under {self.path}")
            self.weight_map = {}
            for f in files:
                for name in self._file(f.name).keys():
                    self.weight_map[name] = f.name

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(self.path / fname)
        return self._files[fname]

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def get(self, name: str) -> torch.Tensor:
        return self._file(self.weight_map[name]).get(name)


def _unpermute_rope(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """Invert HF's rotate-half permutation of a q/k projection WEIGHT [out,
    in] or BIAS [out] (a bias transforms like a column of W): each head's
    rows (2, hd/2) -> (hd/2, 2), contiguous."""
    if w.ndim == 1:
        return _unpermute_rope(w[:, None], n_heads, head_dim)[:, 0]
    out, inp = w.shape
    return w.reshape(n_heads, 2, head_dim // 2, inp).transpose(1, 2).reshape(out, inp)


def _rank_block(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s contiguous block of `size` along dim (a view)."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"{size} ranks do not evenly divide dim {dim} of size {n}")
    return x.narrow(dim, rank * (n // size), n // size)


def load_llama(
    path,
    cfg: Optional[LlamaConfig] = None,
    *,
    quantize: bool = False,
    quantize_bits: int = 8,
    quantize_group: int = 128,
    mesh=None,
    dtype=None,
    device="cuda",
) -> Dict[str, Any]:
    """Load a HF checkpoint directory into the params dict of
    models.llama (init_params' structure), on `device`.

    quantize: INT8 per-output-channel (QuantizedWeight) or, with
    quantize_bits=4, INT4 in groups of quantize_group input rows
    (QuantizedWeight4, "pairs" packing) for every projection; norms,
    embedding and lm_head stay float. dtype: the float leaves' type
    (cfg.dtype when None). mesh: a DeviceMesh with a "tp" axis, or a
    (rank, size) pair: this rank's shard by serving.sharded.tp_param_specs,
    cut as each layer is read (bit for bit shard_params of the whole
    load). On CUDA a head_dim the card's kernels do not take raises
    NotImplementedError before any tensor is read."""
    cfg = cfg or config_from_hf(path)
    if torch.device(device).type == "cuda" and cfg.hd not in CARD_HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {cfg.hd}: the card's attention kernels take head_dim in "
            f"{CARD_HEAD_DIMS} (ROADMAP.md queue 2, the head-dim rule); load with "
            f"device='cpu' for the plain versions")
    from quantizedmha_tpu_torch.serving.sharded import (
        _axis_coords,
        _cut_leaf,
        _empty_stack,
        _store,
        local_config,
        tp_param_specs,
    )
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    rank, size = (0, 1) if mesh is None else _axis_coords(mesh, "tp")
    if size > 1:
        local_config(cfg, size)  # raises unless size divides the head counts
    specs = tp_param_specs("tp", attention_bias=cfg.attention_bias,
                           sandwich_norms=cfg.sandwich_norms)
    reader = _ShardedReader(path)
    hd = cfg.hd
    heads = {"q": cfg.num_heads, "k": cfg.num_kv_heads}

    def quantized(x: torch.Tensor):
        if quantize_bits == 4:
            return quantize_weight4(x, group=quantize_group)
        return quantize_weight(x)

    def leaf(hf: torch.Tensor, spec, kind: Optional[str] = None, transpose: bool = False,
             quant: bool = False):
        """One layer's (or an unstacked) leaf from its HF tensor: the rank's
        block, unpermuted (kind "q" / "k"), [out, in] -> [in, out]
        (transpose), converted, quantized (quant)."""
        ours = list(spec)  # the leaf's spec in our layout
        cut_hf = [(len(ours) - 1 - d if transpose else d) for d, a in enumerate(ours)
                  if a == "tp"]
        row_cut_quant = quant and ours[0] == "tp"
        local = cut_hf and not row_cut_quant
        if local:
            for d in cut_hf:
                hf = _rank_block(hf, d, rank, size)
        if kind is not None:
            hf = _unpermute_rope(hf, heads[kind] // (size if local else 1), hd)
        # (a copy on the device first, the transpose there: no view of the
        # map outlives the load)
        x = hf.to(device=dev, dtype=dtype, copy=True)
        x = (x.t() if transpose else x).contiguous()
        if not quant:
            return x
        q = quantized(x)
        return _cut_leaf(q, P(*ours), "tp", rank, size) if row_cut_quant else q

    def stacked(name: str, make):
        """A layer-stacked leaf from make(i, layer spec), layer by layer."""
        layer_spec = tuple(specs["layers"][name])[1:]
        first = make(0, layer_spec)
        stack = _empty_stack(cfg.num_layers, first)
        _store(stack, 0, first)
        del first
        for i in range(1, cfg.num_layers):
            _store(stack, i, make(i, layer_spec))
        return stack

    def proj(hf_name: str, kind: Optional[str] = None):
        def make(i, spec):
            return leaf(reader.get(f"model.layers.{i}.{hf_name}.weight"), spec, kind,
                        transpose=True, quant=quantize)
        return make

    def vector(hf_name: str, kind: Optional[str] = None):
        def make(i, spec):
            return leaf(reader.get(f"model.layers.{i}.{hf_name}"), spec, kind)
        return make

    # Norm names: the Llama family's "post_attention_layernorm" is the
    # pre-MLP norm (mlp_norm); Gemma-2's sandwich adds true post-norms and
    # calls the pre-MLP one "pre_feedforward_layernorm".
    mlp_norm_hf = ("pre_feedforward_layernorm" if cfg.sandwich_norms
                   else "post_attention_layernorm")
    makers = dict(
        attn_norm=vector("input_layernorm.weight"),
        wq=proj("self_attn.q_proj", "q"),
        wk=proj("self_attn.k_proj", "k"),
        wv=proj("self_attn.v_proj"),
        wo=proj("self_attn.o_proj"),
        mlp_norm=vector(f"{mlp_norm_hf}.weight"),
        w_gate=proj("mlp.gate_proj"),
        w_up=proj("mlp.up_proj"),
        w_down=proj("mlp.down_proj"),
    )
    if cfg.attention_bias:
        makers.update(bq=vector("self_attn.q_proj.bias", "q"),
                      bk=vector("self_attn.k_proj.bias", "k"),
                      bv=vector("self_attn.v_proj.bias"))
    if cfg.sandwich_norms:
        makers.update(post_attn_norm=vector("post_attention_layernorm.weight"),
                      post_mlp_norm=vector("post_feedforward_layernorm.weight"))
    layers = {name: stacked(name, make) for name, make in makers.items()}

    embed_hf = reader.get("model.embed_tokens.weight")
    embed = leaf(embed_hf, tuple(specs["embed"]))
    # Tied embeddings (Gemma-2, Llama-3.2): the lm_head is embed.T.
    lm_hf = reader.get("lm_head.weight") if "lm_head.weight" in reader else embed_hf
    return dict(
        embed=embed,
        layers=layers,
        final_norm=leaf(reader.get("model.norm.weight"), tuple(specs["final_norm"])),
        lm_head=leaf(lm_hf, tuple(specs["lm_head"]), transpose=True),
    )


def save_llama_synthetic(path, cfg: LlamaConfig, seed: int = 0,
                         shards: int = 1) -> None:
    """Write a synthetic HF-format checkpoint (config.json + safetensors
    [+ index for shards > 1]): the Llama tensor names in float32 from
    np.random.default_rng(seed), q/k rows in HF's rotate-half permutation,
    the same arrays as the JAX package's save_llama_synthetic. The unit
    tests' fixture for load_llama."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    hd = cfg.hd
    rng = np.random.default_rng(seed)

    def permute(w, n_heads):  # the inverse of _unpermute_rope (HF's convert)
        if w.ndim == 1:
            return permute(w[:, None], n_heads)[:, 0]
        out, inp = w.shape
        w = w.reshape(n_heads, hd // 2, 2, inp)
        return np.ascontiguousarray(w.transpose(0, 2, 1, 3)).reshape(out, inp)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    tensors: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": r(cfg.vocab_size, cfg.hidden_size),
        "model.norm.weight": np.ones((cfg.hidden_size,), np.float32),
        "lm_head.weight": r(cfg.vocab_size, cfg.hidden_size),
    }
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        tensors[pre + "input_layernorm.weight"] = np.ones((cfg.hidden_size,), np.float32)
        tensors[pre + "post_attention_layernorm.weight"] = np.ones(
            (cfg.hidden_size,), np.float32)
        tensors[pre + "self_attn.q_proj.weight"] = permute(
            r(cfg.num_heads * hd, cfg.hidden_size), cfg.num_heads)
        tensors[pre + "self_attn.k_proj.weight"] = permute(
            r(cfg.num_kv_heads * hd, cfg.hidden_size), cfg.num_kv_heads)
        tensors[pre + "self_attn.v_proj.weight"] = r(cfg.num_kv_heads * hd, cfg.hidden_size)
        tensors[pre + "self_attn.o_proj.weight"] = r(cfg.hidden_size, cfg.num_heads * hd)
        tensors[pre + "mlp.gate_proj.weight"] = r(cfg.intermediate_size, cfg.hidden_size)
        tensors[pre + "mlp.up_proj.weight"] = r(cfg.intermediate_size, cfg.hidden_size)
        tensors[pre + "mlp.down_proj.weight"] = r(cfg.hidden_size, cfg.intermediate_size)
        if cfg.attention_bias:
            tensors[pre + "self_attn.q_proj.bias"] = permute(
                r(cfg.num_heads * hd), cfg.num_heads)
            tensors[pre + "self_attn.k_proj.bias"] = permute(
                r(cfg.num_kv_heads * hd), cfg.num_kv_heads)
            tensors[pre + "self_attn.v_proj.bias"] = r(cfg.num_kv_heads * hd)

    (p / "config.json").write_text(json.dumps(dict(
        architectures=["LlamaForCausalLM"],
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps,
        sliding_window=cfg.sliding_window,
        attention_bias=cfg.attention_bias,
    )))
    if shards == 1:
        save_file(tensors, p / "model.safetensors")
        return
    names = sorted(tensors)
    per = -(-len(names) // shards)
    weight_map = {}
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        chunk = {n: tensors[n] for n in names[s * per:(s + 1) * per]}
        save_file(chunk, p / fname)
        weight_map.update({n: fname for n in chunk})
    (p / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
