"""PyTorch port vs JAX package: the HF checkpoint loader
(models/hf_loader.py) and its safetensors reader (utils/safetensors_io.py).

- config_from_hf gives JAX's LlamaConfig field by field (the dtype as its
  torch counterpart) for llama, mistral, qwen2 and gemma2 config.json's,
  defaults and refusals included;
- a checkpoint written by JAX's save_llama_synthetic (one file, and three
  shards with an index) loads bit for bit as JAX's load_llama loads it, in
  bf16 and in f32, quantized to INT8 (values, scales) and to INT4 (packed,
  scales at group 32);
- the port's save_llama_synthetic writes JAX's arrays, which
  safetensors.safe_open and JAX's loader read;
- a bf16 checkpoint written by safetensors.torch.save_file reads as JAX
  reads it;
- logits of checkpoints that transformers writes (save_pretrained, random
  weights, no download) match transformers' own forward within rtol = atol
  = 2e-3, the bound of the JAX package's tests/test_hf_loader.py, for
  Llama, Qwen2 with a per-layer window and Gemma-2 (port forwards only);
- shard-on-load at tp = 2 (INT8 and INT4) equals shard_params of the whole
  load, and each rank holds the replicated bytes plus the sharded bytes / tp;
- a head_dim-96 checkpoint is refused on CUDA by the head-dim rule before
  any tensor is read (no GPU needed)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import hf_loader as jh
from quantizedmha_tpu.models.llama import LlamaConfig as JConfig
from quantizedmha_tpu_torch.models import hf_loader as th
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight, QuantizedWeight4
from quantizedmha_tpu_torch.serving.sharded import expand_param_specs, shard_params, tp_param_specs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = JConfig.tiny(num_layers=2, head_dim=16)
LOGIT_TOL = 2e-3

# --- config_from_hf ----------------------------------------------------------

_BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, head_dim=8, rope_theta=10000.0,
             rms_norm_eps=1e-6)
_GEMMA = dict(_BASE, architectures=["Gemma2ForCausalLM"], sliding_window=16)
_QWEN = dict(_BASE, architectures=["Qwen2ForCausalLM"])
CONFIGS = {
    "llama": dict(_BASE, architectures=["LlamaForCausalLM"], attention_bias=False),
    "llama_no_kv_heads_no_head_dim": {k: v for k, v in _BASE.items()
                                      if k not in ("num_key_value_heads", "head_dim")},
    "mistral_window": dict(_BASE, architectures=["MistralForCausalLM"], sliding_window=16),
    "qwen2_bias_implicit": dict(_QWEN, use_sliding_window=False, sliding_window=16),
    "qwen2_max_window_layers_default_28": dict(_QWEN, use_sliding_window=True,
                                               sliding_window=16),
    "qwen2_max_window_layers_1": dict(_QWEN, use_sliding_window=True, sliding_window=16,
                                      max_window_layers=1),
    "qwen2_layer_types": dict(_QWEN, sliding_window=16, layer_types=[
        "full_attention", "sliding_attention", "full_attention", "full_attention"]),
    "gemma2_defaults": _GEMMA,
    "gemma2_gelu_erf": dict(_GEMMA, hidden_activation="gelu"),
    "gemma2_explicit": dict(_GEMMA, hidden_activation="gelu_pytorch_tanh",
                            query_pre_attn_scalar=16, attn_logit_softcapping=50.0,
                            final_logit_softcapping=30.0),
    "refuse_gemma2_relu6": dict(_GEMMA, hidden_activation="relu6"),
    "refuse_sliding_without_window": dict(_QWEN, layer_types=[
        "sliding_attention", "full_attention", "full_attention", "full_attention"]),
    "refuse_sliding_window_disabled": dict(_QWEN, sliding_window=16, use_sliding_window=False,
                                           layer_types=["sliding_attention"] * 4),
    "refuse_layer_types_length": dict(_QWEN, sliding_window=16,
                                      layer_types=["sliding_attention"] * 3),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_from_hf_matches_jax(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(CONFIGS[name]))
    if name.startswith("refuse"):
        with pytest.raises(ValueError) as want:
            jh.config_from_hf(tmp_path)
        with pytest.raises(ValueError) as got:
            th.config_from_hf(tmp_path)
        assert str(got.value) == str(want.value)
        return
    want, got = jh.config_from_hf(tmp_path), th.config_from_hf(tmp_path)
    assert _fields(got) == _fields(want)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16


# --- loads bit for bit -------------------------------------------------------

def _assert_tree_equal(jtree, ttree, path=""):
    """A JAX params tree against the port's, leaf by leaf, bit for bit."""
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for k in ttree:
            _assert_tree_equal(jtree[k], ttree[k], f"{path}/{k}")
        return
    if isinstance(ttree, QuantizedWeight):
        pairs = ((jtree.values, ttree.values), (jtree.scale, ttree.scale))
    elif isinstance(ttree, QuantizedWeight4):
        assert (jtree.group, jtree.packing) == (ttree.group, ttree.packing), path
        pairs = ((jtree.packed, ttree.packed), (jtree.scale, ttree.scale))
    else:
        assert str(ttree.dtype).split(".")[-1] == jnp.dtype(jtree.dtype).name, path
        pairs = ((jtree, ttree),)
    for j, t in pairs:
        assert tuple(t.shape) == tuple(j.shape), path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32), err_msg=path)


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    for shards in (1, 3):
        jh.save_llama_synthetic(root / f"s{shards}", CFG, seed=0, shards=shards)
    return root


LOADS = {  # (shards, load_llama keywords)
    "single_bf16": (1, {}),
    "sharded_f32": (3, dict(dtype="f32")),
    "single_int8": (1, dict(quantize=True)),
    "sharded_int4_g32": (3, dict(quantize=True, quantize_bits=4, quantize_group=32)),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_matches_jax_bit_for_bit(jax_ckpts, name):
    shards, kw = LOADS[name]
    path = jax_ckpts / f"s{shards}"
    assert (path / "model.safetensors.index.json").exists() == (shards > 1)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("dtype") == "f32":
        jkw["dtype"], tkw["dtype"] = jnp.float32, torch.float32
    want = jh.load_llama(path, CFG, **jkw)
    got = th.load_llama(path, th.config_from_hf(path), device="cpu", **tkw)
    _assert_tree_equal(want, got)


def test_synthetic_writer_matches_jax(tmp_path):
    """The port's writer: JAX's arrays for the same seed (safe_open reads
    both), and JAX's loader reads the port's files as its own."""
    from safetensors import safe_open

    cfg = JConfig.tiny(num_layers=2, head_dim=16, attention_bias=True)
    tcfg = tl.LlamaConfig.tiny(num_layers=2, head_dim=16, attention_bias=True)
    jh.save_llama_synthetic(tmp_path / "jax", cfg, seed=3, shards=3)
    th.save_llama_synthetic(tmp_path / "port", tcfg, seed=3, shards=3)
    assert (json.loads((tmp_path / "jax" / "config.json").read_text())
            == json.loads((tmp_path / "port" / "config.json").read_text()))
    index = [json.loads((tmp_path / d / "model.safetensors.index.json").read_text())
             for d in ("jax", "port")]
    assert index[0] == index[1]
    for name, fname in index[0]["weight_map"].items():
        with safe_open(tmp_path / "jax" / fname, framework="numpy") as a, \
                safe_open(tmp_path / "port" / fname, framework="numpy") as b:
            np.testing.assert_array_equal(b.get_tensor(name), a.get_tensor(name), err_msg=name)
    import jax
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32),
                                                            np.asarray(b, np.float32)),
                 jh.load_llama(tmp_path / "port", cfg), jh.load_llama(tmp_path / "jax", cfg))


def test_bf16_checkpoint_reads_as_jax_reads_it(jax_ckpts, tmp_path):
    """Real checkpoints are bf16: the JAX package reads them through
    ml_dtypes, the port through torch; written by safetensors.torch."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    src = jax_ckpts / "s1"
    tensors = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in load_file(src / "model.safetensors").items()}
    tensors.pop("lm_head.weight")  # tied: the loaders fall back to embed.T
    save_file(tensors, tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text((src / "config.json").read_text())
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jh.load_llama(tmp_path, CFG, dtype=jdt)
        got = th.load_llama(tmp_path, th.config_from_hf(tmp_path), dtype=tdt, device="cpu")
        _assert_tree_equal(want, got)
        assert torch.equal(got["lm_head"], got["embed"].T)


def test_unpermute_rope_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2 * 16, 24)).astype(np.float32)
    b = rng.standard_normal(2 * 16).astype(np.float32)
    for x in (w, b):
        np.testing.assert_array_equal(th._unpermute_rope(torch.from_numpy(x), 2, 16).numpy(),
                                      jh._unpermute_rope(x, 2, 16))


# --- logits against transformers --------------------------------------------

def _hf_checkpoint(tmp_path, family, seed):
    """(path, transformers' logits) of a tiny random model of `family`
    saved with save_pretrained, and the tokens."""
    # transformers' torch models alone: importing TensorFlow beside them
    # took about half of transformers' import time.
    os.environ.setdefault("USE_TF", "0")
    tfs = pytest.importorskip("transformers")
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
                  rms_norm_eps=1e-5)
    if family == "llama":
        model = tfs.LlamaForCausalLM(tfs.LlamaConfig(
            num_hidden_layers=2, tie_word_embeddings=False, **common))
    elif family == "qwen2_window":
        model = tfs.Qwen2ForCausalLM(tfs.Qwen2Config(
            num_hidden_layers=3, tie_word_embeddings=False, use_sliding_window=True,
            sliding_window=4, max_window_layers=1, **common))
    else:
        model = tfs.Gemma2ForCausalLM(tfs.Gemma2Config(
            num_hidden_layers=4, head_dim=16, sliding_window=4, query_pre_attn_scalar=16.0,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0, **common))
    torch.manual_seed(seed)
    model = model.eval().float()
    for p in model.parameters():  # random weights, norms off their initial values
        torch.nn.init.normal_(p, std=0.1 if p.dim() == 1 else 0.05)
    model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    tokens = torch.tensor([[5, 10, 20, 40, 80, 33, 66, 99]])
    with torch.no_grad():
        want = model(tokens).logits
    return tmp_path / "hf", tokens, want


@pytest.mark.parametrize("family,pattern", [("llama", None), ("qwen2_window", (None, 4, 4)),
                                            ("gemma2", (4, None, 4, None))])
def test_logits_match_transformers(tmp_path, family, pattern):
    path, tokens, want = _hf_checkpoint(tmp_path, family, seed=len(family))
    cfg = th.config_from_hf(path)
    assert cfg.window_pattern == pattern
    cfg = dataclasses.replace(cfg, dtype=torch.float32, attention_impl="reference")
    params = th.load_llama(path, cfg, dtype=torch.float32, device="cpu")
    got = tl.forward(cfg, params, tokens)
    torch.testing.assert_close(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


# --- shard on load -----------------------------------------------------------

def _bytes(tree, specs=None, tp=1):
    """The bytes of a params tree; with specs, a rank's share of them under
    tp: each leaf's bytes / tp where its spec names "tp", else all."""
    if isinstance(tree, dict):
        return sum(_bytes(tree[k], None if specs is None else specs[k], tp) for k in tree)
    if isinstance(tree, (QuantizedWeight, QuantizedWeight4)):
        fields = ("values", "scale") if isinstance(tree, QuantizedWeight) else ("packed", "scale")
        return sum(_bytes(getattr(tree, f), None if specs is None else getattr(specs, f), tp)
                   for f in fields)
    n = tree.numel() * tree.element_size()
    return n // tp if specs is not None and "tp" in tuple(specs) else n


@pytest.mark.parametrize("bits", [8, 4])
def test_shard_on_load_equals_shard_params(jax_ckpts, bits):
    """Each rank's leaves are shard_params' of the whole load, and it holds
    the replicated bytes plus the sharded bytes / tp."""
    path = jax_ckpts / "s3"
    cfg = th.config_from_hf(path)
    kw = dict(quantize=True, quantize_bits=bits, quantize_group=32, device="cpu")
    whole = th.load_llama(path, cfg, **kw)
    specs = tp_param_specs("tp")
    share = _bytes(whole, expand_param_specs(whole, specs), 2)
    assert share < _bytes(whole)
    for rank in range(2):
        got = th.load_llama(path, cfg, mesh=(rank, 2), **kw)
        _assert_shards_equal(got, shard_params(whole, specs, (rank, 2)))
        assert _bytes(got) == share


def _assert_shards_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_shards_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, QuantizedWeight):
        assert torch.equal(got.values, want.values) and torch.equal(got.scale, want.scale), path
    elif isinstance(want, QuantizedWeight4):
        assert torch.equal(got.packed, want.packed) and torch.equal(got.scale, want.scale), path
    else:
        assert torch.equal(got, want), path


# --- the head-dim rule -------------------------------------------------------

def test_head_dim_96_refused_on_cuda_before_reading(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(dict(
        CONFIGS["llama"], hidden_size=192, num_attention_heads=2, num_key_value_heads=1,
        head_dim=96)))  # no tensors: the rule must fire before any read
    cfg = th.config_from_hf(tmp_path)
    assert cfg.hd == 96 == jh.config_from_hf(tmp_path).hd
    with pytest.raises(NotImplementedError, match="head-dim rule"):
        th.load_llama(tmp_path, device="cuda")
    with pytest.raises(FileNotFoundError):  # on the CPU it goes on to read the files
        th.load_llama(tmp_path, device="cpu")
