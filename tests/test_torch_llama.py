"""PyTorch port vs JAX package: the Llama model forward with INT8 (w8a16)
weights and the fused INT8 attention, from the SAME parameters (the JAX
params tree, converted with models.convert.params_from_numpy).

Tolerance on the logits: both models compute in f32, but matmul summation
order and exp/pow/cos ulps differ between the frameworks, and a 1-ulp
difference in an activation can flip one int8 rounding of Q, K, V or P —
a change the size of the int8 quantization error itself. So the bound is
relative to that error: the port may differ from JAX by at most a quarter
of the largest deviation of JAX's int8 model from the same model with the
float attention golden on the same tokens (measured: ~0.01 against a
budget of ~0.1, logits of std ~1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.quant import weights as tw


def to_numpy_tree(t):
    """The JAX params tree as nested dicts of numpy arrays."""
    if isinstance(t, jw.QuantizedWeight):
        return {"values": np.asarray(t.values), "scale": np.asarray(t.scale)}
    if isinstance(t, jw.QuantizedWeight4):
        return {"packed": np.asarray(t.packed), "scale": np.asarray(t.scale),
                "group": t.group, "packing": t.packing}
    if isinstance(t, dict):
        return {k: to_numpy_tree(v) for k, v in t.items()}
    return np.asarray(t)


# Tiny configs: head_dim 32 takes the bf16-P numerics of the transposed
# route; head_dim 128 (causal) the int8-P standard route, the one the
# Llama-3-8B path uses.
CONFIGS = {
    "d32": dict(num_layers=2, num_heads=4, num_kv_heads=2),
    "d128": dict(num_layers=2, hidden_size=512, num_heads=4, num_kv_heads=2,
                 intermediate_size=512),
}


def _pair(name, impl="flash_int8", quantize=True, seed=1, **extra):
    kw = dict(CONFIGS[name], attention_impl=impl, **extra)
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jp = jl.init_params(jc, jax.random.PRNGKey(seed))
    if quantize:
        jp = jw.quantize_llama_params(jp, bits=8)
    return jc, jp, tc, params_from_numpy(to_numpy_tree(jp), device="cpu")


def assert_int8_close(got, jc, jp, toks):
    """got (port logits) vs JAX's int8 forward, within a quarter of the
    int8 path's own deviation from float attention (module docstring)."""
    want = np.asarray(jl.forward(jc, jp, jnp.asarray(toks)))
    ref_cfg = dataclasses.replace(jc, attention_impl="reference")
    budget = float(np.abs(want - np.asarray(jl.forward(ref_cfg, jp, jnp.asarray(toks)))).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 0.25 * budget, (err, budget)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_int8_matches_jax(name):
    jc, jp, tc, tp = _pair(name)
    assert tc.hd == (32 if name == "d32" else 128)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 48)).astype(np.int32)
    got = tl.forward(tc, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 48, jc.vocab_size)
    assert_int8_close(got.numpy(), jc, jp, toks)


@pytest.mark.parametrize("extra", [dict(sliding_window=12, attention_sinks=2),
                                   dict(attention_bias=True, logit_softcap=30.0)])
def test_forward_knobs_match_jax(extra):
    jc, jp, tc, tp = _pair("d32", **extra)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (1, 40)).astype(np.int32)
    assert_int8_close(tl.forward(tc, tp, torch.from_numpy(toks)).numpy(), jc, jp, toks)


def test_forward_reference_attention_float_weights_match_jax():
    """No int8 anywhere: the plain golden attention and float weights agree
    to f32 summation order."""
    jc, jp, tc, tp = _pair("d32", impl="reference", quantize=False)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (1, 24)).astype(np.int32)
    want = np.asarray(jl.forward(jc, jp, jnp.asarray(toks)))
    got = tl.forward(tc, tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rms_norm_and_qdense_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (3, 64)).astype(np.float32)
    w = rng.normal(0, 1, (64,)).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)
    wm = rng.normal(0, 0.1, (64, 32)).astype(np.float32)
    tq = tw.quantize_weight(torch.from_numpy(wm))
    jq = jw.quantize_weight(jnp.asarray(wm))
    np.testing.assert_allclose(tw.qdense(torch.from_numpy(x), tq).numpy(),
                               np.asarray(jw.qdense(jnp.asarray(x), jq)), rtol=1e-5, atol=1e-5)


def test_params_from_numpy_keeps_structure_and_bytes():
    jc, jp, tc, tp = _pair("d32")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    assert isinstance(tp["layers"]["wq"], tw.QuantizedWeight)
    assert tw.weight_bytes(tp) == jw.weight_bytes(jp)


def test_init_params_shapes_match_jax():
    jc = jl.LlamaConfig.tiny(attention_bias=True)
    tc = tl.LlamaConfig.tiny(attention_bias=True)
    jp = jax.eval_shape(lambda: jl.init_params(jc, jax.random.PRNGKey(0)))
    tp = tl.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    flat = lambda t: {k: (flat(v) if isinstance(v, dict) else tuple(v.shape))  # noqa: E731
                      for k, v in t.items()}
    assert flat(tp) == flat(jp)
    assert tp["embed"].dtype == torch.bfloat16


def test_unported_paths_raise():
    _, _, tc, tp = _pair("d32", impl="flash")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.forward(tc, tp, torch.zeros((1, 4), dtype=torch.int32))
    q = tw.quantize_weight(torch.ones(4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tw.qdense(torch.ones(1, 4), q, mode="w8a8")
