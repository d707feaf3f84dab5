"""PyTorch port vs JAX package: w8a8 (weight_quant_mode="w8a8"), INT8
weights with each activation row quantized to int8 by its own max-abs
scale and an int8 x int8 product summed in int32.

qdense is held to JAX's eager qdense bit for bit: the row quantization
divides exactly on both sides (`ops/quantize.py:true_div` here, an eager
XLA division there), both round half to even, the int32 sums are exact and
the two scale products are the same f32 multiplies in the same order.
Inside its jitted model XLA divides by 127 through the reciprocal, so JAX's
forward may sit one int8 step off its eager qdense where x / row_scale
lands within an ulp of a tie; the model is held to a tolerance (below).
The card's product is torch._int_mm; its row padding runs here on the CPU
against the exact plain product."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.quant import weights as tw
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, N = 64, 48


def to_numpy_tree(t):
    if isinstance(t, jw.QuantizedWeight):
        return {"values": np.asarray(t.values), "scale": np.asarray(t.scale)}
    if isinstance(t, dict):
        return {k: to_numpy_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _x(shape, dtype, seed=0):
    """Random rows with one row of zeros (the 1e-8 clamp) and one whose
    max-abs is 127, so row_scale is 1.0 and x / row_scale lands on halves
    (ties rounded to even)."""
    x = np.random.default_rng(seed).normal(0, 2, shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    if flat.shape[0] > 1:
        flat[0] = 0.0
    tie = flat[-1]
    tie[:] = (np.arange(shape[-1]) % 9 - 4) + 0.5
    tie[0] = 127.0
    t = torch.from_numpy(x)
    return t if dtype == "f32" else t.to(torch.bfloat16)


def _jax_row_quant(xj):
    """The JAX package's w8a8 row quantization (quant/weights.py:354-357),
    run eagerly."""
    xf = xj.astype(jnp.float32)
    row_amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    row_scale = jnp.maximum(row_amax, 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / row_scale), -127, 127).astype(jnp.int8), row_scale


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _to_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


@pytest.fixture(scope="module")
def weight():
    w = np.random.default_rng(1).normal(0, 0.1, (K, N)).astype(np.float32)
    return jw.quantize_weight(jnp.asarray(w)), tw.quantize_weight(torch.from_numpy(w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", [(1,), (5,), (33,), (2, 3)])
def test_qdense_w8a8_matches_jax_eager(weight, dtype, lead):
    """Payload, row scales and output equal JAX's eager qdense bit for bit,
    at 1, 5 and 33 rows and 3-D leading dims, f32 and bf16 x."""
    jq, tq = weight
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    x = _x((*lead, K), dtype)
    xj = _to_jax(x)
    xq, row_scale = tw.quantize_rows(x)
    jxq, jrow_scale = _jax_row_quant(xj)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(row_scale.numpy(), np.asarray(jrow_scale))
    got = tw.qdense(x, tq, mode="w8a8")
    want = jw.qdense(xj, jq, mode="w8a8")
    assert got.dtype == x.dtype and got.shape == (*lead, N)
    np.testing.assert_array_equal(got.float().numpy(), _to_np(want))
    if len(lead) == 1 and lead[0] > 1:
        assert not got[0].any()  # the zero row stays zero through the 1e-8 clamp
        tie = xq.reshape(-1, K)[-1, 1:10].tolist()
        assert tie == [-2, -2, 0, 0, 2, 2, 4, 4, -4]  # halves to even


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_close_to_float(mode):
    """tests/test_weight_quant.py:45 on the port."""
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.normal(0, 1, (4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (64, 32)).astype(np.float32))
    got = tw.qdense(x, tw.quantize_weight(w), mode=mode)
    want = x @ w
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 0.03, f"{mode}: rel err {rel}"


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 18, 40])
def test_int_mm_padding_matches_plain(rows):
    """The card's route (torch._int_mm, rows padded with zeros to 17) run on
    the CPU equals the exact plain product, either side of the pad
    threshold, at extreme values."""
    rng = np.random.default_rng(rows)
    xq = torch.from_numpy(rng.integers(-127, 128, (rows, 256)).astype(np.int8))
    xq[0] = 127
    wv = torch.from_numpy(rng.integers(-127, 128, (256, 40)).astype(np.int8))
    wv[:, 0] = 127
    got = tw._int_mm_padded(xq, wv)
    assert got.shape == (rows, 40) and got.dtype == torch.int32
    assert torch.equal(got, tw._w8a8_plain(xq, wv))
    assert int(got[0, 0]) == 127 * 127 * 256


@pytest.mark.parametrize("k, n", [(60, 48), (64, 44)])
def test_int_mm_refuses_shapes_it_cannot_take(k, n):
    """No float fallback: inner or outer dims off a multiple of 8 raise."""
    with pytest.raises(ValueError, match="multiples of 8"):
        tw._int_mm_padded(torch.zeros((4, k), dtype=torch.int8),
                          torch.zeros((k, n), dtype=torch.int8))


@pytest.fixture(scope="module")
def models():
    """A tiny two-layer f32 Llama at w8a8 with flash_int8 attention and an
    INT8 lm_head (lm_head_bits=8: the lm_head's product is w8a8 too), the
    same parameters on both sides, and the float parameters they came
    from."""
    kw = dict(num_layers=2, num_heads=4, num_kv_heads=2, attention_impl="flash_int8",
              weight_quant_mode="w8a8")
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jfloat = jl.init_params(jc, jax.random.PRNGKey(7))
    jp = jw.quantize_llama_params(jfloat, bits=8, lm_head_bits=8)
    return (jc, jp, tc, params_from_numpy(to_numpy_tree(jp), device="cpu"),
            params_from_numpy(to_numpy_tree(jfloat), device="cpu"))


def test_forward_w8a8_close_to_float(models):
    """tests/test_weight_quant.py:162 on the port: top-1 agreement with the
    float model > 0.9."""
    _, _, tc, tp, tfloat = models
    toks = torch.from_numpy(np.random.default_rng(42).integers(0, tc.vocab_size, (1, 32))
                            .astype(np.int32))
    got = tl.forward(tc, tp, toks)
    ref = tl.forward(tc, tfloat, toks)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    assert agree > 0.9, f"top-1 agreement {agree}"


def test_forward_w8a8_matches_jax(models):
    """The port's forward equals JAX's within atol = rtol = 1e-2 on logits of
    std ~1: a one-ulp difference between the frameworks (matmul order,
    exp/pow/cos, XLA's reciprocal for / 127 in the jitted model) can move
    one activation's or P's int8 rounding by a step, a change the size of
    the int8 error itself; the observed difference is far below the bound."""
    jc, jp, tc, tp, _ = models
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    want = np.asarray(jl.forward(jc, jp, jnp.asarray(toks)))
    got = tl.forward(tc, tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert np.abs(got - np.asarray(jl.forward(dataclasses.replace(
        jc, weight_quant_mode="w8a16"), jp, jnp.asarray(toks)))).max() > 1e-3


COUNTERS = ("requests_admitted", "prefill_tokens", "decode_steps", "tokens_generated",
            "requests_finished")


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_w8a8_streams_match_jax(models, chunk):
    """Three requests on two lanes (bucketed prefill, paged INT8 decode,
    continuous batching) at w8a8: greedy streams and counters equal
    JAX's."""
    jc, jp, tc, tp, _ = models
    base = dict(num_pages=16, page_size=16, max_batch=2, max_pages_per_seq=16,
                prefill_buckets=(128, 256), max_new_tokens=6, decode_chunk=chunk)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist() for n in (20, 100, 150)]
    jeng = JEngine(jc, jp, JEngineConfig(**base))
    teng = Engine(tc, tp, EngineConfig(**base), device="cpu")
    for p in prompts:
        jeng.add_request(p)
        teng.add_request(p)
    want, got = jeng.run(), teng.run()
    assert got == want
    assert {c: teng.metrics.counter(c) for c in COUNTERS} == \
        {c: jeng.metrics.counter(c) for c in COUNTERS}
    assert teng.alloc.free_pages == 15
