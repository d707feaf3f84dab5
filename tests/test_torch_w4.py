"""PyTorch port vs JAX package: INT4 (w4a16) weights, the fused dequant-
matmul's plain version, the model forward and the serving engine with w4
weights, on the same inputs made with numpy.

Tolerances:
  - quantized payloads and scales, dequantization, concat and fusion:
    bit for bit (both divide in f32 and round half to even).
  - w4_matmul with f32 x: rtol = atol = 2e-5, the bound of the JAX
    package's own test of its kernel (tests/test_w4_matmul.py), f32
    summation order.
  - w4_matmul with bf16 x: the port rounds w = q*s to bf16 once; the JAX
    kernel either does the same (its folded branch), dots the exact
    nibbles and scales the partial sums (no rounding of w), or rounds
    (lo+8)*s, a weight at most 8|s| larger (its xsum branch). One bf16
    rounding moves a value by at most 2^-8 of its magnitude (half an ulp of
    an 8-bit significand), so the two differ per element by at most
    2^-8 * sum_k |x_k| (2 |w_k| + 8 s_k), plus one bf16 ulp of the output
    (2^-7 of its magnitude) for the final cast.
  - the model forward: within a quarter of the int8 path's own deviation
    from float attention (test_torch_llama.assert_int8_close's budget).
  - the engine: equal greedy token streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.ops import w4_matmul as jm
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.ops import w4_matmul as tm
from quantizedmha_tpu_torch.quant import weights as tw
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from test_torch_llama import assert_int8_close, to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, shape).astype(np.float32)
    w.flat[rng.integers(0, w.size, 3)] *= 30.0
    w[..., :32, :3] *= 1e-12  # groups at the scale clamp
    return w


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("packing", ["pairs", "halves"])
@pytest.mark.parametrize("shape,group,dtype", [((256, 96), 64, "f32"),
                                               ((3, 256, 64), 32, "f32"),
                                               ((512, 40), 128, "bf16")])
def test_quantize_weight4_bit_exact(packing, shape, group, dtype):
    w = _weights(shape, 0)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    if dtype == "bf16":
        wt, wj = wt.to(torch.bfloat16), wj.astype(jnp.bfloat16)
    t = tw.quantize_weight4(wt, group=group, packing=packing)
    j = jw.quantize_weight4(wj, group=group, packing=packing)
    assert t.packed.dtype == torch.int8 and t.scale.dtype == torch.float32
    assert (t.group, t.packing, t.shape) == (j.group, j.packing, tuple(j.shape))
    _eq(t.packed, j.packed)
    _eq(t.scale, j.scale)
    _eq(tw.dequantize_weight4(t), jw.dequantize_weight4(j))
    lo, hi = tm.unpack_nibbles(t.packed)
    jlo, jhi = jw._unpack_nibbles(j.packed)
    _eq(lo, jlo)
    _eq(hi, jhi)


def test_concat_and_fuse_w4_projections_equal():
    layers = {k: _weights((2, 128, n), i) for i, (k, n) in enumerate(
        (("wq", 64), ("wk", 32), ("wv", 32), ("w_gate", 96), ("w_up", 96), ("wo", 64)))}
    tq = {k: tw.quantize_weight4(torch.from_numpy(v), group=32, packing="halves")
          for k, v in layers.items()}
    jq = {k: jw.quantize_weight4(jnp.asarray(v), group=32, packing="halves")
          for k, v in layers.items()}
    tf, jf = tw.fuse_w4_projections(tq), jw.fuse_w4_projections(jq)
    assert set(tf) == set(jf) == {"wqkv", "w_gateup", "wo"}
    for k in jf:
        _eq(tf[k].packed, jf[k].packed)
        _eq(tf[k].scale, jf[k].scale)
        assert (tf[k].group, tf[k].packing) == (jf[k].group, jf[k].packing)
    parts = [tq["wq"], tq["wk"]]
    _eq(tw.dequantize_weight4(tw.concat_w4(parts)),
        jw.dequantize_weight4(jw.concat_w4([jq["wq"], jq["wk"]])))
    with pytest.raises(ValueError, match="packing"):
        tw.concat_w4([tq["wq"], tw.quantize_weight4(torch.from_numpy(layers["wq"]),
                                                     group=32, packing="pairs")])


def test_halves_packing_needs_whole_scale_groups():
    """in=384, group=128: the second half starts mid-group. The JAX
    package accepts this layout and then miscomputes; the port raises."""
    w = _weights((384, 16), 1)
    with pytest.raises(ValueError, match="halves"):
        tw.quantize_weight4(torch.from_numpy(w), group=128, packing="halves")
    q = tw.quantize_weight4(torch.from_numpy(w), group=128, packing="pairs")
    with pytest.raises(ValueError, match="halves"):
        tm.w4_matmul(torch.ones(1, 384), q.packed, q.scale, group=128, packing="halves")


def bf16_tolerance(x, jq, want):
    """Per-element bound between two bf16 w4 products (module docstring)."""
    w = np.abs(np.asarray(jw.dequantize_weight4(jq)))
    s = np.repeat(np.asarray(jq.scale), jq.group, axis=-2)
    ax = np.abs(np.asarray(x, np.float32))
    return 2.0**-8 * (ax @ (2 * w + 8 * s)) + 2.0**-7 * np.abs(want) + 1e-6 * (ax @ w)


# (packing, group, in): the JAX kernel's unfolded branch (pairs/64,
# halves/64), its exact-lo fold (pairs/32) and its xsum-dot (halves/128 at
# in=2048).
LAYOUTS = [("pairs", 64, 256), ("pairs", 32, 256), ("halves", 64, 256),
           ("halves", 128, 2048)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,layer", [(1, None), (5, 2), (8, 1)])
@pytest.mark.parametrize("packing,group,in_dim", LAYOUTS)
def test_w4_matmul_plain_matches_jax(packing, group, in_dim, rows, layer, dtype):
    rng = np.random.default_rng(rows)
    w = rng.normal(0, 0.1, (3, in_dim, 128)).astype(np.float32)
    x = rng.normal(0, 1, (rows, in_dim)).astype(np.float32)
    jq = jw.quantize_weight4(jnp.asarray(w), group=group, packing=packing)
    tq = tw.quantize_weight4(torch.from_numpy(w), group=group, packing=packing)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    if layer is None:
        jq = dataclasses.replace(jq, packed=jq.packed[0], scale=jq.scale[0])
        tq = tq.layer(0)
    kw = dict(group=group, packing=packing)
    want = jm.w4_matmul(xj, jq.packed, jq.scale, **kw,
                        **({} if layer is None else {"layer": jnp.int32(layer)}))
    got = tm.w4_matmul(xt, tq.packed, tq.scale, layer=layer, **kw)
    assert got.dtype == tdt and got.shape == (rows, 128)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        return
    if layer is not None:
        jq = dataclasses.replace(jq, packed=jq.packed[layer], scale=jq.scale[layer])
    tol = bf16_tolerance(xj.astype(jnp.float32), jq, want)
    err = np.abs(got.float().numpy() - want)
    assert (err <= tol).all(), float((err / tol).max())


def _planted_plain(x, q, fault):
    """The plain version of a halves-packed product with one fault planted:
    the hi plane reading the next scale group, the lo plane's +8 storage
    bias left in, or split-K chunk 1 of the kernel's split dropped."""
    k2, n = q.packed.shape
    gn = q.scale.shape[0]
    lo, hi = tm.unpack_nibbles(q.packed)
    s_lo, s_hi = q.scale[:gn // 2], q.scale[gn // 2:]
    if fault == "hi_group":
        s_hi = torch.roll(s_hi, -1, dims=0)
    if fault == "lo_bias":
        lo = q.packed & 15
    w_lo, w_hi = ((p.float().reshape(-1, q.group, n) * s[:, None, :]).to(x.dtype).float()
                  .reshape(k2, n) for p, s in ((lo, s_lo), (hi, s_hi)))
    if fault == "chunk":
        chunk, splits = tm.split_k(x.shape[0], k2, n)
        assert splits > 2
        w_lo[chunk:2 * chunk] = 0
        w_hi[chunk:2 * chunk] = 0
    return (x[:, :k2].float() @ w_lo + x[:, k2:].float() @ w_hi).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_w4_check_holds_jax_and_catches_faults(dtype):
    """chip_smoke.py holds the CUDA kernel to the plain version within the
    f32 summation order plus one ulp of the output. With f32 x the JAX
    kernel (xsum-dot branch here), an independent implementation, must
    pass it; the plain version with a planted fault must fail it by > 5x."""
    import chip_smoke

    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.05, (2048, 256)).astype(np.float32)
    x = rng.normal(0, 1, (8, 2048)).astype(np.float32)
    tq = tw.quantize_weight4(torch.from_numpy(w), group=128, packing="halves")
    xt = torch.from_numpy(x).to(dtype)
    plain = tm.w4_matmul(xt, tq.packed, tq.scale, group=128, packing="halves")
    tol = chip_smoke.w4_tolerance(xt, tq, plain)
    if dtype == torch.float32:
        jq = jw.quantize_weight4(jnp.asarray(w), group=128, packing="halves")
        want = jm.w4_matmul(jnp.asarray(x), jq.packed, jq.scale, group=128, packing="halves")
        assert chip_smoke.err_over_tol(torch.from_numpy(np.array(want)), plain, tol) <= 1.0
    golden = xt.float() @ tw.dequantize_weight4(tq)
    assert chip_smoke.err_over_tol(
        plain, golden, chip_smoke.w4_tolerance(xt, tq, golden, golden=True)) <= 1.0
    for fault in ("hi_group", "lo_bias", "chunk"):
        assert chip_smoke.err_over_tol(_planted_plain(xt, tq, fault), plain, tol) > 5.0, fault


def test_w4_matmul_argument_checks():
    q = tw.quantize_weight4(torch.ones(2, 64, 8), group=16)
    with pytest.raises(ValueError, match="layer"):
        tm.w4_matmul(torch.ones(2, 64), q.packed, q.scale, group=16)
    with pytest.raises(ValueError, match="layer"):
        tm.w4_matmul(torch.ones(2, 64), q.packed[0], q.scale[0], group=16, layer=0)
    with pytest.raises(ValueError, match="in_dim"):
        tm.w4_matmul(torch.ones(2, 32), q.packed, q.scale, group=16, layer=0)
    with pytest.raises(ValueError, match="packing"):
        tm.w4_matmul(torch.ones(2, 64), q.packed, q.scale, group=16, layer=0, packing="x")


@pytest.mark.parametrize("rows", [64, 65])
def test_qdense_routes_by_rows_and_matches_jax(rows, monkeypatch):
    """<= 64 rows go to w4_matmul, more to the dequantize-then-matmul
    prefill lowering; both agree with JAX's _w4a16 at the threshold."""
    rng = np.random.default_rng(9)
    w = rng.normal(0, 0.1, (256, 96)).astype(np.float32)
    x = rng.normal(0, 1, (1, rows, 256)).astype(np.float32)
    jq = jw.quantize_weight4(jnp.asarray(w), group=64, packing="halves")
    tq = tw.quantize_weight4(torch.from_numpy(w), group=64, packing="halves")
    calls = []
    real = tw.w4_matmul
    monkeypatch.setattr(tw, "w4_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tw.qdense(torch.from_numpy(x), tq)
    assert len(calls) == (1 if rows <= 64 else 0)
    want = np.asarray(jw._w4a16(jnp.asarray(x), jq))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="layer view"):
        tw.qdense(torch.from_numpy(x), tw.quantize_weight4(torch.ones(2, 256, 8), group=64))


def _w4_pair(packing, seed=1):
    kw = dict(num_layers=2, num_heads=4, num_kv_heads=2, attention_impl="flash_int8")
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jp = jw.quantize_llama_params(jl.init_params(jc, jax.random.PRNGKey(seed)), bits=4,
                                  group=32, packing=packing, lm_head_bits=8)
    jp = dict(jp, layers=jw.fuse_w4_projections(jp["layers"]))
    return jc, jp, tc, params_from_numpy(to_numpy_tree(jp), device="cpu")


def test_quantize_llama_params_bits4_matches_jax():
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=2)
    jp = jl.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    jq = jw.quantize_llama_params(jp, bits=4, group=32, packing="halves", lm_head_bits=8)
    tq = tw.quantize_llama_params(tp, bits=4, group=32, packing="halves", lm_head_bits=8)
    for k in jw._LAYER_MATMULS:
        assert isinstance(tq["layers"][k], tw.QuantizedWeight4)
        _eq(tq["layers"][k].packed, jq["layers"][k].packed)
        _eq(tq["layers"][k].scale, jq["layers"][k].scale)
    _eq(tq["lm_head"].values, jq["lm_head"].values)
    assert tw.weight_bytes(tq) == jw.weight_bytes(jq)


@pytest.mark.parametrize("packing,shape", [("halves", (1, 40)), ("pairs", (2, 48))])
def test_forward_w4_fused_matches_jax(packing, shape):
    """(1, 40): 40 rows per matmul, the w4_matmul side of the threshold;
    (2, 48): 96 rows, the prefill lowering."""
    jc, jp, tc, tp = _w4_pair(packing)
    assert "wqkv" in tp["layers"] and "w_gateup" in tp["layers"]
    assert tw.weight_bytes(tp) == jw.weight_bytes(jp)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, shape).astype(np.int32)
    assert_int8_close(tl.forward(tc, tp, torch.from_numpy(toks)).numpy(), jc, jp, toks)


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_w4_greedy_streams_match_jax(chunk):
    """Continuous batching (3 requests, 2 lanes) of a w4 model with fused
    projections and an int8 lm_head: equal greedy streams."""
    jc, jp, tc, tp = _w4_pair("halves", seed=7)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist() for n in (20, 100, 150)]
    kw = dict(num_pages=16, page_size=16, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(128, 256), max_new_tokens=6, decode_chunk=chunk)
    jeng = JEngine(jc, jp, JEngineConfig(**kw))
    for p in prompts:
        jeng.add_request(p)
    want = jeng.run()
    eng = Engine(tc, tp, EngineConfig(**kw), device="cpu")
    rids = [eng.add_request(p) for p in prompts]
    got = eng.run()
    assert got == want and not eng.failed
    assert all(len(got[r]) == 6 for r in rids)
