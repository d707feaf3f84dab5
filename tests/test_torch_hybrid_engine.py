"""PyTorch port vs JAX package: the engine's hybrid_kv pools (one page pool
and block table a window group, serving/engine.py build_pools), on tiny
f32 models with window patterns, page 4, attention_impl="reference".

One engine schedule runs in both packages (JAX's Pallas in interpret mode)
at decode_chunk 1 and 4, and so does the Gemma-2 knob set, hybrid on and
off: greedy streams and counters equal. The other cases hold the port's
hybrid engine to the port's own shared-pool engine, which the existing
engine tests hold to JAX's: a page's contents do not depend on its id, so
the streams are equal token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.quant.weights import quantize_llama_params
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from test_torch_hybrid_cache import PAGE, hybrid_models, numpy_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

COUNTERS = ("requests_admitted", "prefill_tokens", "prefix_cache_hits",
            "prefix_tokens_reused", "pages_trimmed", "decode_steps")
BASE = dict(num_pages=64, page_size=PAGE, max_batch=2, max_pages_per_seq=16,
            prefill_buckets=(8, 16), max_new_tokens=8)


def _serve(engine_cls, cfg, params, prompts, **kw):
    """Drive one engine through the prompts, all queued at once: (streams,
    counters, engine)."""
    base = dict(BASE, **kw)
    if engine_cls is JEngine:
        eng = JEngine(cfg, params, JEngineConfig(**base))
    else:
        eng = Engine(cfg, params, EngineConfig(**base), device="cpu")
    for p in prompts:
        eng.add_request(list(p))
    out = eng.run()
    return out, {c: eng.metrics.counter(c) for c in COUNTERS}, eng


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, n).tolist() for n in lengths]


@pytest.fixture(scope="module")
def gemma_pattern():
    return hybrid_models((8, None, 8, None))


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_engine_hybrid_matches_jax(gemma_pattern, decode_chunk):
    """Prompts of 5, 9 and 14 tokens through a sliding pool of 24 pages
    and a full one of 64: streams, trims and counters equal JAX's, and the
    streams equal the port's shared-pool engine's."""
    jc, jp, tc, tp = gemma_pattern
    prompts = _prompts(0, (5, 9, 14))
    kw = dict(decode_chunk=decode_chunk, hybrid_kv=True, hybrid_pages={"w8": 24, "full": 64})
    want, jcount, jeng = _serve(JEngine, jc, jp, prompts, **kw)
    got, tcount, eng = _serve(Engine, tc, tp, prompts, **kw)
    assert eng.hybrid and jeng.hybrid and set(eng.allocs) == {"w8", "full"}
    assert got == want and tcount == jcount
    assert tcount["pages_trimmed"] > 0
    shared, _, _ = _serve(Engine, tc, tp, prompts, decode_chunk=decode_chunk)
    assert shared == got
    for a in eng.allocs.values():
        assert not a.tables and a.free_pages == a.num_pages - 1


@pytest.mark.parametrize("hybrid", [False, True])
def test_engine_serves_gemma2_knobs_like_jax(hybrid):
    """The whole Gemma-2 knob set (pattern (8, None), sandwich norms, (1+w)
    RMSNorm, GeGLU with tanh GELU, scaled embeddings, query_pre_attn_scalar,
    attention and final-logit softcaps) through the engine, hybrid pools on
    and off: streams and counters equal JAX's. Parameters from numpy, so
    every norm is off its initial value."""
    kw = dict(num_heads=4, num_kv_heads=2, sandwich_norms=True, rms_plus_one=True,
              hidden_act="gelu_tanh", embed_scale=True, query_pre_attn_scalar=32.0,
              logit_softcap=30.0, final_logit_softcap=30.0)
    jc, jp, tc, tp = hybrid_models((8, None), seed=12, **kw)
    prompts = _prompts(1, (12, 7))
    ekw = dict(hybrid_kv=hybrid, hybrid_pages={"w8": 16} if hybrid else None)
    want, jcount, _ = _serve(JEngine, jc, jp, prompts, **ekw)
    got, tcount, eng = _serve(Engine, tc, tp, prompts, **ekw)
    assert eng.hybrid == hybrid
    assert got == want and tcount == jcount
    assert all(len(v) == BASE["max_new_tokens"] for v in got.values())


def test_engine_hybrid_sliding_pool_stays_small(gemma_pattern):
    """A sliding pool far too small for the generations untrimmed (8 pages
    with the scrap page; two sequences of 8 + 24 tokens would hold 16)
    serves them: trims keep each sequence's sliding pages within the window,
    the full pool is never trimmed, and the streams equal the shared
    pool's."""
    _, _, tc, tp = gemma_pattern
    prompts = _prompts(1, (8, 7))
    kw = dict(max_new_tokens=24)
    live = []

    class Watched(Engine):
        def _trim_windows(self):
            super()._trim_windows()
            if self.hybrid:
                live.extend(sum(p is not None for p in self.allocs["w8"].tables[s.seq_id])
                            for s in self.active)
                assert all(p is not None for t in self.allocs["full"].tables.values()
                           for p in t)
    eng = Watched(tc, tp, EngineConfig(**dict(BASE, hybrid_kv=True,
                                              hybrid_pages={"w8": 8, "full": 64}, **kw)),
                  device="cpu")
    for p in prompts:
        eng.add_request(p)
    got = eng.run()
    assert all(len(v) == 24 for v in got.values())
    assert eng.metrics.counter("pages_trimmed") > 0
    assert max(live) <= -(-(8 + PAGE) // PAGE) + 1
    shared, _, _ = _serve(Engine, tc, tp, prompts, **kw)
    assert shared == got


def test_engine_hybrid_prefix_cache_shares_window_tail():
    """prefix_cache with hybrid_kv: a request sharing a 4-page prefix reuses
    the full group's pages outright and the sliding group's only across
    the window tail (older slots ride the scrap page), the same white-box
    probe as the JAX package's test; stream A equals the engine without the
    prefix cache, B has its length; every map and pool drains."""
    _, _, tc, tp = hybrid_models((8, None, 8, None), seed=2)
    prefix = np.random.default_rng(3).integers(1, 200, 16).tolist()
    pa, pb = prefix + [5, 6], prefix + [9, 10, 11]
    ecfg = dict(BASE, num_pages=64, max_new_tokens=4, hybrid_kv=True,
                hybrid_pages={"w8": 24, "full": 32})

    def drive(prefix_cache, probe=None):
        eng = Engine(tc, tp, EngineConfig(**ecfg, prefix_cache=prefix_cache), device="cpu")
        eng.add_request(list(pa))
        eng.step()  # admit A and decode once: the window still covers the tail
        if probe is not None:
            probe(eng)
        eng.add_request(list(pb))
        return eng.run(), eng

    def probe(eng):
        cached = eng._resolve_prefix(list(pb))
        assert set(cached) == {"w8", "full"}
        assert cached["full"] == eng.allocs["full"].tables[0][:4]
        assert [p is None for p in cached["w8"]] == [True, True, False, False]
        assert cached["w8"][2:] == eng.allocs["w8"].tables[0][2:4]

    want, _ = drive(False)
    got, eng = drive(True, probe)
    assert eng.metrics.counter("prefix_cache_hits") == 1
    assert eng.metrics.counter("prefix_tokens_reused") == 16
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    assert not eng._prefix_map and not eng._page_hash
    for a in eng.allocs.values():
        assert not a.tables


def test_engine_hybrid_uniform_config_is_noop():
    """hybrid_kv on a uniform pattern stays one shared pool, as in JAX."""
    _, _, tc, tp = hybrid_models((8, 8))
    eng = Engine(tc, tp, EngineConfig(**dict(BASE, num_pages=16, hybrid_kv=True)),
                 device="cpu")
    assert not eng.hybrid and eng.allocs is None
    rid = eng.add_request([1, 2, 3])
    assert len(eng.run()[rid]) == BASE["max_new_tokens"]


def test_engine_hybrid_pool_errors(gemma_pattern):
    """An unknown hybrid_pages key raises; an admission that one pool
    cannot hold fails that request without taking pages from the other."""
    _, _, tc, tp = gemma_pattern
    with pytest.raises(ValueError, match="match no window group"):
        Engine(tc, tp, EngineConfig(**dict(BASE, hybrid_kv=True, hybrid_pages={"w4": 8})),
               device="cpu")
    eng = Engine(tc, tp, EngineConfig(**dict(BASE, hybrid_kv=True,
                                             hybrid_pages={"w8": 3, "full": 64})),
                 device="cpu")
    with pytest.raises(RuntimeError, match=r"group\(s\) \['w8'\]"):
        eng._admit_all(0, 12)
    assert all(not a.tables for a in eng.allocs.values())
    assert eng.allocs["full"].free_pages == 63


@pytest.mark.parametrize("margin", [0, 6])
def test_trim_windows_margin_matches_jax(gemma_pattern, margin):
    """_trim_windows(margin) on a 30-token sequence admitted into the
    hybrid pools (no trim at admission): the tables left in each group,
    the free counts and pages_trimmed equal JAX's; margin keeps its
    positions alive behind the window besides."""
    jc, jp, tc, tp = gemma_pattern
    cfg = dict(BASE, hybrid_kv=True)
    engines = (JEngine(jc, jp, JEngineConfig(**cfg)),
               Engine(tc, tp, EngineConfig(**cfg), device="cpu"))
    kept = []
    for eng in engines:
        eng._admit_all(0, 30)
        eng.active = [type("Seq", (), {"seq_id": 0})()]
        eng._trim_windows(margin)
        kept.append(({k: list(a.tables[0]) for k, a in eng.allocs.items()},
                     {k: a.free_pages for k, a in eng.allocs.items()},
                     eng.metrics.counter("pages_trimmed")))
    assert kept[0] == kept[1]
    live = sum(p is not None for p in kept[1][0]["w8"])
    assert live == len({p // PAGE for p in range(30 - 8 - margin, 30)})


def test_hybrid_engine_composes_with_w4_weights():
    """INT4 weights (group 32) with hybrid pools: the streams equal the
    shared-pool w4 engine's."""
    _, _, tc, tp = hybrid_models((8, None, 8, None))
    tp4 = quantize_llama_params(tp, bits=4, group=32)
    prompts = _prompts(5, (6, 9))
    got, _, eng = _serve(Engine, tc, tp4, prompts, hybrid_kv=True, hybrid_pages={"w8": 24})
    assert eng.hybrid and all(len(v) == BASE["max_new_tokens"] for v in got.values())
    shared, _, _ = _serve(Engine, tc, tp4, prompts)
    assert shared == got


def test_numpy_params_reach_both_packages():
    """numpy_params gives both packages the same numbers."""
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, window_pattern=(8, None))
    tree = numpy_params(jc, 0)
    tp = params_from_numpy(tree, device="cpu")
    flat, tflat = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(tp)
    assert len(flat) == len(tflat) > 0
    for a, b in zip(flat, tflat):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.fixture(scope="module")
def spec_hybrid():
    """Greedy speculation over hybrid pools on both sides (a pattern target
    and a pattern draft): JAX's SpecDecodeEngine at k = 3, and the port's
    plain shared-pool engine on the same prompts."""
    from quantizedmha_tpu.serving.speculative import SpecConfig as JSpecConfig
    from quantizedmha_tpu.serving.speculative import SpecDecodeEngine as JSpecDecodeEngine
    target = hybrid_models((8, None, 8, None))
    draft = hybrid_models((8, None), seed=7)
    prompts = _prompts(5, (6, 9))
    kw = dict(BASE, max_new_tokens=10, hybrid_kv=True, hybrid_pages={"w8": 24})
    jeng = JSpecDecodeEngine(target[0], target[1], draft[0], draft[1], JEngineConfig(**kw),
                             JSpecConfig(num_draft_tokens=3))
    for p in prompts:
        jeng.add_request(list(p))
    plain, _, _ = _serve(Engine, target[2], target[3], prompts, max_new_tokens=10)
    return target, draft, prompts, kw, jeng.run(), plain


@pytest.mark.parametrize("k", [1, 3, 5])
def test_spec_engine_composes_with_hybrid(spec_hybrid, k):
    """Greedy speculation over a hybrid-pool target and a hybrid-pool draft
    emits the plain shared-pool engine's tokens and JAX's speculative
    engine's, at every k: speculation is lossless and the pools' layout
    invisible. Both sides' sliding groups trim and every pool drains."""
    from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine
    target, draft, prompts, kw, want, plain = spec_hybrid
    eng = SpecDecodeEngine(target[2], target[3], draft[2], draft[3], EngineConfig(**kw),
                           SpecConfig(num_draft_tokens=k), device="cpu")
    assert eng.hybrid and eng.draft_hybrid
    assert set(eng.allocs) == set(eng.draft_allocs) == {"w8", "full"}
    for p in prompts:
        eng.add_request(list(p))
    got = eng.run()
    assert got == want and got == plain
    assert eng.metrics.counter("pages_trimmed") > 0
    for a in list(eng.allocs.values()) + list(eng.draft_allocs.values()):
        assert not a.tables and a.free_pages == a.num_pages - 1
