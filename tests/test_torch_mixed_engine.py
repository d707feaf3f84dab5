"""PyTorch port vs JAX package: the engine's mixed-precision KV mode
(EngineConfig.mixed_kv: INT8 pages below the boundary, INT4 past it, the
partial softmaxes merged by lse) on a tiny f32 Llama with float weights and
the default attention_impl="flash", page 4, buckets (8, 16): the cases of
the JAX package's tests/test_mixed_engine.py. JAX runs its Pallas kernels
in interpret mode; the port runs their plain versions.

Greedy token streams and the engines' counters must be equal (the CPU
comparison of tests/test_torch_engine.py: a 1-ulp f32 difference would
have to flip a quantization rounding and then a greedy choice). Each JAX
engine runs once per module (fixtures)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PAGE = 4
COUNTERS = ("requests_admitted", "prefill_tokens", "prefill_chunks_interleaved",
            "pages_trimmed", "decode_steps", "tokens_generated")
MIXED = {"boundary_tokens": 8, "int8_pages": 8, "int4_pages": 16}


def _models(**cfg_kw):
    jc = jl.LlamaConfig.tiny(num_layers=2, dtype=jnp.float32, **cfg_kw)
    tc = tl.LlamaConfig.tiny(num_layers=2, dtype=torch.float32, **cfg_kw)
    jp = jl.init_params(jc, jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _ecfg(cls, mixed=None, **kw):
    base = dict(num_pages=32, page_size=PAGE, max_batch=2, prefill_buckets=(8, 16),
                max_new_tokens=6, max_pages_per_seq=8)
    base.update(kw)
    return cls(**base, mixed_kv=mixed)


def _serve(engine_cls, cfg, params, prompts, mixed=None, **kw):
    """(streams, counters, engine) of one run over `prompts`; the most int4
    pool pages in use after any step is engine.used4."""
    if engine_cls is JEngine:
        eng = JEngine(cfg, params, _ecfg(JEngineConfig, mixed, **kw))
    else:
        eng = Engine(cfg, params, _ecfg(EngineConfig, mixed, **kw), device="cpu")
    for p in prompts:
        eng.add_request(list(p))
    eng.used4 = 0
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        if mixed is not None:
            a4 = eng.alloc.a4
            eng.used4 = max(eng.used4, a4.num_pages - 1 - a4.free_pages)
    return dict(eng.finished), {c: eng.metrics.counter(c) for c in COUNTERS}, eng


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, n).tolist() for n in lengths]


@pytest.fixture(scope="module")
def boundary_covers(models):
    jc, jp, tc, tp = models
    prompts = _prompts(11, (5, 9))
    mixed = {"boundary_tokens": 64, "int8_pages": 32, "int4_pages": 8}
    return (_serve(JEngine, jc, jp, prompts, mixed), _serve(Engine, tc, tp, prompts, mixed),
            _serve(Engine, tc, tp, prompts))


def test_boundary_covering_context_matches_jax_and_plain_engine(boundary_covers):
    """boundary >= every context: the INT4 partial is empty and drops out of
    the merge exactly, so the mixed streams equal the plain INT8 engine's
    as well as the JAX mixed engine's."""
    (want, jcount, _), (got, tcount, eng), (plain, _, _) = boundary_covers
    assert got == want and tcount == jcount
    assert got == plain
    assert eng.alloc.a8.free_pages == 31 and eng.alloc.a4.free_pages == 7


@pytest.fixture(scope="module")
def crossing(models):
    jc, jp, tc, tp = models
    prompts = _prompts(12, (6,))
    return (_serve(JEngine, jc, jp, prompts, MIXED, max_new_tokens=12),
            _serve(Engine, tc, tp, prompts, MIXED, max_new_tokens=12))


def test_decode_across_the_boundary_matches_jax(crossing):
    """Context 6 -> 18 crosses the boundary at 8: decode appends route to
    the INT4 bulk, whose pages are really in use, and both pools drain."""
    (want, jcount, jeng), (got, tcount, eng) = crossing
    assert got == want and tcount == jcount
    assert len(got[0]) == 12
    assert eng.used4 == jeng.used4 >= 2
    assert eng.alloc.a8.free_pages == 7 and eng.alloc.a4.free_pages == 15


def test_windowed_mixed_trims_int4_bulk_like_jax():
    """attention_sinks == boundary_tokens == window: the INT8 pool holds
    the always-visible sinks and never trims; INT4 pages behind the window
    recycle, counted as JAX counts them."""
    jc, jp, tc, tp = _models(sliding_window=8, attention_sinks=8)
    prompts = _prompts(13, (6,))
    want, jcount, _ = _serve(JEngine, jc, jp, prompts, MIXED, max_new_tokens=16)
    got, tcount, eng = _serve(Engine, tc, tp, prompts, MIXED, max_new_tokens=16)
    assert got == want and tcount == jcount
    assert len(got[0]) == 16 and tcount["pages_trimmed"] > 0
    assert eng.alloc.a8.free_pages == 7 and eng.alloc.a4.free_pages == 15


@pytest.fixture(scope="module")
def chunked(models):
    jc, jp, tc, tp = models
    prompts = _prompts(14, (20,))  # > bucket 16: two chunks, the first spanning both pools
    return {il: (_serve(JEngine, jc, jp, prompts, MIXED, max_new_tokens=5,
                        interleaved_prefill=il),
                 _serve(Engine, tc, tp, prompts, MIXED, max_new_tokens=5,
                        interleaved_prefill=il))
            for il in (False, True)}


@pytest.mark.parametrize("interleaved", [False, True], ids=["blocking", "interleaved"])
def test_chunked_prefill_matches_jax(chunked, interleaved):
    (want, jcount, _), (got, tcount, _) = chunked[interleaved]
    assert got == want and tcount == jcount
    assert tcount["prefill_tokens"] == 20
    assert tcount["prefill_chunks_interleaved"] == (2 if interleaved else 0)


def test_interleaved_chunks_equal_blocking(chunked):
    assert chunked[True][1][0] == chunked[False][1][0]


@pytest.fixture(scope="module")
def stepwise(models):
    jc, jp, tc, tp = models
    prompts = _prompts(16, (5, 7))
    return (prompts, _serve(JEngine, jc, jp, prompts, MIXED, max_new_tokens=12)[0],
            _serve(Engine, tc, tp, prompts, MIXED, max_new_tokens=12)[0])


def test_stepwise_decode_matches_jax(stepwise):
    _, want, got = stepwise
    assert got == want


@pytest.mark.parametrize("chunk", [3, 4])
def test_fused_decode_matches_stepwise(models, stepwise, chunk):
    """decode_chunk > 1: the loop picks each step's pool on the device and
    crosses the boundary (context 8) mid-chunk; the greedy streams equal
    one-token-per-step mixed decode (and so JAX's)."""
    _, _, tc, tp = models
    prompts, _, base = stepwise
    got, counts, _ = _serve(Engine, tc, tp, prompts, MIXED, max_new_tokens=12,
                            decode_chunk=chunk)
    assert got == base
    assert counts["decode_steps"] % chunk == 0


@pytest.mark.parametrize("case", ["prefix_cache", "uniform", "attention_sinks"])
def test_mixed_gates_raise_like_jax(models, case):
    mixed = {"boundary_tokens": 8, "int8_pages": 8, "int4_pages": 8}
    _, _, tc, tp = models
    kw = {}
    if case == "prefix_cache":
        kw = dict(prefix_cache=True)
    else:
        cfg_kw = (dict(window_pattern=(8, None)) if case == "uniform"
                  else dict(sliding_window=8, attention_sinks=4))
        tc = tl.LlamaConfig.tiny(num_layers=2, dtype=torch.float32, **cfg_kw)
        tp = tl.init_params(tc, device="cpu")
    with pytest.raises(ValueError, match=case):
        Engine(tc, tp, _ecfg(EngineConfig, mixed, **kw), device="cpu")


def test_mixed_with_hybrid_stays_refused():
    """mixed_kv with hybrid_kv over two window groups builds, as in JAX:
    the full group's pool is the mixed pair and the sliding group's plain
    INT8; with prefix_cache the composition is refused, as in JAX."""
    tc = tl.LlamaConfig.tiny(num_layers=2, dtype=torch.float32, window_pattern=(8, None))
    tp = tl.init_params(tc, device="cpu")
    ecfg = dataclasses.replace(_ecfg(EngineConfig, MIXED), hybrid_kv=True)
    eng = Engine(tc, tp, ecfg, device="cpu")
    assert eng.hybrid_mixed and not eng.mixed
    assert type(eng.allocs["full"]).__name__ == "MixedPageAllocator"
    assert type(eng.allocs["w8"]).__name__ == "PageAllocator"
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(tc, tp, dataclasses.replace(ecfg, prefix_cache=True), device="cpu")
