"""PyTorch port vs JAX package: chunked prefill through the paged INT8
cache (llama_adapter.prefill_chunk), the allocator's prefix sharing, and
the engine's chunked, prefix-cached and interleaved admission, on a tiny
f32 Llama with float weights and the default attention_impl="flash". JAX
runs its Pallas kernels in interpret mode; the port runs their plain
versions.

Tolerances: logits atol = rtol = 1e-2 (test_torch_engine.py's bound: a
1-ulp f32 difference between the frameworks can flip one int8 rounding of
K/V in the cache, a change the size of the int8 step; observed ~1e-5).
Page payloads: the same one-step flips, so at most 1 apart and at most
0.1% of them; scales rtol 1e-5. Greedy token streams and the engines'
counters must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.serving import llama_adapter as jad
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu.serving.kv_cache import PageAllocator as JPageAllocator
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.serving import llama_adapter as tad
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.kv_cache import PageAllocator
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

COUNTERS = ("requests_admitted", "prefill_tokens", "prefix_cache_hits",
            "prefix_tokens_reused", "prefill_chunks_interleaved", "pages_trimmed")


def _models(**cfg_kw):
    kw = dict(num_layers=2, num_heads=4, num_kv_heads=2, **cfg_kw)
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    assert jc.attention_impl == tc.attention_impl == "flash"
    jp = jl.init_params(jc, jax.random.PRNGKey(11))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, jp, tc, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def test_prefill_chunk_matches_jax(models):
    """A 40-token prompt in three 16-token chunks (the last one padded),
    each chunk's logits and, at the end, every written page against JAX."""
    jc, jp, tc, tp = models
    page, chunk, n = 8, 16, 40
    prompt = np.random.default_rng(1).integers(1, jc.vocab_size, n)
    alloc = PageAllocator(12, page, scrap_page=0)
    alloc.admit(0, n)
    table = alloc.block_table_array([0], 8)[0]
    jcache = jad.make_cache(jc, 12, page)
    tcache = tad.make_cache(tc, 12, page, device="cpu")
    for start in range(0, n, chunk):
        part = prompt[start:start + chunk]
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :len(part)] = part
        jlog, jcache = jad.prefill_chunk(jc, jp, jcache, jnp.asarray(toks), jnp.int32(start),
                                         jnp.asarray(table), jnp.int32(len(part) - 1),
                                         page_size=page)
        tlog, tcache = tad.prefill_chunk(tc, tp, tcache, torch.from_numpy(toks), start,
                                         torch.from_numpy(table), len(part) - 1, page_size=page)
        assert tlog.shape == (1, jc.vocab_size)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-2, atol=1e-2)
    used = table[:alloc.pages_needed(n)]
    for name in ("k_pages", "v_pages"):
        got = getattr(tcache, name)[:, :, used].numpy().astype(np.int32)
        want = np.asarray(getattr(jcache, name))[:, :, used].astype(np.int32)
        assert np.abs(got - want).max() <= 1 and (got != want).mean() <= 1e-3
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(getattr(tcache, name)[:, :, used].numpy(),
                                   np.asarray(getattr(jcache, name))[:, :, used], rtol=1e-5)


def test_prefill_chunk_refuses_other_caches(models):
    """A hybrid group dict that lacks a layer's window group raises."""
    _, _, tc, tp = models
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="no group 'full'"):
        tad.prefill_chunk(tc, tp, {"w8": None}, toks, 0, torch.zeros(4), 15, page_size=8)


def test_admit_with_prefix_and_on_free_match_jax():
    """Shared prefix slots (one window-trimmed None slot among them),
    refcounts, the on_free hook and the free list, step for step."""
    freed = {"jax": [], "port": []}
    allocs = {"jax": JPageAllocator(12, 4, scrap_page=0),
              "port": PageAllocator(12, 4, scrap_page=0)}
    for name, a in allocs.items():
        a.on_free = freed[name].append
    trace = {}
    for name, a in allocs.items():
        owner = a.admit(0, 14)                       # 4 pages
        fresh = a.admit_with_prefix(1, 18, [None] + owner[1:3])
        a.extend(1)
        a.release(0)                                 # shared pages survive
        mid = (list(freed[name]), a.free_pages)
        a.release(1)
        with pytest.raises(ValueError):
            a.admit_with_prefix(2, 4, [1, 2])
        trace[name] = (owner, fresh, mid, list(freed[name]), a.free_pages, sorted(a._free))
    assert trace["port"] == trace["jax"]


def _run(engine_cls, cfg, params, schedule, **ecfg_kw):
    """Drive an engine through `schedule`: a list of prompt lists, each
    added after one step() (the first before any step), then run()."""
    base = dict(num_pages=64, page_size=16, max_batch=3, prefill_buckets=(32, 64),
                max_new_tokens=5, max_pages_per_seq=12)
    base.update(ecfg_kw)
    if engine_cls is JEngine:
        eng = JEngine(cfg, params, JEngineConfig(**base))
    else:
        eng = Engine(cfg, params, EngineConfig(**base), device="cpu")
    for i, prompts in enumerate(schedule):
        if i:
            eng.step()
        for p in prompts:
            eng.add_request(list(p))
    out = eng.run()
    return out, {c: eng.metrics.counter(c) for c in COUNTERS}, eng


def _both(models, schedule, **kw):
    jc, jp, tc, tp = models
    want, jcount, _ = _run(JEngine, jc, jp, schedule, **kw)
    got, tcount, eng = _run(Engine, tc, tp, schedule, **kw)
    assert got == want and tcount == jcount
    assert not eng.failed and all(len(t) == 5 for t in got.values())
    return got, tcount, eng


def test_engine_long_prompt_mixed_with_short_ones(models):
    """A 150-token prompt (three chunks of 64) between two bucketed ones."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, n).tolist() for n in (20, 150, 40)]
    _, counts, eng = _both(models, [prompts])
    assert counts["requests_admitted"] == 3
    assert eng.alloc.free_pages == 63  # every page back but the scrap page


def test_engine_prefix_cache_matches_jax(models):
    """A shared 48-token (3-page) system prompt: the second and third
    requests reuse its pages and prefill only their suffixes; counters and
    streams equal JAX's."""
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(1, 256, 48).tolist()
    schedule = [[sys_prompt + [5, 6, 7]], [sys_prompt + [9, 10, 11, 12], sys_prompt + [1] * 20]]
    _, counts, eng = _both(models, schedule, prefix_cache=True)
    assert counts["prefix_cache_hits"] == 2 and counts["prefix_tokens_reused"] == 96
    assert not eng._prefix_map and not eng._page_hash


def test_engine_interleaved_prefill_matches_jax(models):
    """interleaved_prefill: a 150-token prompt's three chunks run one per
    step while a short request decodes; streams equal JAX's and the
    blocking engine's."""
    rng = np.random.default_rng(4)
    short, long = rng.integers(1, 256, 8).tolist(), rng.integers(1, 256, 150).tolist()
    got, counts, _ = _both(models, [[short], [long]], interleaved_prefill=True)
    assert counts["prefill_chunks_interleaved"] == 3
    _, _, tc, tp = models
    blocking, _, _ = _run(Engine, tc, tp, [[short], [long]])
    assert blocking == got


def test_engine_uniform_window_prefix_tail_sharing_matches_jax():
    """A uniformly windowed model (window 8, page 4): the owner's trims
    free the prefix's old pages, the second request still hits on the
    window-tail pages, with None (scrap) slots before them."""
    models = _models(window_pattern=(8, 8))
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 256, 16).tolist()
    kw = dict(num_pages=32, page_size=4, prefill_buckets=(8, 16), max_pages_per_seq=16,
              prefix_cache=True, max_batch=2)
    _, counts, eng = _both(models, [[prefix + [5, 6]], [prefix + [9, 10, 11]]], **kw)
    assert counts["prefix_cache_hits"] == 1 and counts["prefix_tokens_reused"] == 16
    assert counts["pages_trimmed"] > 0 and not eng.alloc.tables


def test_cached_prefix_tail_rows_match_jax():
    """_resolve_prefix on the same engine state: the port picks the same
    slots, None where the window already freed the page."""
    jc, jp, tc, tp = _models(window_pattern=(8, 8))
    prefix = np.random.default_rng(6).integers(1, 256, 16).tolist()
    kw = dict(num_pages=32, page_size=4, prefill_buckets=(8, 16), max_pages_per_seq=16,
              prefix_cache=True, max_batch=2, max_new_tokens=5)
    rows = []
    for eng in (JEngine(jc, jp, JEngineConfig(**kw)),
                Engine(tc, tp, EngineConfig(**kw), device="cpu")):
        eng.add_request(prefix + [5, 6])
        eng.step()
        rows.append(eng._resolve_prefix(prefix + [9, 10, 11]))
    assert rows[0] == rows[1]
    assert [p is None for p in rows[1]] == [True, True, False, False]


def test_structural_reject_counts_chunk_slots():
    """A prompt whose padded chunks need more table slots than a sequence
    may hold fails alone, naming the claim; the other request is served."""
    jc, jp, tc, tp = _models()
    ecfg = EngineConfig(num_pages=64, page_size=16, max_batch=2, prefill_buckets=(32, 64),
                        max_new_tokens=3, max_pages_per_seq=8)
    eng = Engine(tc, tp, dataclasses.replace(ecfg), device="cpu")
    bad = eng.add_request([3] * 130)   # 3 chunks of 64 = 12 slots > 8
    ok = eng.add_request([4] * 10)
    out = eng.run()
    assert set(eng.failed) == {bad} and "12 table slots" in eng.failed[bad]
    assert out[bad] == [] and len(out[ok]) == 3
