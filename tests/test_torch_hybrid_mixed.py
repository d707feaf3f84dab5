"""PyTorch port vs JAX package: hybrid_kv with mixed_kv, group pools whose
full-attention group is the mixed INT8-sink / INT4-bulk pair while the
sliding groups stay plain INT8 (the cases of the JAX package's
tests/test_hybrid_mixed.py), on a tiny f32 model with the Gemma-2-style
pattern (8, None, 8, None), page 4, attention_impl="reference" and
parameters from numpy given to both packages. JAX runs its Pallas kernels
in interpret mode, the port their plain versions.

Greedy streams and the engines' counters equal JAX's (the comparison of
tests/test_torch_hybrid_engine.py). A prompt's pages written through
write_prefill_hybrid hold, bit for bit, the JAX package's eager page
quantizers' payloads and scales on the same K/V. Each JAX engine runs
once per module (fixtures)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.serving import kv_cache as jkv
from quantizedmha_tpu.serving import llama_adapter as jad
from quantizedmha_tpu.serving import mixed_kv as jmx
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch.serving import llama_adapter as tad
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.kv_cache import MixedPageAllocator
from quantizedmha_tpu_torch.serving.mixed_kv import MixedPagedKVState
from test_torch_hybrid_cache import PAGE, hybrid_models
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATTERN = (8, None, 8, None)
COUNTERS = ("requests_admitted", "prefill_tokens", "prefill_chunks_interleaved",
            "pages_trimmed", "decode_steps", "tokens_generated")
INSIDE = dict(boundary_tokens=32, int8_pages=32, int4_pages=16)  # covers every context
CROSS = dict(boundary_tokens=8, int8_pages=16, int4_pages=16)
BASE = dict(num_pages=64, page_size=PAGE, max_batch=2, max_pages_per_seq=16,
            prefill_buckets=(8, 16), max_new_tokens=16, hybrid_kv=True,
            hybrid_pages={"w8": 24})


@pytest.fixture(scope="module")
def models():
    return hybrid_models(PATTERN, seed=4)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, n).tolist() for n in lengths]


def _serve(engine_cls, models, prompts, mixed_kv=None, **kw):
    """(streams, counters, engine) of one engine over the prompts, all
    queued at once."""
    jc, jp, tc, tp = models
    base = dict(BASE, mixed_kv=None if mixed_kv is None else dict(mixed_kv), **kw)
    if engine_cls is JEngine:
        eng = JEngine(jc, jp, JEngineConfig(**base))
    else:
        eng = Engine(tc, tp, EngineConfig(**base), device="cpu")
    for p in prompts:
        eng.add_request(list(p))
    out = eng.run()
    return out, {c: eng.metrics.counter(c) for c in COUNTERS}, eng


@pytest.fixture(scope="module")
def inside(models):
    """The inside-the-boundary schedule: JAX's hybrid x mixed engine at
    decode_chunk 1 (the JAX package's own test holds its chunk-4 streams
    to chunk 1's), the port's and the port's plain hybrid one at 1 and 4."""
    prompts = _prompts(0, (5, 9, 14))
    return (_serve(JEngine, models, prompts, INSIDE),
            {c: (_serve(Engine, models, prompts, INSIDE, decode_chunk=c),
                 _serve(Engine, models, prompts, decode_chunk=c)) for c in (1, 4)})


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_hybrid_mixed_exact_vs_hybrid_inside_boundary(inside, decode_chunk):
    """boundary_tokens 32 covers every context, so the full group's INT4
    pool is never written: streams and counters equal JAX's (at chunk 4,
    those that do not count steps or trims between them), and the streams
    equal the plain hybrid engine's at the same decode_chunk (the INT8
    region quantizes as its pages do)."""
    (want, jcount, jeng), port = inside
    (got, tcount, eng), (plain, _, _) = port[decode_chunk]
    assert eng.hybrid_mixed and not eng.mixed and jeng.hybrid_mixed
    assert isinstance(eng.allocs["full"], MixedPageAllocator)
    assert isinstance(eng.cache["full"], MixedPagedKVState)
    assert got == want and got == plain
    per_step = ("decode_steps", "pages_trimmed") if decode_chunk > 1 else ()
    assert ({c: n for c, n in tcount.items() if c not in per_step}
            == {c: n for c, n in jcount.items() if c not in per_step})
    full = eng.allocs["full"]
    assert full.a4.free_pages == INSIDE["int4_pages"] - 1  # scrap only: never used
    assert full.a8.free_pages == INSIDE["int8_pages"] - 1
    assert tcount["pages_trimmed"] > 0  # the w8 group recycled


@pytest.fixture(scope="module")
def crossing(models):
    """JAX's engine and the port's at decode_chunk 1, the port's twice, and
    at decode_chunk 4 and 3, on contexts that cross the boundary."""
    prompts = _prompts(1, (9, 13))
    return (_serve(JEngine, models, prompts, CROSS, max_new_tokens=20),
            _serve(Engine, models, prompts, CROSS, max_new_tokens=20),
            _serve(Engine, models, prompts, CROSS, max_new_tokens=20),
            {c: _serve(Engine, models, prompts, CROSS, decode_chunk=c, max_new_tokens=20)
             for c in (4, 3)})


def test_hybrid_mixed_crosses_boundary_deterministically(crossing):
    """Boundary 8 < context: decode crosses into the full group's INT4
    bulk. The streams equal JAX's and a second run's, both pools drain and
    the sliding group keeps trimming."""
    (want, jcount, _), (got, tcount, eng), (again, _, _), _ = crossing
    assert got == want and tcount == jcount
    assert got == again
    assert all(len(v) == 20 for v in got.values())
    full = eng.allocs["full"]
    assert full.a8.free_pages == 15 and full.a4.free_pages == 15
    assert tcount["pages_trimmed"] > 0


@pytest.mark.parametrize("chunk", [4, 3])
def test_hybrid_mixed_fused_decode_matches_stepwise(crossing, chunk):
    """decode_chunk > 1 picks each lane's pool on the device and crosses the
    boundary inside the loop (pair tables in the group dict): the streams
    equal one-step decode's, which equal JAX's."""
    (want, _, _), (got, _, _), _, fused = crossing
    assert got == want
    assert fused[chunk][0] == got
    assert fused[chunk][1]["decode_steps"] % chunk == 0


@pytest.fixture(scope="module")
def chunked(models):
    """JAX's blocking chunked admission (its own tests hold interleaved
    admission's stream to it) and the port's, blocking and interleaved."""
    prompts = _prompts(3, (22,))  # past the largest bucket, 16: chunked
    return (_serve(JEngine, models, prompts, CROSS, max_new_tokens=8),
            {il: _serve(Engine, models, prompts, CROSS, max_new_tokens=8,
                        interleaved_prefill=il) for il in (False, True)})


@pytest.mark.parametrize("interleaved", [False, True], ids=["blocking", "interleaved"])
def test_hybrid_mixed_chunked_prefill_and_interleave(chunked, interleaved):
    """A prompt past the largest bucket prefills in chunks through both pool
    kinds (the full group's chunk pages split INT8 / INT4): the stream and
    the counters equal JAX's blocking admission's, chunks interleaved
    aside, interleaved or not."""
    (want, jcount, _), port = chunked
    got, tcount, _ = port[interleaved]
    assert got == want
    assert tcount.pop("prefill_chunks_interleaved") == (2 if interleaved else 0)
    assert tcount == {c: n for c, n in jcount.items() if c != "prefill_chunks_interleaved"}


def test_hybrid_mixed_capacity_lever(models):
    """An INT8 sink pool far smaller than the context serves: two sequences
    to about 36 tokens with boundary 8 hold 2 INT8 pages each, while the
    INT4 bulk carries the rest. Streams and counters equal JAX's and both
    pools drain."""
    mixed = dict(boundary_tokens=8, int8_pages=12, int4_pages=24)
    prompts = _prompts(4, (12, 11))
    want, jcount, _ = _serve(JEngine, models, prompts, mixed, max_new_tokens=24)
    got, tcount, eng = _serve(Engine, models, prompts, mixed, max_new_tokens=24)
    assert got == want and tcount == jcount
    assert all(len(v) == 24 for v in got.values())
    full = eng.allocs["full"]
    assert full.a8.free_pages == 11 and full.a4.free_pages == 23


@pytest.mark.parametrize("case", ["no_full_group", "prefix_cache"])
def test_hybrid_mixed_gates(models, case):
    """A pattern with no full-attention group has nowhere to put the split,
    and prefix_cache stays refused with mixed_kv: both raise as in JAX."""
    if case == "no_full_group":
        jc, jp, tc, tp = hybrid_models((8, 12))
        kw, match = {}, "full-attention"
    else:
        jc, jp, tc, tp = models
        kw, match = dict(prefix_cache=True), "prefix_cache"
    base = dict(BASE, hybrid_pages=None, mixed_kv=dict(INSIDE), **kw)
    with pytest.raises(ValueError, match=match):
        JEngine(jc, jp, JEngineConfig(**base))
    with pytest.raises(ValueError, match=match):
        Engine(tc, tp, EngineConfig(**base), device="cpu")


def test_make_cache_hybrid_mixed_layout_and_pages(models):
    """The group dict's layout (shapes and dtypes) equals JAX's, its errors
    match, and 11 tokens of K/V (3 pages: boundary 8 puts 2 INT8 and 1
    INT4) written through write_prefill_hybrid with a mixed group's id
    pair holds the JAX package's eager quantizers' bits."""
    jc, jp, tc, tp = models
    kw = dict(n8_pages=6, n4_pages=5, subs=2)
    jcaches = jad.make_cache_hybrid_mixed(jc, {"w8": 7}, PAGE, **kw)
    tcaches = tad.make_cache_hybrid_mixed(tc, {"w8": 7}, PAGE, device="cpu", **kw)
    assert set(tcaches) == set(jcaches) == {"w8", "full"}
    for k in tcaches:
        for name, x in vars(tcaches[k]).items():
            want = getattr(jcaches[k], name)
            assert tuple(x.shape) == want.shape and str(x.dtype) == f"torch.{want.dtype}", name
    with pytest.raises(ValueError, match="missing groups"):
        tad.make_cache_hybrid_mixed(tc, {}, PAGE, device="cpu", **kw)
    tw = hybrid_models((8, 12))[2]
    with pytest.raises(ValueError, match="full-attention"):
        tad.make_cache_hybrid_mixed(tw, {"w8": 4, "w12": 4}, PAGE, device="cpu", **kw)

    rng = np.random.default_rng(5)
    n, n_pages = 11, 3
    k_all, v_all = rng.normal(0, 1, (2, tc.num_layers, tc.num_kv_heads, n_pages * PAGE,
                                     tc.hd)).astype(np.float32)
    k_all[:, :, n:] = v_all[:, :, n:] = 0  # the padding rows, zeroed as the engine does
    ids8, ids4, ids_w = np.array([4, 2], np.int32), np.array([3], np.int32), [6, 1, 5]
    tad.write_prefill_hybrid(tc, tcaches, torch.from_numpy(k_all), torch.from_numpy(v_all),
                             {"full": (torch.from_numpy(ids8), torch.from_numpy(ids4)),
                              "w8": torch.tensor(ids_w, dtype=torch.int32)}, page_size=PAGE)
    groups = tad.window_groups(tc)
    for rank, i in enumerate(groups["full"]):
        for name, x in (("k", k_all[i]), ("v", v_all[i])):
            c = tcaches["full"]
            for p, pid in enumerate(ids8):
                q, s = jkv.quantize_page(jnp.asarray(x[:, p * PAGE:(p + 1) * PAGE]))
                np.testing.assert_array_equal(getattr(c, f"{name}8")[rank][:, pid].numpy(),
                                              np.asarray(q))
                np.testing.assert_array_equal(
                    getattr(c, f"{name}8_scales")[rank][:, pid].numpy(), np.asarray(s))
            q, s = jmx.quantize_page_int4(jnp.asarray(x[:, 2 * PAGE:]), 2)
            np.testing.assert_array_equal(getattr(c, f"{name}4")[rank][:, ids4[0]].numpy(),
                                          np.asarray(q))
            np.testing.assert_array_equal(
                getattr(c, f"{name}4_scales")[rank][:, ids4[0]].numpy(), np.asarray(s))
    for rank, i in enumerate(groups["w8"]):
        for p, pid in enumerate(ids_w):
            q, s = jkv.quantize_page(jnp.asarray(k_all[i][:, p * PAGE:(p + 1) * PAGE]))
            np.testing.assert_array_equal(tcaches["w8"].k_pages[rank][:, pid].numpy(),
                                          np.asarray(q))
            np.testing.assert_array_equal(tcaches["w8"].k_scales[rank][:, pid].numpy(),
                                          np.asarray(s))
