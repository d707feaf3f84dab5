"""PyTorch port vs JAX package: a model in f32 with Gemma-2's knobs at
head_dim 256 served through the engine, and the reference ABI's "fa" rung
at d_model / h = 256: the f32 routes of row 5 (the float flash forward)
and rows 10-11 (the paged prefill with f32 q, INT8 and INT4 pages) at
Gemma-2's head dim.

The model: two layers, pattern (8, None) (a sliding layer and a full one),
2 q heads over 1 kv head of 256, sandwich norms, (1+w) RMSNorm, GeGLU with
tanh GELU, scaled embeddings, query_pre_attn_scalar 256, attention and
final-logit softcaps, attention_impl="flash", f32 parameters drawn with
numpy for both packages. One schedule runs in both engines (JAX's Pallas
in interpret mode) with hybrid pools, page 4 and buckets (8, 16): a
22-token prompt (past the largest bucket: two chunks through the paged
prefill) beside a bucketed 7-token one (the flash forward), then, over
the INT8 cache, a prompt sharing the long one's first five pages (a
prefix hit: its suffix through the paged prefill; the sliding group's
window tail, pages 3 and 4, is still live), and over the mixed
INT8 / INT4 cache (boundary 8; no prefix cache, which mixed_kv refuses)
the chunks split into INT8 and INT4 partials. Greedy streams and counters
equal JAX's; the port's plain functions (what the wrappers run on the
CPU) count each route's calls, in f32 at head_dim 256.

solve: f32 throughout, so the two packages differ by summation order
alone: rtol = atol = 1e-5, as tests/test_torch_flash_solve.py's f32 rungs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu import api as japi
from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch import api as tapi
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from quantizedmha_tpu_torch.ops import paged_prefill as tpp
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from test_torch_hybrid_cache import numpy_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D = 256
COUNTERS = ("requests_admitted", "prefill_tokens", "prefix_cache_hits",
            "prefix_tokens_reused", "pages_trimmed", "decode_steps")
BASE = dict(num_pages=48, page_size=4, max_batch=3, max_pages_per_seq=12,
            prefill_buckets=(8, 16), max_new_tokens=4, hybrid_kv=True,
            hybrid_pages={"w8": 24})
MIXED = dict(boundary_tokens=8, int8_pages=16, int4_pages=16)
ROUTES = {"flash": ("_flash_fwd_plain", tfa), "prefill": ("_paged_prefill_plain", tpp),
          "prefill_int4": ("_paged_prefill_int4_plain", tpp)}


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, window_pattern=(8, None), num_heads=2, num_kv_heads=1,
              head_dim=D, sandwich_norms=True, rms_plus_one=True, hidden_act="gelu_tanh",
              embed_scale=True, query_pre_attn_scalar=256.0, logit_softcap=50.0,
              final_logit_softcap=30.0)
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    assert jc.attention_impl == tc.attention_impl == "flash" and tc.hd == D
    tree = numpy_params(jc, 23)
    return jc, jax.tree_util.tree_map(jnp.asarray, tree), tc, params_from_numpy(tree, device="cpu")


def _serve(eng, prompts, hit):
    """Queue the prompts, take one step, queue the hit (its prefix is then
    registered), run: (streams, counters)."""
    for p in prompts:
        eng.add_request(list(p))
    eng.step()
    if hit is not None:
        eng.add_request(list(hit))
    out = eng.run()
    return out, {c: eng.metrics.counter(c) for c in COUNTERS}


@pytest.fixture(scope="module")
def served(models):
    """Each cache's schedule through both engines, the port's plain routes
    counted by (dtype, head_dim): {cache: (JAX's, the port's, calls)}."""
    jc, jp, tc, tp = models
    rng = np.random.default_rng(4)
    long, short = (rng.integers(1, 200, n).tolist() for n in (22, 7))
    hit = long[:20] + rng.integers(1, 200, 5).tolist()
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for cache, kw, h in (("int8", dict(prefix_cache=True), hit),
                             ("mixed", dict(mixed_kv=dict(MIXED)), None)):
            calls = {route: [] for route in ROUTES}
            for route, (name, mod) in ROUTES.items():
                def counted(*a, _fn=getattr(mod, name), _log=calls[route], **k):
                    _log.append((a[0].dtype, a[0].shape[-1]))
                    return _fn(*a, **k)
                mp.setattr(mod, name, counted)
            cfg = dict(BASE, **kw)
            want = _serve(JEngine(jc, jp, JEngineConfig(**cfg)), (long, short), h)
            got = _serve(Engine(tc, tp, EngineConfig(**cfg), device="cpu"), (long, short), h)
            mp.undo()
            runs[cache] = (want, got, calls)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("cache", ["int8", "mixed"])
def test_engine_serves_f32_gemma2_knobs_at_256_like_jax(served, cache):
    (want, jcount), (got, tcount), _ = served[cache]
    assert got == want and tcount == jcount
    assert all(len(v) == BASE["max_new_tokens"] for v in got.values())
    if cache == "int8":
        assert tcount["prefix_cache_hits"] == 1 and tcount["prefix_tokens_reused"] == 20
    assert tcount["pages_trimmed"] > 0


@pytest.mark.parametrize("cache", ["int8", "mixed"])
def test_engine_runs_the_f32_routes_at_256(served, cache):
    """Rows 5 and 10 ran (and row 11 over the mixed cache), every call in
    f32 at head_dim 256."""
    calls = served[cache][2]
    want = ("flash", "prefill") + (("prefill_int4",) if cache == "mixed" else ())
    for route in want:
        assert calls[route], route
    assert all(c == (torch.float32, D) for log in calls.values() for c in log)
    if cache == "int8":
        assert not calls["prefill_int4"]


def test_solve_fa_at_head_dim_256_matches_jax():
    """solve(kernel="fa") at d_model 512 over 2 heads (head_dim 256, the f32
    flash forward's CUDA-core route on the card), N = 64."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(0, 0.5, (64, 512)).astype(np.float32) for _ in range(3))
    got = tapi.solve(*(torch.from_numpy(x) for x in (q, k, v)), 512, 2, kernel="fa",
                     device="cpu")
    want = np.asarray(japi.solve(*(jnp.asarray(x) for x in (q, k, v)), 512, 2, kernel="fa"))
    assert got.shape == (64, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
