"""PyTorch port vs JAX package: speculative decoding (serving/speculative.py,
sampling.rejection_sample and the allocators' rollback), on the JAX
package's tests/test_speculative.py fixture: a tiny f32 target of 2
layers and a draft of 1 layer (hidden 64), page 16, buckets (16, 32),
parameters from numpy given to both packages. JAX runs its Pallas kernels
in interpret mode, the port their plain versions.

Greedy streams equal the JAX SpecDecodeEngine's on the same schedule and
do not depend on k (every emitted token comes from the target's verify
logits over the same prefix). Sampled speculation cannot match JAX's
draws (torch.Generator is not jax.random): its streams are held to their
range, their lengths and, under self-speculation, to acceptance; and
rejection_sample is held in distribution, the emitted token's histogram
over 40000 draws within a total-variation bound of the target's warped
distribution. Each JAX engine runs once per module (fixtures)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.serving import kv_cache as jkv
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu.serving.speculative import SpecConfig as JSpecConfig
from quantizedmha_tpu.serving.speculative import SpecDecodeEngine as JSpecDecodeEngine
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.quant.weights import quantize_llama_params
from quantizedmha_tpu_torch.serving import kv_cache as tkv
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.sampling import SamplingParams, rejection_sample, warp_logits
from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine
from test_torch_hybrid_cache import numpy_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = dict(num_pages=64, page_size=16, max_batch=3, prefill_buckets=(16, 32),
            max_new_tokens=10, max_pages_per_seq=8)
PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [11, 5]]


@pytest.fixture(scope="module")
def models():
    """(JAX target cfg, params, JAX draft cfg, params, port target cfg,
    params, port draft cfg, params)."""
    out = []
    for kw, seed in ((dict(num_layers=2), 0),
                     (dict(num_layers=1, hidden_size=64, intermediate_size=128), 7)):
        jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
        tree = numpy_params(jc, seed)
        out.append((jc, jax.tree_util.tree_map(jnp.asarray, tree),
                    tl.LlamaConfig.tiny(dtype=torch.float32, **kw),
                    params_from_numpy(tree, device="cpu")))
    (jc, jp, tc, tp), (jdc, jdp, tdc, tdp) = out
    return jc, jp, jdc, jdp, tc, tp, tdc, tdp


def _spec(models, k, prompts, *, draft_is_target=False, scfg=None, params=None, **kw):
    """The port's SpecDecodeEngine run over the prompts: (engine, streams)."""
    *_, tc, tp, tdc, tdp = models
    tp = params if params is not None else tp
    if draft_is_target:
        tdc, tdp = tc, tp
    eng = SpecDecodeEngine(tc, tp, tdc, tdp, EngineConfig(**dict(BASE, **kw)),
                           scfg or SpecConfig(num_draft_tokens=k), device="cpu")
    for p in prompts:
        eng.add_request(list(p))
    return eng, eng.run()


def _jspec(models, k, prompts, **kw):
    jc, jp, jdc, jdp, *_ = models
    eng = JSpecDecodeEngine(jc, jp, jdc, jdp, JEngineConfig(**dict(BASE, **kw)),
                            JSpecConfig(num_draft_tokens=k))
    for p in prompts:
        eng.add_request(list(p))
    return eng, eng.run()


def _plain(models, prompts, **kw):
    *_, tc, tp, _, _ = models
    eng = Engine(tc, tp, EngineConfig(**dict(BASE, **kw)), device="cpu")
    for p in prompts:
        eng.add_request(list(p))
    return eng.run()


@pytest.fixture(scope="module")
def base_streams(models):
    """JAX's greedy speculation at k = 3 on PROMPTS, and the port's at k =
    1, 2, 3 and 5."""
    jeng, want = _jspec(models, 3, PROMPTS)
    return want, {k: _spec(models, k, PROMPTS) for k in (1, 2, 3, 5)}


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_stream_invariant_under_k_and_equal_to_jax(base_streams, k):
    """The losslessness gate: the stream does not depend on how far the
    draft speculates, and equals the JAX package's."""
    want, port = base_streams
    eng, got = port[k]
    assert got == want
    assert eng.metrics.counter("draft_tokens_proposed") > 0


def test_matches_plain_engine_first_tokens(models, base_streams):
    """The first token comes off the prefill logits, shared with the plain
    engine; later tokens agree within the verify / decode kernels' delta,
    so only the lengths are held."""
    want = _plain(models, PROMPTS[:2])
    got = base_streams[1][3][1]
    for rid in want:
        assert got[rid][0] == want[rid][0] and len(got[rid]) == len(want[rid])


def test_self_speculation_high_acceptance(models):
    """Draft == target: acceptance is held back only by the decode / verify
    kernels' delta on near-ties; fewer rounds than tokens."""
    eng, out = _spec(models, 4, [[1, 2, 3]], draft_is_target=True, max_new_tokens=16)
    assert len(out[0]) == 16
    assert eng.acceptance_rate > 0.5, eng.acceptance_rate
    assert eng.metrics.counter("spec_rounds") < 16


def test_eos_mid_block(base_streams, models):
    """EOS inside an accepted block ends the emission exactly there, and
    every page is released."""
    eos = base_streams[1][3][1][2][1]  # the second token of the third stream
    eng, out = _spec(models, 3, [PROMPTS[2]], eos_id=eos)
    assert out[0][-1] == eos and len(out[0]) == 2
    assert eng.alloc.free_pages == eng.ecfg.num_pages - 1
    assert eng.draft_alloc.free_pages == eng.ecfg.num_pages - 1


@pytest.mark.parametrize("case", ["batching", "rollover"])
def test_k_invariance_under_batching_and_page_rollover(models, case):
    """More requests than max_batch (admission, page recycling and rollback
    interleave), and a block spanning a page boundary (rollback frees the
    overhang page): the stream of k = 4 or 5 equals k = 1's."""
    if case == "batching":
        prompts, kw, k = [[i + 1, i + 2, i + 3] for i in range(4)], dict(max_batch=2,
                                                                        max_new_tokens=6), 4
    else:
        prompts, kw, k = [list(range(1, 14))], dict(max_new_tokens=12), 5
    assert _spec(models, k, prompts, **kw)[1] == _spec(models, 1, prompts, **kw)[1]


@pytest.mark.parametrize("case", ["decode_chunk", "vocab", "mixed_kv", "zero_k", "adaptive"])
def test_guards_raise_like_jax(models, case):
    jc, jp, jdc, jdp, tc, tp, tdc, tdp = models
    ekw, scfg, match = {}, dict(num_draft_tokens=4), None
    if case == "decode_chunk":
        ekw, match = dict(decode_chunk=4), "exclusive"
    elif case == "vocab":
        jdc, tdc = (m.LlamaConfig.tiny(vocab_size=128) for m in (jl, tl))
        match = "vocab"
    elif case == "mixed_kv":
        ekw = dict(mixed_kv=dict(boundary_tokens=16, int8_pages=8, int4_pages=8))
        match = "mixed_kv"
    elif case == "zero_k":
        scfg, match = dict(num_draft_tokens=0), "num_draft_tokens"
    else:
        scfg, match = dict(num_draft_tokens=4, adaptive=True, min_k=1, max_k=3), "min_k"
    with pytest.raises(ValueError, match=match):
        JSpecDecodeEngine(jc, jp, jdc, jdp, JEngineConfig(**dict(BASE, **ekw)),
                          JSpecConfig(**scfg))
    with pytest.raises(ValueError, match=match):
        SpecDecodeEngine(tc, tp, tdc, tdp, EngineConfig(**dict(BASE, **ekw)),
                         SpecConfig(**scfg), device="cpu")


def test_speculation_headroom_guard_is_atomic(models):
    """Pool exhaustion in a round raises before either model's allocator or
    cache changes: 4 usable pages a pool, two 32-token prompts take them,
    and the first round (5 tokens past 32) needs a page a sequence."""
    *_, tc, tp, tdc, tdp = models
    eng = SpecDecodeEngine(tc, tp, tdc, tdp,
                           EngineConfig(**dict(BASE, num_pages=5, max_batch=2,
                                               prefill_buckets=(32,), max_new_tokens=16,
                                               max_pages_per_seq=4)),
                           SpecConfig(num_draft_tokens=4), device="cpu")
    eng.add_request(list(range(1, 33)))
    eng.add_request(list(range(2, 34)))
    with pytest.raises(RuntimeError, match="page pool exhausted|out of pages"):
        for _ in range(32):
            eng.step()
    assert dict(eng.alloc.lengths) == dict(eng.draft_alloc.lengths)
    assert set(eng.alloc.lengths.values()) == {32}


def test_adaptive_k_grows_under_self_speculation(models):
    """Self-speculation accepts nearly everything, so adaptive k climbs from
    2, and the stream still equals the plain engine's."""
    prompt = list(range(1, 9))
    eng, out = _spec(models, 2, [prompt], draft_is_target=True, max_new_tokens=24,
                     scfg=SpecConfig(num_draft_tokens=2, adaptive=True, min_k=1, max_k=6))
    assert eng._k > 2 and eng.metrics.counter("spec_k_changes") >= 1
    assert out == _plain(models, [prompt], max_new_tokens=24)


def test_no_draft_page_leak_when_finished_at_activation(models):
    """A request that finishes on its prefill token (max_new 1) leaves no
    draft pages behind."""
    *_, tc, tp, tdc, tdp = models
    eng = SpecDecodeEngine(tc, tp, tdc, tdp, EngineConfig(**BASE), device="cpu")
    free_t, free_d = eng.alloc.free_pages, eng.draft_alloc.free_pages
    eng.add_request([1, 2, 3], max_new=1)
    assert len(eng.run()[0]) == 1
    assert eng.alloc.free_pages == free_t and eng.draft_alloc.free_pages == free_d
    assert not eng.draft_alloc.tables


def test_speculation_trims_window_pages(models):
    """A sliding-window model recycles pages under speculation too."""
    *_, tc, tp, _, _ = models
    cfg = dataclasses.replace(tc, sliding_window=24, attention_sinks=4)
    eng = SpecDecodeEngine(cfg, tp, cfg, tp,
                           EngineConfig(**dict(BASE, page_size=8, max_new_tokens=24,
                                               max_pages_per_seq=12)),
                           SpecConfig(num_draft_tokens=3), device="cpu")
    eng.add_request(list(range(1, 28)))
    assert len(eng.run()[0]) == 24
    assert eng.metrics.counter("pages_trimmed") > 0


@pytest.mark.parametrize("self_spec", [False, True], ids=["draft", "self"])
def test_sampled_speculation(models, self_spec):
    """temperature > 0 (rejection sampling): every request completes with
    its tokens in the vocabulary and both pools drain; with the target as
    its own draft q equals p up to the kernels' delta, so acceptance is
    nearly full."""
    sampling = (SamplingParams(temperature=1.0, seed=11) if self_spec
                else SamplingParams(temperature=0.8, top_k=40, seed=3))
    rng = np.random.default_rng(21)
    prompts = ([[5, 9, 2, 1, 13, 8]] if self_spec
               else [rng.integers(0, 256, n).tolist() for n in (10, 24)])
    n_new = 12 if self_spec else 8
    eng, out = _spec(models, 4 if self_spec else 3, prompts, draft_is_target=self_spec,
                     sampling=sampling, max_new_tokens=n_new)
    assert sorted(out) == list(range(len(prompts)))
    assert all(len(t) == n_new and all(0 <= x < 256 for x in t) for t in out.values())
    assert eng.alloc.free_pages == eng.draft_alloc.free_pages == eng.ecfg.num_pages - 1
    if self_spec:
        assert eng.acceptance_rate > 0.9, eng.acceptance_rate
    else:
        assert 0.0 <= eng.acceptance_rate <= 1.0


@pytest.fixture(scope="module")
def long_prompts(models):
    """JAX's blocking speculation at k = 3 over a short and a 40-token
    prompt (past the largest bucket, 32: two chunks)."""
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, 200, 6).tolist(), rng.integers(1, 200, 40).tolist()]
    return prompts, _jspec(models, 3, prompts, max_new_tokens=6)[1]


@pytest.mark.parametrize("how", ["k1", "k3", "interleaved"])
def test_chunked_and_interleaved_prefill_with_speculation(models, long_prompts, how):
    """Chunked prefill under speculation (the draft mirrors the target's
    chunks into its own cache), at k 1 and 3, and interleaved (the target's
    chunks one a step, the draft's prefill when the last lands): the
    streams equal JAX's blocking k = 3 stream and every pool drains."""
    prompts, want = long_prompts
    kw = dict(interleaved_prefill=True) if how == "interleaved" else {}
    eng, got = _spec(models, 1 if how == "k1" else 3, prompts, max_new_tokens=6, **kw)
    assert got == want
    assert eng.metrics.counter("prefill_chunks_interleaved") == (2 if kw else 0)
    assert eng.alloc.free_pages == eng.draft_alloc.free_pages == eng.ecfg.num_pages - 1


def test_prefix_cache_with_speculation(models):
    """The target shares a page-aligned prefix, the draft prefills fully:
    the streams equal those without the prefix cache."""
    rng = np.random.default_rng(33)
    shared = rng.integers(1, 200, 16).tolist()
    prompts = [shared + [7, 8, 9], shared + [11, 12]]
    eng, got = _spec(models, 2, prompts, max_new_tokens=5, prefix_cache=True)
    assert got == _spec(models, 2, prompts, max_new_tokens=5)[1]
    assert eng.metrics.counter("prefix_cache_hits") >= 1
    assert eng.draft_alloc.free_pages == eng.ecfg.num_pages - 1


def test_spec_composes_with_w4_weights(models):
    """An INT4 target (group 32, an INT8 lm_head) under speculation: the
    stream does not depend on k."""
    tp4 = quantize_llama_params(models[5], bits=4, group=32, lm_head_bits=8)
    base = _spec(models, 1, PROMPTS[:2], params=tp4)[1]
    assert all(len(v) > 0 for v in base.values())
    assert _spec(models, 3, PROMPTS[:2], params=tp4)[1] == base


# --- rejection_sample in distribution ---------------------------------------

N_DRAWS = 40000
VOCAB = 8


def test_rejection_sample_is_distributed_as_the_target():
    """Over N_DRAWS rounds of k = 2 drafts drawn from the draft's warped q,
    the first emitted token (draft 0 if accepted, else the replacement) is
    distributed as the target's warped p. Bound on the total variation
    between the histogram and p: E[TV] <= sum_i sqrt(p_i / N) / 2 <=
    sqrt(V / N) / 2 (Cauchy-Schwarz), and one draw moves TV by at most
    1 / N, so TV passes E[TV] + sqrt(ln(1e6) / (2N)) with probability
    below 1e-6 (McDiarmid): 0.0202 at N = 40000, V = 8. Accepting every
    draft would leave TV(q, p), over 0.3 here."""
    params = SamplingParams(temperature=0.8, top_p=0.95)
    g = torch.Generator().manual_seed(0)
    t_logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0])
    d_logits = torch.tensor([-1.0, 0.0, 2.5, 0.5, 1.5, -0.5, 1.0, -3.0])
    p = torch.softmax(warp_logits(t_logits, params), -1)
    q = torch.softmax(warp_logits(d_logits, params), -1)
    assert 0.5 * (p - q).abs().sum().item() > 0.3
    drafts = torch.multinomial(q.expand(N_DRAWS * 2, VOCAB), 1, replacement=True,
                               generator=g).reshape(N_DRAWS, 2)
    n_acc, repl = rejection_sample(d_logits.expand(N_DRAWS, 2, VOCAB),
                                   t_logits.expand(N_DRAWS, 2, VOCAB), drafts, g, params)
    first = torch.where(n_acc > 0, drafts[:, 0], repl.long())
    hist = torch.bincount(first, minlength=VOCAB).double() / N_DRAWS
    tv = 0.5 * (hist - p.double()).abs().sum().item()
    bound = 0.5 * math.sqrt(VOCAB / N_DRAWS) + math.sqrt(math.log(1e6) / (2 * N_DRAWS))
    assert tv <= bound, (tv, bound)
    assert 0 < (n_acc == 2).float().mean().item() < 1


def test_rejection_sample_refuses_greedy():
    with pytest.raises(ValueError, match="temperature"):
        rejection_sample(torch.zeros(1, 1, 4), torch.zeros(1, 1, 4),
                         torch.zeros(1, 1, dtype=torch.int32), None, SamplingParams())


# --- rollback ----------------------------------------------------------------

def _alloc_trace(mod, mixed):
    """The same admit / extend / rollback / trim sequence through one
    package's allocator: its (lengths, tables, free counts) after each call
    and the errors raised."""
    a = (mod.MixedPageAllocator(6, 8, 4, 8) if mixed
         else mod.PageAllocator(12, 4, scrap_page=0))
    pools = (a.a8, a.a4) if mixed else (a,)

    def snap():
        return (dict(a.lengths), [{s: list(t) for s, t in x.tables.items()} for x in pools],
                [x.free_pages for x in pools])
    out = []
    a.admit(0, 6)
    a.admit(1, 3)
    for _ in range(17):
        a.extend(0)
    out.append(snap())
    a.rollback(0, 19)  # frees the page past 19 tokens
    out.append(snap())
    a.rollback(1, 0)  # keeps one page
    out.append(snap())
    for bad in (24, -1):
        try:
            a.rollback(0, bad)
        except ValueError as e:
            out.append(("ValueError", str(e)))
    a.trim_window(0, 1)  # trims the pages wholly behind the window
    out.append(snap())
    try:
        a.rollback(0, 9)  # back past the trimmed pages
    except RuntimeError as e:
        out.append(("RuntimeError", str(e)))
    out.append(snap())
    return out


@pytest.mark.parametrize("mixed", [False, True], ids=["PageAllocator", "MixedPageAllocator"])
def test_rollback_matches_jax(mixed):
    """PageAllocator.rollback and MixedPageAllocator.rollback give JAX's
    tables, lengths and free counts, and refuse what JAX refuses: a length
    outside [0, length] and a rollback past a window-trimmed page (a
    RuntimeError, which python -O keeps)."""
    got, want = _alloc_trace(tkv, mixed), _alloc_trace(jkv, mixed)
    assert got == want
    assert got[-2][0] == "RuntimeError"
