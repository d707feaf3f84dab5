"""PyTorch port vs JAX package: the hybrid (per-window-group) KV cache of
serving/llama_adapter.py, on tiny f32 Llamas with window patterns, page 4,
attention_impl="reference" (the serving attention is the paged kernels'
plain versions here, Pallas in interpret mode in the JAX package).

Each window group has its own layer-stacked cache and page pool, so the
same prompt sits at other physical page ids in each group. The port's
grouped paths are held to JAX's on the same inputs and to the port's own
single shared pool, which the existing tests hold to JAX's: page contents
must not change by a bit when only the page ids do.

Tolerances: logits atol = rtol = 1e-2 against JAX (test_torch_engine.py's
bound: a 1-ulp f32 difference between the frameworks can flip one int8
rounding of a cached K/V element, a change the size of the int8 step);
greedy tokens equal. The prompt's pages are written from the same K/V in
both packages: payloads and scales bit for bit against the JAX package's
eager page quantizer (its write_pages runs under lax.scan, where XLA may
divide by 127 through the reciprocal, one ulp off). Against the port's
single pool every logit and every page is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.serving import kv_cache as jkv
from quantizedmha_tpu.serving import llama_adapter as jad
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.serving import llama_adapter as tad
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PAGE = 4


def numpy_params(jc, seed):
    """The JAX package's parameter tree for jc with every leaf drawn anew
    from numpy's generator at `seed`, keeping the leaf's shape, dtype, mean
    and spread (a constant leaf, such as a norm's ones, spreads by 0.1)."""
    template = jax.tree_util.tree_map(np.asarray, jl.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(a):
        return rng.normal(float(a.mean()), float(a.std()) or 0.1, a.shape).astype(a.dtype)
    return jax.tree_util.tree_map(draw, template)


def hybrid_models(pattern, seed=0, **cfg_kw):
    """(JAX config, JAX params, port config, port params) of a tiny f32
    model with this window pattern, parameters from numpy_params."""
    kw = dict(num_layers=len(pattern), window_pattern=pattern, attention_impl="reference",
              **cfg_kw)
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    tree = numpy_params(jc, seed)
    return jc, jax.tree_util.tree_map(jnp.asarray, tree), tc, params_from_numpy(tree, device="cpu")


def _i32(*xs):
    return [torch.as_tensor(np.asarray(x, np.int32)) for x in xs]


def _setup(models, n_prompt, max_pages=8, seed=0):
    """A prompt's K/V (JAX's prefill, fed to both packages) written into
    hybrid pools at shuffled ids, distinct per group, in both packages,
    and into the port's single pool at ids 0.. . Returns a dict of the
    caches and [1, max_pages] tables (numpy) with three slack slots."""
    jc, jp, tc, tp = models
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jc.vocab_size, (1, n_prompt))
    _, jk, jv = jad.prefill(jc, jp, jnp.asarray(tokens, jnp.int32))
    pad = (-n_prompt) % PAGE
    k_all, v_all = (np.pad(np.asarray(x), ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (jk, jv))
    n_pages = -(-n_prompt // PAGE)
    n_tab = min(max_pages, n_pages + 3)
    groups = tad.window_groups(tc)
    gids = {k: rng.permutation(16)[:n_tab].astype(np.int32) for k in sorted(groups)}
    jcaches = jad.write_prefill_hybrid(
        jc, jad.make_cache_hybrid(jc, {k: 16 for k in groups}, PAGE), jnp.asarray(k_all),
        jnp.asarray(v_all), {k: jnp.asarray(g[:n_pages]) for k, g in gids.items()},
        page_size=PAGE)
    tcaches = tad.write_prefill_hybrid(
        tc, tad.make_cache_hybrid(tc, {k: 16 for k in groups}, PAGE, device="cpu"),
        torch.from_numpy(k_all), torch.from_numpy(v_all),
        {k: torch.from_numpy(g[:n_pages]) for k, g in gids.items()}, page_size=PAGE)
    single = tad.write_prefill(tc, tad.make_cache(tc, 32, PAGE, device="cpu"),
                               torch.from_numpy(k_all), torch.from_numpy(v_all),
                               torch.arange(n_pages, dtype=torch.int32), page_size=PAGE)
    tables = {k: np.zeros((1, max_pages), np.int32) for k in groups}
    for k in groups:
        tables[k][0, :n_tab] = gids[k]
    table1 = np.zeros((1, max_pages), np.int32)
    table1[0, :n_tab] = np.arange(n_tab)
    return dict(k_all=k_all, v_all=v_all, n_pages=n_pages, jcaches=jcaches, tcaches=tcaches,
                single=single, tables=tables, table1=table1)


def _assert_pages_match_single(tc, tcaches, single, tables, table1, n_slots):
    """Every layer's first n_slots table slots hold the same bits in the
    hybrid pools as in the single pool."""
    for i, ((stack, rank), window) in enumerate(zip(tad.layer_stacks(tc, tcaches),
                                                    tc.layer_windows)):
        ids = torch.as_tensor(tables[tad.group_key(window)][0, :n_slots]).long()
        ids1 = torch.as_tensor(table1[0, :n_slots]).long()
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            got = getattr(stack, name)[rank][:, ids]
            want = getattr(single, name)[i][:, ids1]
            assert torch.equal(got, want), (i, name)


def test_group_layout_and_errors():
    jc, _, tc, _ = hybrid_models((8, None, 8, None))
    assert tad.window_groups(tc) == jad.window_groups(jc) == {"w8": [0, 2], "full": [1, 3]}
    assert tad.group_key(None) == jad.group_key(None) == "full"
    assert tad.group_key(4096) == jad.group_key(4096) == "w4096"
    caches = tad.make_cache_hybrid(tc, {"w8": 5, "full": 9}, PAGE, device="cpu")
    jcaches = jad.make_cache_hybrid(jc, {"w8": 5, "full": 9}, PAGE)
    for k in ("w8", "full"):
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            assert tuple(getattr(caches[k], name).shape) == getattr(jcaches[k], name).shape
            assert getattr(caches[k], name).dtype == getattr(torch, str(getattr(
                jcaches[k], name).dtype))
    assert [(id(s), r) for s, r in tad.layer_stacks(tc, caches)] == [
        (id(caches["w8"]), 0), (id(caches["full"]), 0), (id(caches["w8"]), 1),
        (id(caches["full"]), 1)]
    with pytest.raises(ValueError, match="missing groups"):
        tad.make_cache_hybrid(tc, {"w8": 4}, PAGE, device="cpu")
    with pytest.raises(ValueError, match="missing groups"):
        jad.make_cache_hybrid(jc, {"w8": 4}, PAGE)
    with pytest.raises(ValueError, match="no group 'full'"):
        tad.layer_stacks(tc, {"w8": caches["w8"]})


def test_write_prefill_hybrid_pages_bit_exact():
    """Each group's pages hold its own layers' prompt K/V, bit for bit the
    JAX package's eager quantizer on the same K/V, and within one int8
    step (scales one ulp) of its write_prefill_hybrid."""
    models = hybrid_models((None, 8, 8, None))
    tc = models[2]
    s = _setup(models, 11)
    groups = tad.window_groups(tc)
    for k, idxs in groups.items():
        ids = s["tables"][k][0, :s["n_pages"]]
        for rank, i in enumerate(idxs):
            for name, x in (("k", s["k_all"][i]), ("v", s["v_all"][i])):
                for p, pid in enumerate(ids):
                    q, sc = jkv.quantize_page(jnp.asarray(x[:, p * PAGE:(p + 1) * PAGE]))
                    cache = s["tcaches"][k]
                    np.testing.assert_array_equal(
                        getattr(cache, f"{name}_pages")[rank][:, pid].numpy(), np.asarray(q))
                    np.testing.assert_array_equal(
                        getattr(cache, f"{name}_scales")[rank][:, pid].numpy(), np.asarray(sc))
                jpages = np.asarray(getattr(s["jcaches"][k], f"{name}_pages"))[rank][:, ids]
                tpages = getattr(s["tcaches"][k], f"{name}_pages")[rank][:, ids].numpy()
                assert np.abs(tpages.astype(int) - jpages.astype(int)).max() <= 1
                np.testing.assert_allclose(
                    getattr(s["tcaches"][k], f"{name}_scales")[rank][:, ids].numpy(),
                    np.asarray(getattr(s["jcaches"][k], f"{name}_scales"))[rank][:, ids],
                    rtol=1e-6)


@pytest.mark.parametrize("pattern", [(8, None, 8, None), (None, None, 8, 8)])
def test_decode_step_hybrid_matches_jax(pattern):
    """Two decode steps over the group dicts, the second the first token
    of a fresh page (its scale fitted by that token): logits within 1e-2
    of JAX's, and bit-exact with the port's single pool, pages included."""
    models = hybrid_models(pattern)
    jc, jp, tc, tp = models
    n = 11
    s = _setup(models, n)
    jcaches, tcaches, single = s["jcaches"], s["tcaches"], s["single"]
    tables, table1 = s["tables"], s["table1"]
    tok = 7
    for step in range(2):
        pos = n + step
        pids = {k: t[0, pos // PAGE][None] for k, t in tables.items()}
        args = ([tok], [pos], [pos % PAGE], [pos + 1])
        jl_, jcaches = jad.decode_step(
            jc, jp, jcaches, *(jnp.asarray(a, jnp.int32) for a in args[:2]),
            {k: jnp.asarray(v) for k, v in pids.items()}, jnp.asarray(args[2], jnp.int32),
            jnp.asarray(args[3], jnp.int32), {k: jnp.asarray(t) for k, t in tables.items()})
        tok_t, pos_t, slot_t, len_t = _i32(*args)
        tl_, tcaches = tad.decode_step(tc, tp, tcaches, tok_t, pos_t,
                                       {k: torch.from_numpy(v) for k, v in pids.items()},
                                       slot_t, len_t,
                                       {k: torch.from_numpy(t) for k, t in tables.items()})
        sl_, single = tad.decode_step(tc, tp, single, tok_t, pos_t,
                                      torch.as_tensor(table1[0, pos // PAGE][None]), slot_t,
                                      len_t, torch.from_numpy(table1))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=1e-2, atol=1e-2)
        assert torch.equal(tl_, sl_)
        tok = int(np.argmax(np.asarray(jl_)[0]))
    for k, idxs in tad.window_groups(tc).items():
        assert tcaches[k].k_pages.shape[0] == len(idxs)
    _assert_pages_match_single(tc, tcaches, single, tables, table1, -(-(n + 2) // PAGE))


@pytest.mark.parametrize("pattern", [(8, None, 8, None), (None, None, 8, 8)])
def test_decode_loop_hybrid_matches_jax(pattern):
    """Six greedy steps of the on-device loop: the tokens equal JAX's
    hybrid loop's and the port's single-pool loop's."""
    models = hybrid_models(pattern, seed=1)
    jc, jp, tc, tp = models
    n = 10
    s = _setup(models, n, seed=1)
    jt, _ = jad.decode_loop(jc, jp, s["jcaches"], jnp.asarray([3], jnp.int32),
                            jnp.asarray([n], jnp.int32),
                            {k: jnp.asarray(t) for k, t in s["tables"].items()},
                            n_steps=6, page_size=PAGE)
    tt, _ = tad.decode_loop(tc, tp, s["tcaches"], *_i32([3], [n]),
                            {k: torch.from_numpy(t) for k, t in s["tables"].items()},
                            n_steps=6, page_size=PAGE)
    st_, _ = tad.decode_loop(tc, tp, s["single"], *_i32([3], [n]),
                             torch.from_numpy(s["table1"]), n_steps=6, page_size=PAGE)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert torch.equal(tt, st_)


def test_prefill_chunk_hybrid_matches_jax():
    """A 16-token prompt in two chunks of 8 through the group dicts: each
    chunk's logits within 1e-2 of JAX's and equal to the port's single
    pool's, then one decode step on top, and every page as the single
    pool's."""
    models = hybrid_models((8, None, 8, None), seed=2)
    jc, jp, tc, tp = models
    rng = np.random.default_rng(1)
    n, C = 16, 8
    tokens = rng.integers(0, jc.vocab_size, (1, n)).astype(np.int32)
    n_pages = n // PAGE
    groups = tad.window_groups(tc)
    tables = {k: np.zeros((1, 8), np.int32) for k in groups}
    for k in sorted(groups):
        tables[k][0, :n_pages + 1] = rng.permutation(16)[:n_pages + 1]
    table1 = np.zeros((1, 8), np.int32)
    table1[0, :n_pages + 1] = np.arange(n_pages + 1)
    jcaches = jad.make_cache_hybrid(jc, {k: 16 for k in groups}, PAGE)
    tcaches = tad.make_cache_hybrid(tc, {k: 16 for k in groups}, PAGE, device="cpu")
    single = tad.make_cache(tc, 32, PAGE, device="cpu")
    for c0 in range(0, n, C):
        chunk = tokens[:, c0:c0 + C]
        jlog, jcaches = jad.prefill_chunk(
            jc, jp, jcaches, jnp.asarray(chunk), jnp.int32(c0),
            {k: jnp.asarray(t[0]) for k, t in tables.items()}, jnp.int32(C - 1),
            page_size=PAGE)
        tlog, tcaches = tad.prefill_chunk(tc, tp, tcaches, torch.from_numpy(chunk), c0,
                                          {k: torch.from_numpy(t[0]) for k, t in tables.items()},
                                          C - 1, page_size=PAGE)
        slog, single = tad.prefill_chunk(tc, tp, single, torch.from_numpy(chunk), c0,
                                         torch.from_numpy(table1[0]), C - 1, page_size=PAGE)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-2, atol=1e-2)
        assert torch.equal(tlog, slog)
    tok, pos, slot, length = _i32([5], [n], [0], [n + 1])
    l2, tcaches = tad.decode_step(
        tc, tp, tcaches, tok, pos, {k: torch.as_tensor(t[0, n // PAGE][None])
                                    for k, t in tables.items()},
        slot, length, {k: torch.from_numpy(t) for k, t in tables.items()})
    l1, single = tad.decode_step(tc, tp, single, tok, pos,
                                 torch.as_tensor(table1[0, n // PAGE][None]), slot, length,
                                 torch.from_numpy(table1))
    assert torch.equal(l1, l2)
    _assert_pages_match_single(tc, tcaches, single, tables, table1, n_pages + 1)


@pytest.mark.parametrize("layout", ["single", "grouped"])
def test_verify_step_matches_jax(layout):
    """verify_step (three tokens appended at positions 9-11, past a page
    boundary, then attended with the sequence's offset) on a single pool
    and on the group dicts: logits within 1e-2 of JAX's verify_step on the
    same cache and inputs, the grouped ones bit-exact with the port's
    single pool's, pages included (the port of the JAX package's
    test_verify_step_grouped_matches_single)."""
    models = hybrid_models((8, None, 8, None))
    jc, jp, tc, tp = models
    n, S = 9, 3
    s = _setup(models, n)
    draft = np.random.default_rng(3).integers(0, jc.vocab_size, (1, S)).astype(np.int32)
    pos = n + np.arange(S)
    slot_sched = (pos % PAGE).astype(np.int32)[None]
    tables = s["tables"]
    sched = {k: t[0, pos // PAGE][None].astype(np.int32) for k, t in tables.items()}
    sched1 = s["table1"][0, pos // PAGE][None].astype(np.int32)
    if layout == "single":
        jcache = jad.write_prefill(jc, jad.make_cache(jc, 32, PAGE), jnp.asarray(s["k_all"]),
                                   jnp.asarray(s["v_all"]),
                                   jnp.arange(s["n_pages"], dtype=jnp.int32), page_size=PAGE)
        jargs = (jcache, jnp.asarray(sched1), jnp.asarray(s["table1"]))
    else:
        jargs = (s["jcaches"], {k: jnp.asarray(v) for k, v in sched.items()},
                 {k: jnp.asarray(t) for k, t in tables.items()})
    jlog, _ = jad.verify_step(jc, jp, jargs[0], jnp.asarray(draft), jnp.asarray([n], jnp.int32),
                              jargs[1], jnp.asarray(slot_sched), jargs[2], page_size=PAGE)
    tok, pos0, slots = _i32(draft, [n], slot_sched)
    l1, single = tad.verify_step(tc, tp, s["single"], tok, pos0, torch.from_numpy(sched1), slots,
                                 torch.from_numpy(s["table1"]), page_size=PAGE)
    got = l1
    if layout == "grouped":
        got, tcaches = tad.verify_step(tc, tp, s["tcaches"], tok, pos0,
                                       {k: torch.from_numpy(v) for k, v in sched.items()}, slots,
                                       {k: torch.from_numpy(t) for k, t in tables.items()},
                                       page_size=PAGE)
        assert torch.equal(got, l1)
        _assert_pages_match_single(tc, tcaches, single, tables, s["table1"],
                                   -(-(n + S) // PAGE))
    assert got.shape == (1, S, jc.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), rtol=1e-2, atol=1e-2)
