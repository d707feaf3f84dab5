"""PyTorch port vs JAX package: context-parallel prefill in the serving path
(llama_adapter.prefill_cp_at, EngineConfig.cp_mesh), the cases of the JAX
package's tests/test_cp_prefill.py.

The port runs on a gloo process group of 4 CPU ranks (a FileStore in a
temporary directory), spawned once for the file by a module-scoped fixture
that runs every case and returns each rank's results. JAX runs its
shard_map versions on the virtual CPU mesh of tests/conftest.py. This
module imports jax only inside the functions that compute the JAX side.

Tolerance: both sides run the same f32 ring (per-step online softmax, the
exact merge in f32) with attention_impl="reference" elsewhere; XLA and
PyTorch order the exps and sums differently, so prefill logits (|x| < 5)
and K/V (|x| < 5) are held at atol 2e-5 (about 40 f32 ulps at 4). Token
streams must be equal."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.parallel import make_mesh, record_collectives
from quantizedmha_tpu_torch.profiling.collectives import audit_events
from quantizedmha_tpu_torch.serving import llama_adapter as LA
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
N = 128
LAST = N - 9  # padded-bucket semantics: the last real token inside shard 3
WINDOWS = {"full": {}, "window": {"sliding_window": 64, "attention_sinks": 8}}
ATOL = 2e-5
MODEL = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
             num_heads=4, num_kv_heads=2, attention_impl="reference")
ENGINE = dict(num_pages=32, page_size=32, max_batch=2, prefill_buckets=(128,),
              max_new_tokens=8, max_pages_per_seq=8, decode_chunk=4)


def _cfg(**kw):
    return tl.LlamaConfig(dtype=torch.float32, **MODEL, **kw)


def _tokens():
    return np.random.default_rng(42).integers(1, 256, (1, N)).astype(np.int32)


def _engine_prompts():
    rng = np.random.default_rng(43)
    return [rng.integers(1, 256, 100).tolist() for _ in range(2)]


def _serve(cfg, params, cp_mesh):
    eng = Engine(cfg, params, EngineConfig(**ENGINE, cp_mesh=cp_mesh), device="cpu")
    for p in _engine_prompts():
        eng.add_request(list(p), max_new=8)
    eng.run()
    return [eng.finished[rid] for rid in sorted(eng.finished)]


def _rank_main(rank, store, out_dir, trees):
    """One gloo rank: each window setting's CP prefill (and the unsharded
    one), the CP engine, the indivisible-bucket refusal."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_mesh((WORLD,), ("cp",), device_type="cpu")
        group = mesh.get_group("cp")
        toks = torch.from_numpy(_tokens())
        shard = N // WORLD
        res = {}
        for name, kw in WINDOWS.items():
            cfg = _cfg(**kw)
            params = params_from_numpy(trees[name], device="cpu")
            with record_collectives() as records:
                got = LA.prefill_cp_at(cfg, params, toks[:, rank * shard:(rank + 1) * shard],
                                       LAST, group=group)
            rep = audit_events(records)
            res[name] = {"cp": got, "plain": LA.prefill_at(cfg, params, toks, LAST),
                         "audit": (rep.counts, rep.bytes_by_kind)}
        cfg = _cfg()
        params = params_from_numpy(trees["engine"], device="cpu")
        res["engine"] = {"cp": _serve(cfg, params, mesh), "plain": _serve(cfg, params, None)}
        try:
            Engine(cfg, params, EngineConfig(num_pages=32, page_size=2, max_batch=2,
                                             prefill_buckets=(34,), max_pages_per_seq=32,
                                             cp_mesh=mesh), device="cpu")
            res["refusal"] = None
        except ValueError as e:
            res["refusal"] = str(e)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- the JAX side -----------------------------------------------------------


def _jax_params(seed, **kw):
    import jax
    import jax.numpy as jnp

    from quantizedmha_tpu.models import llama as jl

    jc = jl.LlamaConfig(dtype=jnp.float32, **MODEL, **kw)
    return jc, jl.init_params(jc, jax.random.PRNGKey(seed))


def _jax_cp_prefill(name):
    """JAX's prefill_cp_at under shard_map on a 4-device "cp" mesh
    (tests/test_cp_prefill.py:38): (logits, K, V) reassembled."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantizedmha_tpu.parallel import make_mesh as jmake_mesh
    from quantizedmha_tpu.serving import llama_adapter as JLA

    jc, jp = _jax_params(0, **WINDOWS[name])
    fn = functools.partial(JLA.prefill_cp_at, jc, axis_name="cp")
    kv = P(None, None, "cp", None)
    sm = jax.shard_map(lambda p, t, li: fn(p, t, li), mesh=jmake_mesh((WORLD,), ("cp",)),
                       in_specs=(P(), P(None, "cp"), P()), out_specs=(P(), kv, kv),
                       check_vma=False)
    return [np.asarray(x) for x in sm(jp, jnp.asarray(_tokens()), jnp.int32(LAST))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one spawn of WORLD gloo ranks for the file."""
    import jax

    def tree(seed, **kw):
        return jax.tree_util.tree_map(np.asarray, _jax_params(seed, **kw)[1])
    trees = {name: tree(0, **kw) for name, kw in WINDOWS.items()}
    trees["engine"] = tree(1)
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d), trees), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# --- tests ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(WINDOWS))
def test_prefill_cp_matches_jax_and_unsharded(ranks, name):
    """prefill_cp_at over 4 gloo ranks: every rank holds the same logits and
    the whole prompt's K/V (gathered once), equal to JAX's CP prefill and
    to the port's unsharded prefill_at within ATOL, windowed or not
    (tests/test_cp_prefill.py:46)."""
    want = _jax_cp_prefill(name)
    for r in ranks:
        got = [x.numpy() for x in r[name]["cp"]]
        assert got[1].shape == (2, 2, N, 32)
        for g, w, p in zip(got, want, r[name]["plain"]):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
            np.testing.assert_allclose(g, p.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got[0], ranks[0][name]["cp"][0].numpy())


@pytest.mark.parametrize("name", list(WINDOWS))
def test_prefill_cp_collectives(ranks, name):
    """What one CP prefill issues on each rank: 2 collective-permutes (K, V)
    a ring step, 3 steps that rotate a layer, and one all-gather of every
    rank's K/V and the last token's hidden row; nothing else."""
    layers, hkv, hd, shard = 2, 2, 32, N // WORLD
    for r in ranks:
        counts, nbytes = r[name]["audit"]
        assert counts == {"collective-permute": 2 * (WORLD - 1) * layers, "all-gather": 1}
        assert nbytes["collective-permute"] == 2 * (WORLD - 1) * layers * hkv * shard * hd * 4
        assert nbytes["all-gather"] == WORLD * (2 * layers * hkv * shard * hd + 128) * 4


def test_engine_cp_prefill_same_tokens_as_jax(ranks):
    """An engine with cp_mesh emits the same streams on every rank as the
    port's plain engine and as JAX's engine with a cp mesh
    (tests/test_cp_prefill.py:65)."""
    from quantizedmha_tpu.parallel import make_mesh as jmake_mesh
    from quantizedmha_tpu.serving.engine import Engine as JEngine
    from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig

    jc, jp = _jax_params(1)
    eng = JEngine(jc, jp, JEngineConfig(**ENGINE, cp_mesh=jmake_mesh((WORLD,), ("cp",))))
    for p in _engine_prompts():
        eng.add_request(list(p), max_new=8)
    eng.run()
    want = [eng.finished[rid] for rid in sorted(eng.finished)]
    for r in ranks:
        assert r["engine"]["cp"] == want == r["engine"]["plain"]


def test_engine_cp_rejects_indivisible_buckets(ranks):
    """A bucket that is not a multiple of the cp axis raises ValueError
    naming the cp axis (tests/test_cp_prefill.py:91: 36 over 8 devices;
    here 34 over 4 ranks)."""
    for r in ranks:
        assert r["refusal"] is not None and "cp axis" in r["refusal"]
