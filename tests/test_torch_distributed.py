"""PyTorch port vs JAX package: process groups, hybrid meshes and the
collective audit (quantizedmha_tpu_torch/parallel/distributed.py,
profiling/collectives.py), the serving half of the JAX package's
tests/test_distributed.py and its tests/test_parallel.py:191.

The JAX package audits compiled HLO; the port records the collectives a
call issues as it runs. Its process-group cases run on 4 gloo CPU ranks (a
FileStore in a temporary directory), spawned once for the file by a
module-scoped fixture; JAX runs on the virtual CPU mesh of
tests/conftest.py. Counts and bytes are exact; the scaling model is pure
arithmetic and must equal JAX's to the last bit. This module imports jax
only inside the functions that compute the JAX side."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.parallel import (
    audit_bytes_by_axis,
    audit_fn_by_axis,
    classify_collectives,
    collective_bytes,
    context_parallel_attention,
    hybrid_mesh,
    initialize_multihost,
    make_mesh,
    model_scaling_efficiency,
    ring_attention,
    ring_attention_int8,
)
from quantizedmha_tpu_torch.parallel.distributed import Collective
from quantizedmha_tpu_torch.profiling.collectives import audit_fn
from quantizedmha_tpu_torch.serving.engine import EngineConfig
from quantizedmha_tpu_torch.serving.sharded import TPEngine

WORLD = 4
RING = dict(b=1, h=2, s=512, d=64)  # tests/test_parallel.py:205


def _qkv():
    rng = np.random.default_rng(42)
    shape = (RING["b"], RING["h"], RING["s"], RING["d"])
    return [rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(3)]


def _shard(x, rank):
    return torch.from_numpy(np.ascontiguousarray(np.split(x, WORLD, axis=2)[rank]))


def _report(rep):
    return {"counts": rep.counts, "bytes": rep.bytes_by_kind, "total": rep.total_bytes}


def _rank_main(rank, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        res = {"init": initialize_multihost()}  # an initialized group: its world size
        mesh = hybrid_mesh((2,), (2,), ("dp",), ("tp",), device_type="cpu")
        res["mesh"] = (mesh.mesh_dim_names, tuple(mesh.shape))
        try:
            hybrid_mesh((4,), (4,), ("dp",), ("tp",), device_type="cpu")
        except ValueError as e:
            res["too_many"] = str(e)
        x = torch.full((4,), float(rank))

        def both():
            a, b = x.clone(), x.clone()
            dist.all_reduce(a, group=mesh.get_group("tp"))
            dist.all_reduce(b, group=mesh.get_group("dp"))
            res["sums"] = (a[0].item(), b[0].item())
        res["by_axis"] = audit_fn_by_axis(both, granule_size=2)
        res["bytes_by_axis"] = audit_bytes_by_axis(both, granule_size=2)
        group = make_mesh((WORLD,), ("cp",), device_type="cpu").get_group("cp")
        q, k, v = (_shard(t, rank) for t in _qkv())
        res["ring"] = _report(audit_fn(ring_attention, q, k, v, group=group, causal=True))
        res["ring_int8"] = _report(audit_fn(ring_attention_int8, q, k, v, group=group,
                                            causal=True))
        qf = torch.from_numpy(_qkv()[0])
        res["cp"] = _report(audit_fn(context_parallel_attention, qf, k, v, group=group,
                                     causal=True))
        # One TP decode step (the second engine step: no admission left).
        cfg = tl.LlamaConfig.tiny(num_layers=3, num_heads=8, num_kv_heads=4,
                                  dtype=torch.float32)
        eng = TPEngine(cfg, tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                       EngineConfig(num_pages=16, page_size=16, max_batch=2,
                                    prefill_buckets=(16,), max_new_tokens=4),
                       make_mesh((WORLD,), ("tp",), device_type="cpu"), device="cpu")
        eng.add_request([1, 2, 3])
        eng.step()
        res["decode_step"] = _report(audit_fn(eng.step))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one spawn of WORLD gloo ranks for the file."""
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d)), nprocs=WORLD, join=True,
                       start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_initialize_single_process_is_noop_and_idempotent(monkeypatch):
    """No WORLD_SIZE and no init_method: nothing to coordinate, 1, twice,
    and no group left behind (tests/test_distributed.py:26)."""
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_multihost() == 1
    assert initialize_multihost() == 1
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost() == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize_multihost()


def test_hybrid_mesh_axes_shape_and_refusal(ranks):
    """hybrid_mesh((2,), (2,), ...) on 4 ranks: axes (dp, tp), shape (2, 2);
    one that needs more ranks than the world raises, with JAX's message
    (tests/test_distributed.py:31, :37)."""
    for r in ranks:
        assert r["init"] == WORLD  # already initialized: the world size
        assert r["mesh"] == (("dp", "tp"), (2, 2))
        assert r["too_many"] == "mesh needs 16 devices, have 4"


def test_classify_records_like_jax_hlo():
    """Recorded collectives classed by whether their ranks cross a granule,
    as JAX classes the same groups in HLO text (tests/test_distributed.py:42)."""
    from quantizedmha_tpu.parallel.distributed import classify_collectives as jclassify
    from quantizedmha_tpu.parallel.distributed import collective_bytes as jbytes

    records = [Collective("all-reduce", "float32", 32, (0, 1), 0.0),
               Collective("all-reduce", "float32", 32, (0, 2), 0.0),
               Collective("collective-permute", "float32", 32, (1, 0), 0.0),
               Collective("all-gather", "float32", 32, (0, 1, 2, 3), 0.0)]
    hlo = """
      a = f32[8]{0} all-reduce(x), replica_groups={{0,1},{2,3}}
      b = f32[8]{0} all-reduce(y), replica_groups={{0,2},{1,3}}
      c = f32[8]{0} collective-permute(z), source_target_pairs={{0,1},{1,0}}
      d = f32[8]{0} all-gather(w), replica_groups={{0,1,2,3}}
    """
    got = classify_collectives(records, granule_size=2)
    assert got == jclassify(hlo, granule_size=2)
    assert got == {"ici": {"all-reduce": 1, "collective-permute": 1},
                   "dcn": {"all-reduce": 1, "all-gather": 1}}
    assert collective_bytes(records, granule_size=2) == jbytes(hlo, granule_size=2)


def test_axis_classification_on_hybrid_mesh(ranks):
    """An all_reduce over "tp" (inside a granule of 2) lands in "ici", one
    over "dp" in "dcn", with the right sums (tests/test_distributed.py:71)."""
    for rank, r in enumerate(ranks):
        dp, tp = divmod(rank, 2)
        assert r["sums"] == (float(2 * dp + 2 * dp + 1), float(tp + 2 + tp))
        assert r["by_axis"] == {"ici": {"all-reduce": 1}, "dcn": {"all-reduce": 1}}
        assert r["bytes_by_axis"] == {"ici": 16, "dcn": 16}


@pytest.mark.parametrize("step_s,dcn_bytes,kw", [
    (0.02, 0.0, {}), (0.02, 1e6, {}), (1.5, 4e9, {}), (0.004, 3e7, dict(dcn_gbps=100.0)),
    (0.1, 1.0, dict(latency_s=1e-3))])
def test_model_scaling_efficiency_matches_jax(step_s, dcn_bytes, kw):
    from quantizedmha_tpu.parallel.distributed import model_scaling_efficiency as jmodel

    assert model_scaling_efficiency(step_s, dcn_bytes, **kw) == jmodel(step_s, dcn_bytes, **kw)


def _jax_ring_audits():
    """JAX's audit of its rings on the 4-device "cp" mesh
    (tests/test_parallel.py:191): static counts, one scan step's bytes."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantizedmha_tpu.parallel import make_mesh as jmake_mesh
    from quantizedmha_tpu.parallel.ring import ring_attention as jring, ring_attention_int8
    from quantizedmha_tpu.profiling.collectives import audit_fn as jaudit

    mesh = jmake_mesh((WORLD,), ("cp",))
    q, k, v = (jnp.asarray(x) for x in _qkv())
    spec = P(None, None, "cp", None)
    out = {}
    for name, fn in (("ring", jring), ("ring_int8", ring_attention_int8)):
        f = jax.jit(jax.shard_map(functools.partial(fn, axis_name="cp", causal=True),
                                  mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                                  check_vma=False))
        out[name] = jaudit(f, q, k, v)
    return out


def test_ring_audits_match_jax(ranks):
    """ring_attention issues 2 collective-permutes a step (K and V) and
    ring_attention_int8 4 (payloads and scales) at under 1/3.5 of the bytes;
    a step's bytes equal JAX's static audit of one scan step; context
    parallelism issues at most 3 collectives (tests/test_parallel.py:191)."""
    jax_rep = _jax_ring_audits()
    steps = WORLD - 1
    for r in ranks:
        ring, ring8 = r["ring"], r["ring_int8"]
        assert ring["counts"] == {"collective-permute": 2 * steps}
        assert ring8["counts"] == {"collective-permute": 4 * steps}
        assert ring8["total"] < ring["total"] / 3.5
        assert ring["total"] == steps * jax_rep["ring"].total_bytes
        assert ring8["total"] == steps * jax_rep["ring_int8"].total_bytes
        assert jax_rep["ring"].counts == {"collective-permute": 2}
        assert sum(r["cp"]["counts"].values()) <= 3
        assert r["cp"]["counts"] == {"all-reduce": 2}


def test_tp_decode_step_issues_two_all_reduces_a_layer(ranks):
    """A TP decode step at batch 2 (the engine's max_batch lanes) over 3
    layers: 2 all-reduces a layer (after wo and after w_down), each of
    [2, 1, hidden] f32, and nothing else."""
    hidden = tl.LlamaConfig.tiny().hidden_size
    for r in ranks:
        assert r["decode_step"]["counts"] == {"all-reduce": 2 * 3}
        assert r["decode_step"]["total"] == 2 * 3 * 2 * hidden * 4
