"""PyTorch port vs JAX package: gradients through the cross-rank entries
(quantizedmha_tpu_torch/parallel: merge_partial_attention,
context_parallel_attention, ring_attention, ring_attention_int8).

The port runs on a gloo process group of 4 CPU ranks (a FileStore in a
temporary directory; a 1-D "cp" mesh), spawned once for the file by a
module-scoped fixture that runs every case and returns each rank's
gradients. Each rank back-propagates the global loss sum(out * ct) (ct a
seeded cotangent: whole on every rank where the output is replicated, the
rank's rows where it is sharded), and its gradients must equal its shard
of jax.grad of that loss through JAX's shard_map version on the virtual
CPU mesh of tests/conftest.py, under jax.jit, the Pallas kernels in
interpret mode. This module imports jax only inside the functions that
compute the JAX side, since each spawned rank imports it.

Tolerance (f32): both sides run the same online softmax forward, the same
merges and the same flash backward algorithm; XLA and PyTorch sum the dS,
dP and merge terms in other orders and round exp differently, which moves
a gradient of magnitude < 10 by a few hundred f32 ulps: atol = 2e-5 times
max(1, the largest |gradient| of the case). The INT8 ring's backward is
the float ring's at the dequantized K/V on both sides (JAX's custom VJP),
so it is held at the same tolerance."""

import datetime
import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantizedmha_tpu_torch.parallel import (
    context_parallel_attention,
    make_mesh,
    merge_partial_attention,
    ring_attention,
    ring_attention_int8,
)

WORLD = 4
WIN = dict(window=48, attention_sinks=8, logit_softcap=30.0)
REL_ATOL = 2e-5


def _qkv(seed, b=1, h=2, hkv=None, s=128, d=32):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, s, d), (b, hkv or h, s, d), (b, hkv or h, s, d))
    return tuple(rng.normal(0, 0.5, shp).astype(np.float32) for shp in shapes)


# name: (entry, qkv arguments, keyword arguments). "cp_suffix" takes q as
# the sequence's last 32 rows.
CASES = {
    "cp": ("cp", dict(seed=1), dict(causal=False)),
    "cp_causal": ("cp", dict(seed=2, h=4, hkv=2), dict(causal=True)),
    "cp_suffix_causal": ("cp_suffix", dict(seed=3), dict(causal=True)),
    "window_cp": ("cp", dict(seed=4, s=256), dict(causal=True, **WIN)),
    "ring": ("ring", dict(seed=5), dict(causal=False)),
    "ring_causal": ("ring", dict(seed=6, h=4, hkv=2), dict(causal=True)),
    "window_ring": ("ring", dict(seed=7, s=256), dict(causal=True, **WIN)),
    "ring_int8_causal": ("ring_int8", dict(seed=8), dict(causal=True, block_kv=32)),
    "ring_int8": ("ring_int8", dict(seed=9), dict(causal=False, block_kv=32)),
    "window_ring_int8": ("ring_int8", dict(seed=10, s=256), dict(causal=True, **WIN)),
}


def _ct(seed, shape):
    return np.random.default_rng(seed + 100).normal(0, 1.0, shape).astype(np.float32)


def _merge_inputs():
    """One partial a rank: rank 2's rows all fully masked (lse = -inf,
    o = 0) and row 3 masked on every rank."""
    rng = np.random.default_rng(40)
    o = rng.normal(0, 0.5, (WORLD, 2, 16, 8)).astype(np.float32)
    lse = rng.normal(0, 2.0, (WORLD, 2, 16)).astype(np.float32)
    o[2], lse[2] = 0.0, -np.inf
    o[:, :, 3], lse[:, :, 3] = 0.0, -np.inf
    return o, lse


def _shard(x, rank, dim=2):
    return torch.from_numpy(np.ascontiguousarray(np.split(x, WORLD, axis=dim)[rank]))


def _case_grads(rank, group, entry, qkv, kw, ct):
    """The rank's (dq, dk, dv) of sum(out * ct) through the entry."""
    q, k, v = qkv
    ks, vs = (_shard(x, rank).requires_grad_() for x in (k, v))
    if entry.startswith("cp"):
        qq = q[:, :, -32:] if entry == "cp_suffix" else q
        qt = torch.from_numpy(np.ascontiguousarray(qq)).requires_grad_()
        out = context_parallel_attention(qt, ks, vs, group=group, **kw)
        ct_t = torch.from_numpy(ct)
    else:
        qt = _shard(q, rank).requires_grad_()
        fn = ring_attention if entry == "ring" else ring_attention_int8
        out = fn(qt, ks, vs, group=group, **kw)
        ct_t = _shard(ct, rank)
    (out * ct_t).sum().backward()
    return qt.grad, ks.grad, vs.grad


def _rank_main(rank, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        group = make_mesh((WORLD,), ("cp",), device_type="cpu").get_group("cp")
        res = {}
        for name, (entry, qkv_kw, kw) in CASES.items():
            qkv = _qkv(**qkv_kw)
            rows = 32 if entry == "cp_suffix" else qkv[0].shape[2]
            ct = _ct(qkv_kw["seed"], qkv[0].shape[:2] + (rows, qkv[0].shape[3]))
            res[name] = _case_grads(rank, group, entry, qkv, kw, ct)
        o, lse = _merge_inputs()
        ot, lt = (torch.from_numpy(x[rank]).requires_grad_() for x in (o, lse))
        (merge_partial_attention(ot, lt, group) * torch.from_numpy(_ct(40, o.shape[1:]))
         ).sum().backward()
        res["merge"] = (ot.grad, lt.grad)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's gradients: one spawn of WORLD gloo ranks for the file."""
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d)), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# --- the JAX side -----------------------------------------------------------


def _jax_grads(entry, qkv, kw, ct):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantizedmha_tpu.parallel import (
        context_parallel_attention as jcp,
        make_mesh as jmake_mesh,
        ring_attention as jring,
    )
    from quantizedmha_tpu.parallel.ring import ring_attention_int8 as jring8

    mesh = jmake_mesh((WORLD,), ("cp",))
    q, k, v = (jnp.asarray(x) for x in qkv)
    seq, rep = P(None, None, "cp", None), P(None, None, None, None)
    if entry.startswith("cp"):
        fn, specs, out = jcp, (rep, seq, seq), rep
        if entry == "cp_suffix":
            q = q[:, :, -32:]
    else:
        fn, specs, out = (jring if entry == "ring" else jring8), (seq,) * 3, seq
    f = jax.shard_map(functools.partial(fn, axis_name="cp", **kw), mesh=mesh,
                      in_specs=specs, out_specs=out, check_vma=False)
    ct = jnp.asarray(ct)
    g = jax.jit(jax.grad(lambda q, k, v: (f(q, k, v) * ct).sum(), argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in g]


def _close(got, want):
    atol = REL_ATOL * max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# --- tests ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_cross_rank_grads_match_jax(ranks, name):
    """Each rank's dq, dk and dv equal its shard of jax.grad through JAX's
    shard_map version (context parallelism: dq whole on every rank, the
    all-reduce of copy_to_group's backward; rings: the rank's rows, dK / dV
    sent back around the ring), causal and not, q a suffix, windows, sinks
    and softcap across shards (JAX tests/test_parallel.py:233), the INT8
    ring by its straight-through VJP at block_kv 32 (JAX
    tests/test_parallel.py:265 at half its length)."""
    entry, qkv_kw, kw = CASES[name]
    qkv = _qkv(**qkv_kw)
    rows = 32 if entry == "cp_suffix" else qkv[0].shape[2]
    ct = _ct(qkv_kw["seed"], qkv[0].shape[:2] + (rows, qkv[0].shape[3]))
    want = _jax_grads(entry, qkv, kw, ct)
    for rank, r in enumerate(ranks):
        dq, dk, dv = (x.numpy() for x in r[name])
        if entry.startswith("cp"):
            _close(dq, want[0])
        else:
            _close(dq, np.split(want[0], WORLD, axis=2)[rank])
        _close(dk, np.split(want[1], WORLD, axis=2)[rank])
        _close(dv, np.split(want[2], WORLD, axis=2)[rank])


def test_merge_partial_attention_grad_matches_jax(ranks):
    """merge_partial_attention's gradients in o and lse (the pmax a
    constant, as JAX's stop_gradient makes it; the tuple psum's transpose)
    equal jax.grad of JAX's merge with its output replicated: a rank fully
    masked (zero gradients, no NaN) and a row masked on every rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantizedmha_tpu.parallel import make_mesh as jmake_mesh
    from quantizedmha_tpu.parallel import merge_partial_attention as jmerge

    o, lse = _merge_inputs()
    ct = jnp.asarray(_ct(40, o.shape[1:]))
    f = jax.shard_map(lambda a, b: jmerge(a[0], b[0], "cp"), mesh=jmake_mesh((WORLD,), ("cp",)),
                      in_specs=(P("cp"), P("cp")), out_specs=P(), check_vma=False)
    want = jax.jit(jax.grad(lambda a, b: (f(a, b) * ct).sum(), argnums=(0, 1)))(
        jnp.asarray(o), jnp.asarray(lse))
    for rank, r in enumerate(ranks):
        for got, w in zip(r["merge"], want):
            _close(got.numpy(), np.asarray(w)[rank])
