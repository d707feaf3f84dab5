"""PyTorch port vs JAX package: the device mesh, head-parallel attention,
the cross-rank merge and ring attention (quantizedmha_tpu_torch/parallel).

The port runs on gloo process groups of 4 CPU ranks (a FileStore in a
temporary directory; a 1-D "cp" mesh and a 2 x 2 ("dp", "tp") mesh),
spawned once for the file by a module-scoped fixture that runs every case
and returns each rank's results. JAX runs its shard_map versions on the
virtual CPU mesh of tests/conftest.py under jax.jit, its Pallas kernels in
interpret mode; this module imports jax only inside the functions that
compute the JAX side, since each spawned rank imports it. (Jitted, XLA may
divide a scale by 127 through the reciprocal: the payload test holds the
shards to JAX's eager quantize_kv_blocks.)

Tolerances. Float paths: both sides run the same online softmax and the
same exact merge in f32; exp ulps and summation order differ between XLA
and PyTorch, so atol = 2e-5 on outputs of magnitude < 2 (~80 f32 ulps).
INT8 paths: payloads and scales are bit-exact per shard; a P' within an ulp
of a rounding tie may round the other way on one side, which moves one
step's output by at most max|v| / 127, and a merge weighs each step's
output by at most 1, so atol = max|v| / 127 + 1e-5."""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import chip_smoke
from quantizedmha_tpu_torch.parallel import (
    context_parallel_attention,
    head_parallel_attention,
    make_mesh,
    merge_partial_attention,
    ring_attention,
    ring_attention_int8,
)
from quantizedmha_tpu_torch.parallel.mesh import infer_dp_tp
from quantizedmha_tpu_torch.parallel.ring import quantize_shard

WORLD = 4
WIN = dict(window=48, attention_sinks=8, logit_softcap=30.0)
FLOAT_ATOL = 2e-5


def _qkv(seed, b=1, h=2, hkv=None, s=256, d=32):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, s, d), (b, hkv or h, s, d), (b, hkv or h, s, d))
    return tuple(rng.normal(0, 0.5, shp).astype(np.float32) for shp in shapes)


# name: (entry, qkv arguments, keyword arguments). Sequence-sharded over
# the 1-D "cp" mesh; "cp_suffix" takes q as the sequence's last 64 rows.
SEQ_CASES = {
    "cp": ("cp", dict(seed=1), dict(causal=False)),
    "cp_causal": ("cp", dict(seed=2), dict(causal=True)),
    "cp_suffix": ("cp_suffix", dict(seed=3), dict(causal=False)),
    "cp_suffix_causal": ("cp_suffix", dict(seed=4), dict(causal=True)),
    "ring": ("ring", dict(seed=5), dict(causal=False)),
    "ring_causal": ("ring", dict(seed=6), dict(causal=True)),
    "ring_int8": ("ring_int8", dict(seed=7), dict(causal=False, block_kv=32)),
    "ring_int8_causal": ("ring_int8", dict(seed=8), dict(causal=True, block_kv=32)),
    "ring_int8_d128_causal": ("ring_int8", dict(seed=9, s=128, d=128),
                              dict(causal=True, block_kv=16)),
    "window_ring": ("ring", dict(seed=10), dict(causal=True, **WIN)),
    "window_ring_int8": ("ring_int8", dict(seed=11), dict(causal=True, **WIN)),
    "window_cp": ("cp", dict(seed=12), dict(causal=True, **WIN)),
}
# Heads (and batch) sharded over the 2 x 2 mesh.
HEAD_CASES = {
    "head": (dict(seed=20, b=2, h=8, s=128), dict(causal=True, kernel="fa")),
    "head_gqa": (dict(seed=21, b=2, h=8, hkv=4, s=128), dict(causal=True, kernel="fa")),
    "head_int8_d128": (dict(seed=22, b=2, h=4, hkv=2, s=128, d=128),
                       dict(causal=True, kernel="fa_int8")),
    "head_int8_d32": (dict(seed=23, b=2, h=4, s=128), dict(causal=False, kernel="fa_int8")),
}
GRAD_CASE = dict(seed=30, b=2, h=4, hkv=2, s=64)
# The cross-rank entries' gradients against the unsharded flash kernel's
# (entry: qkv arguments, keyword arguments); cp takes q whole.
CROSS_GRAD = {"context_parallel_attention": (dict(seed=31, h=4, hkv=2, s=64), dict(causal=True)),
              "ring_attention": (dict(seed=32, h=4, hkv=2, s=64), dict(causal=True)),
              "ring_attention_int8": (dict(seed=33, s=64), dict(causal=True, block_kv=8))}


def _merge_inputs():
    """One partial a rank: rank 2's rows all fully masked (lse = -inf,
    o = 0) and row 3 masked on every rank (the zero-sum guard)."""
    rng = np.random.default_rng(40)
    o = rng.normal(0, 0.5, (WORLD, 2, 16, 8)).astype(np.float32)
    lse = rng.normal(0, 2.0, (WORLD, 2, 16)).astype(np.float32)
    o[2], lse[2] = 0.0, -np.inf
    o[:, :, 3], lse[:, :, 3] = 0.0, -np.inf
    return o, lse


def _shard(x, rank, dim=2):
    return torch.from_numpy(np.ascontiguousarray(np.split(x, WORLD, axis=dim)[rank]))


def _seq_case(rank, group, entry, qkv, kw):
    q, k, v = qkv
    ks, vs = _shard(k, rank), _shard(v, rank)
    if entry in ("cp", "cp_suffix"):
        qq = q[:, :, -64:] if entry == "cp_suffix" else q
        return {"out": context_parallel_attention(torch.from_numpy(np.ascontiguousarray(qq)),
                                                  ks, vs, group=group, **kw)}
    if entry == "ring":
        return {"out": ring_attention(_shard(q, rank), ks, vs, group=group, **kw)}
    block_kv = kw.get("block_kv", 512)
    return {"out": ring_attention_int8(_shard(q, rank), ks, vs, group=group, **kw),
            "payloads": quantize_shard(ks, vs, block_kv)}


def _cross_ct(entry):
    """A seeded cotangent of the entry's whole output (a linear loss: the
    INT8 ring's straight-through gradient does not depend on its forward)."""
    qkv_kw, _ = CROSS_GRAD[entry]
    q = _qkv(**qkv_kw)[0]
    return torch.from_numpy(np.random.default_rng(qkv_kw["seed"]).normal(
        0, 1.0, q.shape).astype(np.float32))


def _cross_grads(rank, group):
    """Each entry's (dq, dk, dv) of sum(out * ct) on this rank, and the
    merge's (do, dlse) of sum(merged²)."""
    out = {}
    for entry, (qkv_kw, kw) in CROSS_GRAD.items():
        q, k, v = _qkv(**qkv_kw)
        ks, vs = (_shard(x, rank).requires_grad_() for x in (k, v))
        if entry == "context_parallel_attention":
            qt = torch.from_numpy(q).requires_grad_()
            o = context_parallel_attention(qt, ks, vs, group=group, **kw)
            ct = _cross_ct(entry)
        else:
            qt = _shard(q, rank).requires_grad_()
            fn = ring_attention if entry == "ring_attention" else ring_attention_int8
            o = fn(qt, ks, vs, group=group, **kw)
            ct = _cross_ct(entry).chunk(WORLD, dim=2)[rank]
        (o * ct).sum().backward()
        out[entry] = (qt.grad, ks.grad, vs.grad)
    o, lse = _merge_inputs()
    ot, lt = (torch.from_numpy(x[rank]).requires_grad_() for x in (o, lse))
    (merge_partial_attention(ot, lt, group) ** 2).sum().backward()
    out["merge_partial_attention"] = (ot.grad, lt.grad)
    return out


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank, store, out_dir):
    """One gloo rank: every case of the file, its results saved for the
    parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        cp_mesh = make_mesh((WORLD,), ("cp",), device_type="cpu")
        mesh = make_mesh((2, 2), ("dp", "tp"), device_type="cpu")
        wide = make_mesh((1, WORLD), ("dp", "tp"), device_type="cpu")
        res = {"coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))}
        group = cp_mesh.get_group("cp")
        for name, (entry, qkv_kw, kw) in SEQ_CASES.items():
            res[name] = _seq_case(rank, group, entry, _qkv(**qkv_kw), kw)
        for name, (qkv_kw, kw) in HEAD_CASES.items():
            q, k, v = (torch.from_numpy(x) for x in _qkv(**qkv_kw))
            res[name] = head_parallel_attention(q, k, v, mesh, **kw)
        o, lse = _merge_inputs()
        res["merge"] = merge_partial_attention(torch.from_numpy(o[rank]),
                                               torch.from_numpy(lse[rank]), group)
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(**GRAD_CASE))
        (head_parallel_attention(q, k, v, mesh, causal=True) ** 2).sum().backward()
        grads = [x.grad for x in (q, k, v)]
        for g in grads:
            dist.all_reduce(g)
        res["grads"] = grads
        res["cross_grads"] = _cross_grads(rank, group)
        q, k, v = (torch.from_numpy(x) for x in _qkv(seed=50, b=1, h=8, hkv=2, s=64))
        res["gqa_error"] = _error(lambda: head_parallel_attention(q, k, v, wide))
        res["mesh_error"] = _error(lambda: make_mesh((2 * WORLD,), ("x",), device_type="cpu"))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one spawn of WORLD gloo ranks for the file."""
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d)), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# --- the JAX side -----------------------------------------------------------


def _jax_seq(entry, qkv, kw):
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
    seq = P(None, None, "cp", None)
    if entry in ("cp", "cp_suffix"):
        fn, specs, out = jcp, (P(None, None, None, None), seq, seq), P(None, None, None, None)
        if entry == "cp_suffix":
            q = q[:, :, -64:]
    else:
        fn, specs, out = (jring if entry == "ring" else jring8), (seq,) * 3, seq
    f = jax.shard_map(functools.partial(fn, axis_name="cp", **kw), mesh=mesh,
                      in_specs=specs, out_specs=out, check_vma=False)
    return np.asarray(jax.jit(f)(q, k, v))


def _jax_head(qkv, kw):
    import jax
    import jax.numpy as jnp

    from quantizedmha_tpu.parallel import head_parallel_attention as jhead, make_mesh

    mesh = make_mesh((2, 2), ("dp", "tp"))
    f = jax.jit(lambda q, k, v: jhead(q, k, v, mesh, **kw))
    return np.asarray(f(*(jnp.asarray(x) for x in qkv)))


def _gathered_heads(ranks, name):
    """The [b, h, s, d] output from each rank's (dp, tp) block."""
    blocks = {r["coords"]: r[name].numpy() for r in ranks}
    return np.concatenate([np.concatenate([blocks[(i, j)] for j in range(2)], axis=1)
                           for i in range(2)], axis=0)


def _seq_output(ranks, name, entry):
    if entry in ("cp", "cp_suffix"):
        outs = [r[name]["out"].numpy() for r in ranks]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])  # every rank holds the merge
        return outs[0]
    return np.concatenate([r[name]["out"].numpy() for r in ranks], axis=2)


def _atol(entry, v):
    return float(np.abs(v).max()) / 127.0 + 1e-5 if "int8" in entry else FLOAT_ATOL


# --- tests ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_sequence_parallel_matches_jax(ranks, name):
    """context_parallel_attention, ring_attention and ring_attention_int8
    over 4 gloo ranks equal JAX's shard_map versions (tests/test_parallel.py
    :67, :85, :107, :156, :233): causal and not, q a suffix, windows, sinks
    and softcap across shards, INT8 at head_dim 32 (bf16 P) and 128 (int8
    P)."""
    entry, qkv_kw, kw = SEQ_CASES[name]
    qkv = _qkv(**qkv_kw)
    got = _seq_output(ranks, name, entry)
    want = _jax_seq(entry, qkv, kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(entry, qkv[2]))


@pytest.mark.parametrize("name", [n for n, c in SEQ_CASES.items() if c[0] == "ring_int8"])
def test_int8_ring_payloads_bit_exact_per_shard(ranks, name):
    """Each rank's int8 payloads and scales equal JAX's quantize_kv_blocks of
    its shard bit for bit (block_kv falls back to the shard length when it
    does not divide it, as in JAX)."""
    import jax.numpy as jnp

    from quantizedmha_tpu.ops.quantize import quantize_kv_blocks

    _, qkv_kw, kw = SEQ_CASES[name]
    _, k, v = _qkv(**qkv_kw)
    shard = k.shape[2] // WORLD
    bkv = kw.get("block_kv", 512)
    bkv = bkv if shard % bkv == 0 else shard
    for rank, r in enumerate(ranks):
        want = []
        for x in (k, v):
            want += [np.asarray(a) for a in quantize_kv_blocks(
                jnp.asarray(np.split(x, WORLD, axis=2)[rank]), bkv)]
        for got, w in zip(r[name]["payloads"], want):
            np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_head_parallel_matches_jax(ranks, name):
    """head_parallel_attention on the 2 x 2 mesh, the blocks gathered, equals
    JAX's (tests/test_parallel.py :58 and the GQA case :179; fa and fa_int8,
    at head_dim 128 causal the int8-P route, at 32 bf16 P)."""
    qkv_kw, kw = HEAD_CASES[name]
    qkv = _qkv(**qkv_kw)
    got = _gathered_heads(ranks, name)
    want = _jax_head(qkv, kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(kw["kernel"], qkv[2]))


def test_merge_partial_attention_matches_jax(ranks):
    """One partial a rank, a rank fully masked and a row masked on every
    rank: every rank holds JAX's merged output (pmax + one tuple psum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantizedmha_tpu.parallel import make_mesh as jmake_mesh
    from quantizedmha_tpu.parallel import merge_partial_attention as jmerge

    o, lse = _merge_inputs()
    f = jax.shard_map(lambda a, b: jmerge(a[0], b[0], "cp")[None], mesh=jmake_mesh(
        (WORLD,), ("cp",)), in_specs=(P("cp"), P("cp")), out_specs=P("cp"), check_vma=False)
    want = np.asarray(f(jnp.asarray(o), jnp.asarray(lse)))
    for rank, r in enumerate(ranks):
        got = r["merge"].numpy()
        assert np.isfinite(got).all() and not got[:, 3].any()
        np.testing.assert_allclose(got, want[rank], rtol=0, atol=FLOAT_ATOL)


def test_head_parallel_grad_matches_jax(ranks):
    """head_parallel_attention(kernel="fa") keeps flash_attention's gradient:
    each rank's loss on its block, the gradients summed over the 2 x 2 gloo
    mesh, equal jax.grad of JAX's within atol 1e-4 (the two backwards sum
    dS and dP in other orders, f32, gradients of magnitude < 10)."""
    import jax
    import jax.numpy as jnp

    from quantizedmha_tpu.parallel import head_parallel_attention as jhead, make_mesh

    mesh = make_mesh((2, 2), ("dp", "tp"))
    loss = lambda q, k, v: (jhead(q, k, v, mesh, causal=True) ** 2).sum()  # noqa: E731
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x)
                                                         for x in _qkv(**GRAD_CASE)))
    for got in (r["grads"] for r in ranks):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_simulated_ranks_equal_the_gloo_ring(ranks):
    """chip_smoke's simulated ring (one process, each rank's steps fed the
    blocks in ring order) gives the gloo run's output bit for bit."""
    for name, (entry, qkv_kw, kw) in SEQ_CASES.items():
        if not entry.startswith("ring"):
            continue
        q, k, v = (torch.from_numpy(x) for x in _qkv(**qkv_kw))
        got = chip_smoke.simulate_ring(q, k, v, WORLD, int8=entry == "ring_int8", **kw)
        np.testing.assert_array_equal(got.numpy(), _seq_output(ranks, name, entry))


def test_simulated_context_parallel_close_to_gloo(ranks):
    """chip_smoke's simulated context parallelism (the partials merged by a
    sum in rank order) equals the gloo run's all-reduce within f32 order."""
    for name, (entry, qkv_kw, kw) in SEQ_CASES.items():
        if not entry.startswith("cp"):
            continue
        q, k, v = (torch.from_numpy(x) for x in _qkv(**qkv_kw))
        if entry == "cp_suffix":
            q = q[:, :, -64:].contiguous()
        got = chip_smoke.simulate_context_parallel(q, k, v, WORLD, **kw)
        np.testing.assert_allclose(got.numpy(), _seq_output(ranks, name, entry),
                                   rtol=0, atol=1e-6)


def test_mesh_errors_match_jax(ranks):
    """make_mesh past the world raises JAX's message; a head axis that does
    not divide the kv heads raises ValueError as JAX's shard_map does."""
    import jax.numpy as jnp

    from quantizedmha_tpu.parallel import head_parallel_attention as jhead, make_mesh

    with pytest.raises(ValueError, match="evenly divid") as jerr:
        q, k, v = (jnp.asarray(x) for x in _qkv(seed=50, b=1, h=8, hkv=2, s=64))
        jhead(q, k, v, make_mesh((1, WORLD), ("dp", "tp")))
    with pytest.raises(ValueError) as jmesh:
        make_mesh((16,), ("x",))
    for r in ranks:
        assert r["mesh_error"] == f"mesh needs {2 * WORLD} devices, have {WORLD}"
        assert str(jmesh.value) == "mesh needs 16 devices, have 8"
        assert "4 does not evenly divide 2" in r["gqa_error"]
        assert "4 does not evenly divide 2" in str(jerr.value)


def test_infer_dp_tp_matches_jax():
    from quantizedmha_tpu.parallel.mesh import infer_dp_tp as jinfer

    table = [(n, h) for n in range(1, 17) for h in (1, 2, 4, 8, 16, 32)]
    assert [infer_dp_tp(n, h) for n, h in table] == [jinfer(n, h) for n, h in table]


def _unsharded_grads(entry):
    """The entry's gradients computed in one process: the flash kernel over
    the whole sequence (the INT8 ring: at the K/V its shards dequantize to,
    the straight-through VJP's point), or the partials merged pairwise."""
    from quantizedmha_tpu_torch.ops.flash_attention import flash_attention
    from quantizedmha_tpu_torch.parallel.combine import merge_two_partials
    from quantizedmha_tpu_torch.parallel.ring import _ste_residuals
    if entry == "merge_partial_attention":
        o, lse = (torch.from_numpy(x).requires_grad_() for x in _merge_inputs())
        acc_o, acc_lse = o[0], lse[0]
        for r in range(1, WORLD):
            acc_o, acc_lse = merge_two_partials(acc_o, acc_lse, o[r], lse[r])
        (acc_o ** 2).sum().backward()
        return o.grad, lse.grad
    qkv_kw, kw = CROSS_GRAD[entry]
    q, k, v = (torch.from_numpy(x) for x in _qkv(**qkv_kw))
    if entry == "ring_attention_int8":
        parts = [_ste_residuals(a, b, kw["block_kv"]) for a, b in
                 zip(k.chunk(WORLD, dim=2), v.chunk(WORLD, dim=2))]
        k, v = (torch.cat([p[i] for p in parts], dim=2) for i in (0, 1))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    (flash_attention(q, k, v, causal=True) * _cross_ct(entry)).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("entry", ["context_parallel_attention", "ring_attention",
                                   "ring_attention_int8", "merge_partial_attention"])
def test_cross_rank_entries_grad(ranks, entry):
    """The ring entries and the merge are differentiable on 4 gloo ranks:
    each rank's gradients of the global loss equal its shard of the same
    gradient computed in one process (the flash kernel over the unsharded
    sequence; the INT8 ring by its straight-through VJP at the dequantized
    shards; the merge as pairwise merges), within the float atol (f32
    backward sums in other orders). Context parallelism's q gradient is
    whole on every rank."""
    want = [w.numpy() for w in _unsharded_grads(entry)]
    for rank, r in enumerate(ranks):
        got = [g.numpy() for g in r["cross_grads"][entry]]
        if entry == "merge_partial_attention":
            for g, w in zip(got, want):
                assert np.isfinite(g).all()
                np.testing.assert_allclose(g, w[rank], rtol=0, atol=FLOAT_ATOL)
            continue
        split = [w if (i == 0 and entry == "context_parallel_attention")
                 else np.split(w, WORLD, axis=2)[rank] for i, w in enumerate(want)]
        for g, w in zip(got, split):
            atol = FLOAT_ATOL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
