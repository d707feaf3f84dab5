"""PyTorch port vs JAX package: the DP x TP train step across ranks
(models.llama.sgd_train_step(..., mesh=)), its collective audit by axis
and a sharded resume through utils.checkpoint.

The port runs on gloo process groups of 4 CPU ranks (a FileStore in a
temporary directory, a timeout on the group so that a collective that
never pairs fails the run instead of hanging it): a (2,) x (2,) hybrid
mesh ("dp", "tp") and a (1,) x (4,) one (tp = 4), spawned once for the
file by a module-scoped fixture. Each rank holds its shard of the params
(serving.sharded.shard_params by models.llama.param_shardings) and its dp
rank's rows of the global batch. JAX runs its sgd_train_step under jax.jit
over its hybrid_mesh with the params placed by param_shardings and the
tokens sharded on "dp", as its tests/test_distributed.py:95 does, on the
virtual CPU mesh of tests/conftest.py (Pallas in interpret mode). This
module imports jax only inside the functions that compute the JAX side,
since each spawned rank imports it.

Model: LlamaConfig.tiny with 8 q / 4 kv heads (tp 2 and 4 divide them),
2 layers, f32. Tolerances as tests/test_torch_train.py states them for
f32 (summation order only; TP and DP add partial sums in other orders than
XLA's): the loss 1e-6 relative, an updated parameter within 1e-6 |p| + lr
1e-5 G, G its leaf's largest gradient entry. The audit and the resume are
exact."""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.parallel import (
    audit_fn_by_axis,
    classify_collectives,
    collective_bytes,
    hybrid_mesh,
    record_collectives,
)
from quantizedmha_tpu_torch.parallel.distributed import train_step_collectives
from quantizedmha_tpu_torch.serving.sharded import gather_params, shard_params
from quantizedmha_tpu_torch.utils.checkpoint import CheckpointManager

WORLD = 4
MODEL = dict(num_heads=8, num_kv_heads=4, num_layers=2)
LR = 1e-2
GRANULE = 2
TOL = dict(loss=1e-6, param=1e-6, grad=1e-5)
MESHES = {"dp2_tp2": ((2,), (2,)), "dp1_tp4": ((1,), (4,))}


def _tcfg():
    return tl.LlamaConfig.tiny(dtype=torch.float32, **MODEL)


def _inputs():
    import jax
    import jax.numpy as jnp

    from quantizedmha_tpu.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig.tiny(dtype=jnp.float32, **MODEL)
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    return params, tokens


def _rows(tokens, mesh):
    dp, i = mesh.size(0), mesh.get_local_rank("dp")
    per = tokens.shape[0] // dp
    return torch.from_numpy(tokens[i * per:(i + 1) * per])


def _shards(params_np, mesh):
    cfg = _tcfg()
    return shard_params(params_from_numpy(params_np, device="cpu"), tl.param_shardings(cfg), mesh)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _rank_main(rank, store, out_dir, params_np, tokens_np):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        cfg = _tcfg()
        res = {}
        for name, (dcn, ici) in MESHES.items():
            mesh = hybrid_mesh(dcn, ici, ("dp",), ("tp",), device_type="cpu")
            params = _shards(params_np, mesh)
            tokens = _rows(tokens_np, mesh)
            with record_collectives() as records:
                params, loss = tl.sgd_train_step(cfg, params, tokens, LR, mesh=mesh)
            res[name] = {"params": _clone(params), "loss": float(loss),
                         "records": [(r.kind, r.dtype, r.nbytes, r.ranks) for r in records],
                         "by_axis": classify_collectives(records, GRANULE),
                         "bytes_by_axis": collective_bytes(records, GRANULE),
                         "want": train_step_collectives(cfg, params, tuple(tokens.shape)),
                         "groups": {a: tuple(dist.get_process_group_ranks(mesh.get_group(a)))
                                    for a in ("dp", "tp")}}
            if name != "dp2_tp2":
                continue
            res["audit_fn_by_axis"] = audit_fn_by_axis(
                tl.sgd_train_step, cfg, _clone(params), tokens, LR, mesh=mesh,
                granule_size=GRANULE)
            # Uninterrupted: a second step. Resumed: the step-1 params saved
            # whole (gathered over tp by every rank, written by rank 0),
            # restored as this rank's shard, then the same second step.
            full = gather_params(params, tl.param_shardings(cfg), mesh)
            ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
            if rank == 0:
                ckpt.save(1, full)
            dist.barrier()
            like = tl.init_params(cfg, device="meta")
            resumed = ckpt.restore_sharded(like, tl.param_shardings(cfg), mesh)
            same_restore = all(torch.equal(a, b) for a, b in zip(_leaves(resumed),
                                                                   _leaves(params)))
            params, loss2 = tl.sgd_train_step(cfg, params, tokens, LR, mesh=mesh)
            resumed, loss2r = tl.sgd_train_step(cfg, resumed, tokens, LR, mesh=mesh)
            res["resume"] = {"restored_equal": same_restore,
                             "step2_equal": all(torch.equal(a, b) for a, b in
                                                zip(_leaves(resumed), _leaves(params))),
                             "loss_equal": float(loss2) == float(loss2r),
                             "latest": ckpt.latest_step()}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """Every rank's results: one spawn of WORLD gloo ranks for the file."""
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d), *inputs), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_step(inputs, dcn, ici):
    """JAX's sgd_train_step jitted over its hybrid_mesh, params placed by
    param_shardings, tokens sharded on "dp": (new params, loss, grads)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quantizedmha_tpu.models.llama import LlamaConfig, loss_fn, param_shardings, sgd_train_step
    from quantizedmha_tpu.parallel.distributed import hybrid_mesh as jhybrid

    params_np, tokens_np = inputs
    cfg = LlamaConfig.tiny(dtype=jnp.float32, **MODEL)
    mesh = jhybrid(dcn, ici, ("dp",), ("tp",))
    with mesh:
        params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
                              params_np, param_shardings(cfg),
                              is_leaf=lambda x: isinstance(x, np.ndarray))
        tokens = jax.device_put(jnp.asarray(tokens_np), NamedSharding(mesh, P("dp", None)))
        new, loss = jax.jit(lambda p, t: sgd_train_step(cfg, p, t, LR))(params, tokens)
        grads = jax.jit(jax.grad(lambda p, t: loss_fn(cfg, p, t)))(params, tokens)
    return (jax.tree.map(np.asarray, new), float(loss), jax.tree.map(np.asarray, grads))


def _slice(x, spec, mesh_shape, coords):
    """The block of x that the rank at (dp, tp) coords holds by spec."""
    for d, name in enumerate(spec):
        if name == "tp":
            n = x.shape[d] // mesh_shape[1]
            x = np.take(x, range(coords[1] * n, (coords[1] + 1) * n), axis=d)
    return x


@pytest.mark.parametrize("name", list(MESHES))
def test_dp_tp_step_matches_jax(ranks, inputs, name):
    """Each rank's updated shard equals its block of JAX's step jitted over
    the hybrid mesh, and every rank returns JAX's global loss (2 x 2: dp 2
    x tp 2; 1 x 4: tp 4)."""
    dcn, ici = MESHES[name]
    new, loss, grads = _jax_step(inputs, dcn, ici)
    specs = tl.param_shardings(_tcfg())
    shape = (dcn[0], ici[0])
    for rank, r in enumerate(ranks):
        got = r[name]
        assert abs(got["loss"] - loss) <= TOL["loss"] * abs(loss)
        coords = (rank // ici[0], rank % ici[0])
        for key in ("embed", "final_norm", "lm_head"):
            _check(got["params"][key], new[key], grads[key], specs[key], shape, coords)
        for key, v in got["params"]["layers"].items():
            _check(v, new["layers"][key], grads["layers"][key], specs["layers"][key], shape,
                   coords)


def _check(got, want, grad, spec, shape, coords):
    want, grad = _slice(want, spec, shape, coords), _slice(grad, spec, shape, coords)
    atol = TOL["param"] * np.abs(want) + LR * TOL["grad"] * np.abs(grad).max()
    assert np.all(np.abs(got.numpy() - want) <= atol)


@pytest.mark.parametrize("name", list(MESHES))
def test_train_step_audit_by_axis_exact(ranks, name):
    """The collectives of one step are exactly the derived ones
    (parallel.distributed.train_step_collectives: 4L + 3 all-reduces on
    "tp" and one on "dp" for f32, each of the derived bytes, in order), and
    at granule 2 the tp ones stay on "ici" while only the dp gradient
    all-reduce crosses to "dcn" (JAX tests/test_distributed.py:95; on the
    1 x 4 mesh tp spans both granules)."""
    for r in ranks:
        got, want, groups = r[name]["records"], r[name]["want"], r[name]["groups"]
        assert [(k, d, n, ranks_) for k, d, n, ranks_ in got] == [
            (w["kind"], w["dtype"], w["nbytes"], groups[w["axis"]]) for w in want]
        L = MODEL["num_layers"]
        n_tp = sum(w["axis"] == "tp" for w in want)
        assert n_tp == 4 * L + 3 and len(want) - n_tp == 1
        tp_bytes = sum(w["nbytes"] for w in want if w["axis"] == "tp")
        dp_bytes = sum(w["nbytes"] for w in want if w["axis"] == "dp")
        if name == "dp2_tp2":
            assert r[name]["by_axis"] == {"ici": {"all-reduce": n_tp}, "dcn": {"all-reduce": 1}}
            assert r["audit_fn_by_axis"] == r[name]["by_axis"]
            assert r[name]["bytes_by_axis"] == {"ici": tp_bytes, "dcn": dp_bytes}
        else:
            assert r[name]["by_axis"] == {"ici": {"all-reduce": 1},
                                          "dcn": {"all-reduce": n_tp}}


def test_sharded_resume_is_bit_exact(ranks):
    """Step 1's params gathered over tp, saved by CheckpointManager, restored
    by restore_sharded onto the 2 x 2 mesh: the restored shards equal the
    live ones, and a second step from them equals the uninterrupted second
    step bit for bit, on every rank."""
    for r in ranks:
        assert r["resume"] == {"restored_equal": True, "step2_equal": True, "loss_equal": True,
                               "latest": 1}
