"""PyTorch port vs JAX package: checkpoint / resume
(quantizedmha_tpu_torch/utils/checkpoint.py) and metrics
(quantizedmha_tpu_torch/utils/metrics.py), the cases of the JAX package's
tests/test_utils.py, checkpoints crossing between the two packages, and
the engine's counters against JAX's engine on the same requests.

Checkpoints are compared exactly (the same bytes in, the same values out).
The sharded restore cuts by an explicit (rank, axis size) pair, as
serving.sharded.shard_params takes one; restoring onto a process-group mesh
is tests/test_torch_train_parallel.py's resume."""

import json

import numpy as np
import pytest
import torch

from quantizedmha_tpu_torch.parallel.mesh import P
from quantizedmha_tpu_torch.utils import CheckpointManager, Metrics, default_metrics


def _tree(rng, scale=1.0):
    return {"layer": {"w": torch.from_numpy(rng.normal(0, scale, (4, 8)).astype(np.float32)),
                      "b": torch.from_numpy(rng.normal(0, scale, (8,)).astype(np.float32))},
            "step_count": np.int32(7)}


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path, rng):
        mgr = CheckpointManager(tmp_path)
        tree = _tree(rng)
        mgr.save(10, tree)
        out = mgr.restore(_tree(np.random.default_rng(1)))
        assert torch.equal(out["layer"]["w"], tree["layer"]["w"])
        assert out["layer"]["w"].dtype == torch.float32
        np.testing.assert_array_equal(out["step_count"], 7)
        assert sorted(p.name for p in (tmp_path / "step_10").iterdir()) == [
            "leaves.npz", "meta.json", "tree.json"]
        assert json.loads((tmp_path / "step_10" / "meta.json").read_text()) == {
            "step": 10, "backend": "npz"}

    def test_latest_and_explicit_step(self, tmp_path, rng):
        mgr = CheckpointManager(tmp_path, keep=10)
        t1, t2 = _tree(rng, 1.0), _tree(rng, 2.0)
        mgr.save(1, t1)
        mgr.save(2, t2)
        assert mgr.latest_step() == 2
        like = _tree(np.random.default_rng(1))
        assert torch.equal(mgr.restore(like)["layer"]["w"], t2["layer"]["w"])
        assert torch.equal(mgr.restore(like, step=1)["layer"]["w"], t1["layer"]["w"])

    def test_retention_gc(self, tmp_path, rng):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(rng))
        assert mgr.steps() == [3, 4]

    def test_incomplete_checkpoint_ignored(self, tmp_path, rng):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, _tree(rng))
        broken = tmp_path / "step_2"
        broken.mkdir()
        (broken / ".incomplete").touch()
        assert mgr.latest_step() == 1

    def test_structure_mismatch_raises(self, tmp_path, rng):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, _tree(rng))
        with pytest.raises(ValueError, match="leaves"):
            mgr.restore({"only": torch.zeros(2)})

    def test_rejects_mismatched_template(self, tmp_path):
        """Same leaf count, a renamed key: "does not match template"; a
        wrong shape: "shape" (JAX tests/test_utils.py:135)."""
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"a": torch.ones(3), "b": torch.zeros(2)})
        with pytest.raises(ValueError, match="does not match template"):
            mgr.restore({"a": torch.ones(3), "c": torch.zeros(2)})
        with pytest.raises(ValueError, match="shape"):
            mgr.restore({"a": torch.ones(4), "b": torch.zeros(2)})
        out = mgr.restore({"a": torch.zeros(3), "b": torch.ones(2)})
        assert float(out["a"].sum()) == 3.0

    def test_orbax_checkpoint_raises(self, tmp_path, rng):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, _tree(rng))
        (tmp_path / "step_1" / "meta.json").write_text(json.dumps({"step": 1,
                                                                   "backend": "orbax"}))
        with pytest.raises(RuntimeError, match="orbax"):
            mgr.restore(_tree(rng))

    def test_large_leaves_restore_owned(self, tmp_path, rng):
        """Leaves of a MiB or more are read through a copy-on-write map of
        the file: the restored tensors are the saved values, writable, and
        writing them leaves the checkpoint as it was."""
        mgr = CheckpointManager(tmp_path)
        tree = {"big": torch.from_numpy(rng.normal(0, 1, (512, 1024)).astype(np.float32)),
                "big16": torch.from_numpy(rng.normal(0, 1, (1024, 1024)).astype(np.float32)
                                          ).to(torch.bfloat16)}
        mgr.save(1, tree)
        out = mgr.restore(tree)
        for k in tree:
            assert torch.equal(out[k], tree[k])
            out[k].add_(1)
        again = mgr.restore(tree)
        assert all(torch.equal(again[k], tree[k]) for k in tree)

    def test_restore_sharded_cuts_each_rank(self, tmp_path, rng):
        """restore_sharded gives each rank its block by PartitionSpec (the
        JAX package's device_put with a NamedSharding), replicated leaves
        whole, on the template's device; a meta template allocates
        nothing."""
        mgr = CheckpointManager(tmp_path)
        tree = {"w": torch.from_numpy(rng.normal(0, 1, (8, 8)).astype(np.float32)),
                "r": torch.arange(4.0)}
        mgr.save(1, tree)
        specs = {"w": P("x", None), "r": P(None)}
        like = {k: torch.empty_like(v, device="meta") for k, v in tree.items()}
        for rank in range(2):
            out = mgr.restore_sharded(like, specs, (rank, 2), axis="x")
            assert torch.equal(out["w"], tree["w"][4 * rank:4 * (rank + 1)])
            assert torch.equal(out["r"], tree["r"]) and out["w"].device.type == "cpu"


def _jax_tree(dtype):
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    return {"layers": {"wq": jnp.asarray(rng.normal(0, 1, (2, 4, 8)), dtype),
                       "attn_norm": jnp.asarray(rng.normal(0, 1, (2, 4)), dtype)},
            "embed": jnp.asarray(rng.normal(0, 1, (1024, 1024)), dtype)}


def _torch_like(jtree, dtype):
    import jax
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(dtype), jtree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    """A checkpoint the JAX package's CheckpointManager wrote (npz) restores
    here leaf for leaf (bf16 leaves: its raw bits, stored as |V2)."""
    import jax.numpy as jnp

    from quantizedmha_tpu.utils.checkpoint import CheckpointManager as JManager
    jtree = _jax_tree(getattr(jnp, dtype))
    JManager(tmp_path, backend="npz").save(3, jtree)
    tdtype = getattr(torch, dtype)
    out = CheckpointManager(tmp_path).restore(_torch_like(jtree, tdtype))
    for got, want in zip((out["embed"], out["layers"]["wq"], out["layers"]["attn_norm"]),
                         (jtree["embed"], jtree["layers"]["wq"], jtree["layers"]["attn_norm"])):
        assert got.dtype == tdtype
        assert torch.equal(got.float(), torch.from_numpy(np.array(want, np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_reads_in_jax(tmp_path, dtype):
    """A checkpoint the port wrote has the JAX package's files and bytes
    (paths, leaf order, bf16 as |V2); the JAX package restores the f32 one
    leaf for leaf. Its own restore cannot cast a |V2 leaf, so it refuses
    the port's bf16 checkpoint exactly as it refuses its own."""
    import jax.numpy as jnp

    from quantizedmha_tpu.utils.checkpoint import CheckpointManager as JManager
    jtree = _jax_tree(getattr(jnp, dtype))
    CheckpointManager(tmp_path / "port").save(3, _torch_like(jtree, getattr(torch, dtype)))
    JManager(tmp_path / "jax", backend="npz").save(3, jtree)
    for name in ("tree.json", "meta.json"):
        assert ((tmp_path / "port" / "step_3" / name).read_text()
                == (tmp_path / "jax" / "step_3" / name).read_text())
    port_npz, jax_npz = (np.load(tmp_path / d / "step_3" / "leaves.npz") for d in ("port", "jax"))
    assert port_npz.files == jax_npz.files
    for f in port_npz.files:
        assert port_npz[f].dtype == jax_npz[f].dtype
        assert port_npz[f].tobytes() == jax_npz[f].tobytes()
    jmgr = JManager(tmp_path / "port", backend="npz")
    if dtype == "float32":
        out = jmgr.restore(jtree)
        np.testing.assert_array_equal(np.asarray(out["embed"]), np.asarray(jtree["embed"]))
    else:
        with pytest.raises(ValueError) as port_err:
            jmgr.restore(jtree)
        with pytest.raises(ValueError) as jax_err:
            JManager(tmp_path / "jax", backend="npz").restore(jtree)
        assert str(port_err.value) == str(jax_err.value)


class TestMetrics:
    def test_counters_gauges(self):
        m = Metrics()
        m.inc("a")
        m.inc("a", 2)
        m.set("g", 5.0)
        assert m.counter("a") == 3
        snap = m.snapshot()
        assert snap["counters"]["a"] == 3 and snap["gauges"]["g"] == 5.0

    def test_timed_histogram(self):
        m = Metrics()
        with m.timed("op"):
            pass
        m.observe("op", 0.010)
        h = m.snapshot()["timings"]["op"]
        assert h["count"] == 2
        assert h["max_s"] >= 0.010
        assert h["p99_s"] >= 0.010

    def test_render_and_dump(self, tmp_path):
        m = Metrics()
        m.inc("tokens", 10)
        m.observe("step", 0.001)
        text = m.render()
        assert "tokens=10" in text and "step[" in text
        m.dump_json(tmp_path / "m.json")
        assert json.loads((tmp_path / "m.json").read_text())["counters"] == {"tokens": 10}

    def test_histogram_and_rendering_match_jax(self):
        """The same observations give JAX's histogram snapshot (buckets,
        quantiles), and the same counters its rendering, uptime aside."""
        from quantizedmha_tpu.utils.metrics import Metrics as JMetrics
        ours, theirs = Metrics(), JMetrics()
        for m in (ours, theirs):
            for v in (3e-7, 1e-6, 5e-5, 2e-3, 2e-3, 0.7, 40.0):
                m.observe("lat", v)
            m.inc("n", 3)
            m.set("g", 2.5)
        assert ours.snapshot()["timings"] == theirs.snapshot()["timings"]
        assert ours.render().split(" ", 1)[1] == theirs.render().split(" ", 1)[1]
        assert ours.rate("n") > 0 and ours.rate("missing") == 0

    def test_default_metrics_is_one_registry(self):
        assert default_metrics() is default_metrics()


def test_engine_counters_match_jax():
    """The port's Engine and JAX's on the same tiny model (JAX's params
    converted) and request count the same work: equal counters, and the
    same number of prefill and decode-step timings (JAX
    tests/test_utils.py:109)."""
    import jax

    from quantizedmha_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
    from quantizedmha_tpu.serving.engine import Engine as JEngine, EngineConfig as JEngineConfig
    from quantizedmha_tpu_torch.models import llama as tl
    from quantizedmha_tpu_torch.models.convert import params_from_numpy
    from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

    jcfg = JConfig.tiny(num_layers=1)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    ecfg = dict(num_pages=32, page_size=16, max_batch=2, prefill_buckets=(16, 32),
                max_new_tokens=4)
    jeng = JEngine(jcfg, jparams, JEngineConfig(**ecfg))
    eng = Engine(tl.LlamaConfig.tiny(num_layers=1),
                 params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                 EngineConfig(**ecfg), device="cpu")
    snaps = []
    for e in (jeng, eng):
        e.add_request([1, 2, 3])
        e.run()
        snaps.append(e.metrics.snapshot())
    (want, got) = snaps
    assert got["counters"] == want["counters"]
    assert got["counters"]["requests_finished"] == 1
    for name in ("prefill", "decode_step"):
        assert got["timings"][name]["count"] == want["timings"][name]["count"]
