"""PyTorch port vs JAX package: GPipe pipeline parallelism
(quantizedmha_tpu_torch/parallel/pipeline.py), the cases of the JAX
package's tests/test_pipeline.py and the pipeline loss's gradients.

The port runs on gloo process groups of 4 CPU ranks (a FileStore in a
temporary directory): pp = 4 on a 1-D ("pp",) mesh and pp = 2 on a 2 x 2
("x", "pp") mesh, whose two pp groups run the same case. They are spawned
once for the file by a module-scoped fixture that runs every case (with a
timeout on the group, so a send that never pairs fails the run instead of
hanging it) and returns each rank's logits, errors and gradients. JAX runs
pipeline_llama_forward on the virtual CPU mesh of tests/conftest.py under
jax.jit, its Pallas kernels in interpret mode; the gradients are jax.grad
of the shifted cross-entropy through it. This module imports jax only
inside the functions that compute the JAX side, since each spawned rank
imports it.

Models are tiny and f32 (JAX's: LlamaConfig.tiny(num_layers=4)). Both
sides compute every product in f32 and differ in summation order only
(the flash kernels' online softmax, XLA's fused chains): logits within
1e-5 of the largest |logit|, the loss 1e-6 relative, each gradient within
1e-5 of its leaf's largest entry, as tests/test_torch_train.py states for
f32 training."""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.parallel import make_mesh, pipeline_llama_forward
from quantizedmha_tpu_torch.parallel.pipeline import shard_layers

WORLD = 4
GEMMA2 = dict(window_pattern=(12, None, 12, None), sandwich_norms=True, rms_plus_one=True,
              embed_scale=True, hidden_act="gelu_tanh", query_pre_attn_scalar=32.0,
              logit_softcap=30.0, final_logit_softcap=15.0)
# name: (pp, microbatches, model overrides, params seed, tokens seed, grads)
CASES = {
    "pp2_m2": (2, 2, {}, 0, 0, True),
    "pp2_m4": (2, 4, {}, 0, 0, False),
    "pp4_m2": (4, 2, {}, 0, 0, True),
    "pp4_m4": (4, 4, {}, 0, 0, False),
    "windowed_gqa": (2, 2, dict(sliding_window=12, attention_sinks=2, logit_softcap=25.0),
                     1, 1, False),
    "gemma2": (2, 2, GEMMA2, 2, 2, True),
}
TOL = dict(logits=1e-5, loss=1e-6, grad=1e-5)


def _jcfg(over, **kw):
    import jax.numpy as jnp
    from quantizedmha_tpu.models.llama import LlamaConfig
    return LlamaConfig.tiny(**dict(dict(num_layers=4, dtype=jnp.float32), **over, **kw))


def _tcfg(over, **kw):
    return tl.LlamaConfig.tiny(**dict(dict(num_layers=4, dtype=torch.float32), **over, **kw))


def _params(over, seed):
    """JAX's init_params as numpy (the port's converts them)."""
    import jax
    from quantizedmha_tpu.models.llama import init_params
    return jax.tree.map(np.asarray, init_params(_jcfg(over), jax.random.PRNGKey(seed)))


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 256, (4, 32)).astype(np.int32)


def _loss(logits, tokens):
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long())[..., 0].mean()


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank, store, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {4: make_mesh((WORLD,), ("pp",), device_type="cpu"),
                  2: make_mesh((2, 2), ("x", "pp"), device_type="cpu")}
        res = {}
        for name, (pp, n_micro, over, _, _, grads) in CASES.items():
            cfg = _tcfg(over)
            params_np, tokens_np = inputs[name]
            params = tl.float_leaves(params_from_numpy(params_np, device="cpu"))
            tokens = torch.from_numpy(tokens_np)
            logits = pipeline_llama_forward(cfg, params, tokens, meshes[pp],
                                            n_microbatches=n_micro)
            out = {"logits": logits.detach()}
            if grads:
                loss = _loss(logits, tokens)
                loss.backward()
                stage = meshes[pp].get_local_rank("pp")
                per = cfg.num_layers // pp
                out["loss"] = loss.detach()
                out["layers"] = {k: [(stage * per + i, g.grad) for i, g in
                                     enumerate(v[stage * per:(stage + 1) * per])]
                                 for k, v in params["layers"].items()}
                out["others"] = {k: params[k].grad for k in ("embed", "final_norm", "lm_head")}
            res[name] = out
        p3, t3 = inputs["validate"]
        res["layers_error"] = _error(lambda: pipeline_llama_forward(
            _tcfg({}, num_layers=3), params_from_numpy(p3, device="cpu"),
            torch.from_numpy(t3), meshes[2], n_microbatches=2))
        p4, _ = inputs["pp2_m2"]
        params4 = params_from_numpy(p4, device="cpu")
        res["micro_error"] = _error(lambda: pipeline_llama_forward(
            _tcfg({}), params4, torch.from_numpy(t3), meshes[2], n_microbatches=3))
        res["stage_error"] = _error(lambda: pipeline_llama_forward(
            _tcfg(dict(window_pattern=(None, None, 12, 12))), params4, torch.from_numpy(t3),
            meshes[2], n_microbatches=2))
        res["shard_shapes"] = {k: tuple(v.shape) for k, v in
                               shard_layers(params4["layers"], meshes[4]).items()}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one spawn of WORLD gloo ranks for the file."""
    inputs = {name: (_params(c[2], c[3]), _tokens(c[4])) for name, c in CASES.items()}
    inputs["validate"] = (_params(dict(num_layers=3), 0), np.zeros((4, 8), np.int32))
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d), inputs), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_side(name, grads):
    """JAX's jitted pipeline logits and, when asked, jax.grad of the loss
    through it: (logits, loss, grads as numpy trees)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from quantizedmha_tpu.parallel.pipeline import pipeline_llama_forward as jpipe, shard_layers as jshard

    pp, n_micro, over, pseed, tseed, _ = CASES[name]
    cfg = _jcfg(over)
    params = jax.tree.map(jnp.asarray, _params(over, pseed))
    tokens = jnp.asarray(_tokens(tseed))
    mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))
    params = dict(params, layers=jshard(params["layers"], mesh))

    def loss_of(p):
        logits = jpipe(cfg, p, tokens, mesh, n_microbatches=n_micro)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        ll = jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1)[..., 0]
        return -jnp.mean(ll), logits

    if not grads:
        logits = jax.jit(lambda p: loss_of(p)[1])(params)
        return np.asarray(logits), None, None
    (loss, logits), g = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, g)


def _close(got, want, rel):
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(ranks, name):
    """Every rank's logits equal JAX's pipeline_llama_forward (pp 2 and 4,
    2 and 4 microbatches, windowed GQA with sinks and softcap, the Gemma-2
    pattern: JAX tests/test_pipeline.py :18, :70, :94); where the case
    trains, each stage's layer gradients, and every rank's embedding, final
    norm and lm_head gradients, equal jax.grad of the shifted
    cross-entropy through JAX's pipeline."""
    pp, _, _, _, _, grads = CASES[name]
    logits, loss, g = _jax_side(name, grads)
    for r in ranks:
        _close(r[name]["logits"].numpy(), logits, TOL["logits"])
    if not grads:
        return
    for r in ranks:
        got = r[name]
        assert abs(float(got["loss"]) - loss) <= TOL["loss"] * abs(loss)
        for k, rows in got["layers"].items():
            for i, grad in rows:
                _close(grad.numpy(), g["layers"][k][i], TOL["grad"])
        for k, grad in got["others"].items():
            _close(grad.numpy(), g[k], TOL["grad"])


def test_pipeline_validations_match_jax(ranks):
    """The three refusals raise ValueError with JAX's words: layers the
    stages do not divide, a batch the microbatches do not divide, a window
    pattern that differs between stages (JAX tests/test_pipeline.py :36,
    :125)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from quantizedmha_tpu.models.llama import init_params
    from quantizedmha_tpu.parallel.pipeline import pipeline_llama_forward as jpipe

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    tokens = jnp.zeros((4, 8), jnp.int32)
    want = {}
    for key, over, n_micro in (("layers_error", dict(num_layers=3), 2),
                               ("micro_error", {}, 3),
                               ("stage_error", dict(window_pattern=(None, None, 12, 12)), 2)):
        cfg = _jcfg(over)
        with pytest.raises(ValueError) as err:
            jpipe(cfg, init_params(cfg, jax.random.PRNGKey(0)), tokens, mesh,
                  n_microbatches=n_micro)
        want[key] = str(err.value)
    for r in ranks:
        for key, msg in want.items():
            assert r[key] == msg
    assert "layers" in want["layers_error"] and "microbatches" in want["micro_error"]
    assert "stage" in want["stage_error"]


def test_pipeline_layer_shards_are_real(ranks):
    """At pp = 4 each stage holds one of the 4 layers of every stacked leaf
    (JAX tests/test_pipeline.py :46)."""
    cfg = _tcfg({})
    for r in ranks:
        assert r["shard_shapes"]["wq"] == (1, cfg.hidden_size, cfg.num_heads * cfg.hd)
        assert {s[0] for s in r["shard_shapes"].values()} == {1}
