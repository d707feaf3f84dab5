"""PyTorch port vs JAX package: tensor-parallel serving
(quantizedmha_tpu_torch/serving/sharded.py, the adapter's `group`,
models/llama.param_shardings), the cases of the JAX package's
tests/test_sharded_serving.py.

The port's TPEngine and TPSpecDecodeEngine run on gloo process groups of 4
CPU ranks (a FileStore in a temporary directory), spawned once for the file
by a module-scoped fixture that runs every case and returns each rank's
results: tp=4 on a 1-D ("tp",) mesh and tp=2 on a 2 x 2 ("dp", "tp") mesh
(each "dp" half a TP=2 engine). JAX runs its TPEngine on the virtual CPU
mesh of tests/conftest.py, its Pallas kernels in interpret mode, once per
case at one TP degree (JAX's own tests hold its TPEngine to its Engine);
the port's unsharded Engine runs in the main process. This module imports
jax only inside the functions that compute the JAX side, since each spawned
rank imports it.

Models are tiny and f32 (JAX's fixture, tests/test_sharded_serving.py:21),
with 8 q / 4 kv heads so that tp 2 and 4 both divide them. Greedy streams
and the engines' counters must be equal: TP reorders the wo and w_down sums
(f32), which moves a logit by ulps; a greedy choice or a page scale would
have to sit within those ulps of a tie to flip. Parameter shards must equal
JAX's shard_tree shards bit for bit. w8a8 under TP quantizes each rank's
slice of an activation row (JAX's shard_map does the same): held to JAX's
TPEngine, not to the unsharded engine."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from quantizedmha_tpu_torch.parallel import make_mesh
from quantizedmha_tpu_torch.quant.weights import (
    QuantizedWeight,
    fuse_w4_projections,
    quantize_llama_params,
    quantize_weight4,
    weight_bytes,
)
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.sampling import SamplingParams
from quantizedmha_tpu_torch.serving.sharded import (
    TPEngine,
    TPSpecDecodeEngine,
    local_config,
    shard_params,
    tp_cache_specs,
    tp_mixed_cache_specs,
    tp_param_specs,
)
from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
TPS = (2, 4)
MODEL = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
             num_heads=8, num_kv_heads=4, head_dim=32)
COUNTERS = ("requests_admitted", "requests_finished", "prefill_tokens",
            "prefill_chunks_interleaved", "pages_trimmed", "decode_steps", "tokens_generated",
            "prefix_cache_hits", "prefix_tokens_reused")
SPEC_COUNTERS = ("spec_rounds", "draft_tokens_proposed", "draft_tokens_accepted",
                 "tokens_generated")
BASE_ECFG = dict(num_pages=32, page_size=16, max_batch=3, prefill_buckets=(16, 32),
                 max_new_tokens=6)
MIXED = dict(boundary_tokens=8, int8_pages=16, int4_pages=16)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, n).tolist() for n in lengths]


# name: (model overrides, EngineConfig, prompts, how to drive, weight quant,
# JAX's TP degree, or each degree when the streams depend on it: w8a8's row
# scales are each rank's). "prefix" admits the second prompt after one step,
# while the first one's pages are live (JAX :239).
CASES = {
    "plain": (dict(seed=0), dict(BASE_ECFG), [[1, 2, 3, 4], [7, 8, 9], [11, 5]], "run",
              None, 2),
    "pressure": (dict(seed=0), dict(num_pages=12, page_size=16, max_batch=2,
                                    prefill_buckets=(16,), max_new_tokens=4),
                 [[i + 1, i + 2, i + 3] for i in range(4)], "run", None, 4),
    "windowed": (dict(seed=3, sliding_window=12, attention_sinks=2, logit_softcap=30.0),
                 dict(num_pages=32, page_size=8, max_batch=2, prefill_buckets=(16, 32),
                      max_new_tokens=6), [list(range(1, 20)), list(range(4, 18))], "run",
                 None, 2),
    "gemma2": (dict(seed=3, window_pattern=(16, None), sandwich_norms=True, rms_plus_one=True,
                    embed_scale=True, hidden_act="gelu_tanh", query_pre_attn_scalar=32.0,
                    logit_softcap=30.0, final_logit_softcap=15.0),
               dict(num_pages=32, page_size=16, max_batch=2, prefill_buckets=(16, 32),
                    max_new_tokens=5), [[1, 2, 3, 4, 5], [9, 8, 7]], "run", None, 4),
    "hybrid": (dict(seed=4, window_pattern=(8, None)),
               dict(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=16,
                    prefill_buckets=(8,), max_new_tokens=16, hybrid_kv=True,
                    hybrid_pages={"w8": 16}), [[1, 2, 3, 4, 5], [9, 8, 7]], "run", None, 2),
    "mixed": (dict(seed=0), dict(num_pages=32, page_size=4, max_batch=2,
                                 prefill_buckets=(8, 16), max_new_tokens=6,
                                 max_pages_per_seq=8, mixed_kv=MIXED),
              _prompts(11, (5, 9)), "run", None, 4),
    "hybrid_mixed": (dict(seed=4, window_pattern=(8, None)),
                     dict(num_pages=64, page_size=4, max_batch=2, max_pages_per_seq=16,
                          prefill_buckets=(8, 16), max_new_tokens=12, hybrid_kv=True,
                          hybrid_pages={"w8": 24}, mixed_kv=MIXED),
                     _prompts(0, (5, 9, 14)), "run", None, 2),
    "prefix": (dict(seed=0), dict(BASE_ECFG, prefix_cache=True),
               [[int(t) for t in np.random.default_rng(7).integers(1, 256, 16)] + [5, 6, 7],
                [int(t) for t in np.random.default_rng(7).integers(1, 256, 16)] + [9, 10]],
               "prefix", None, 4),
    "w8a8": (dict(seed=0, weight_quant_mode="w8a8"), dict(BASE_ECFG),
             [[1, 2, 3, 4], [7, 8, 9], [11, 5]], "run", 8, TPS),
    # INT4 weights ("pairs", groups of 32 rows: a row shard holds whole
    # groups), the fused w4 matmul's plain version on every rank's shard.
    "w4": (dict(seed=0), dict(BASE_ECFG), [[1, 2, 3, 4], [7, 8, 9], [11, 5]], "run", 4, 4),
    # Chunked (past the largest bucket), interleaved, fused decode: the
    # port's unsharded engine only.
    "chunked": (dict(seed=0), dict(num_pages=32, page_size=8, max_batch=2,
                                   prefill_buckets=(16,), max_new_tokens=6,
                                   interleaved_prefill=True, decode_chunk=3),
                _prompts(5, (40, 7)), "run", None, None),
}
SPEC = dict(prompts=[[1, 2, 3, 4], [9, 8, 7]], k=3, max_new=8,
            sampled=dict(temperature=0.8, top_k=8, seed=5))


def _spec_ecfg(sampling):
    return EngineConfig(num_pages=32, page_size=16, max_batch=2, prefill_buckets=(16,),
                        max_new_tokens=SPEC["max_new"], sampling=sampling)


def _model_cfg(over):
    kw = dict(MODEL, **{k: v for k, v in over.items() if k != "seed"})
    return tl.LlamaConfig(dtype=torch.float32, **kw)


def _drive(eng, prompts, how):
    if how == "prefix":
        eng.add_request(list(prompts[0]))
        eng.step()  # the first request's pages live while the second is admitted
        eng.add_request(list(prompts[1]))
        return eng.run()
    for p in prompts:
        eng.add_request(list(p))
    return eng.run()


def _counters(eng, names=COUNTERS):
    return {c: eng.metrics.counter(c) for c in names}


def _mesh(tp):
    if tp == WORLD:
        return make_mesh((WORLD,), ("tp",), device_type="cpu")
    return make_mesh((WORLD // tp, tp), ("dp", "tp"), device_type="cpu")


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank, store, out_dir, trees):
    """One gloo rank: every case at both TP degrees, the results saved."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        res = {}
        for name, (over, ecfg, prompts, how, _, _) in CASES.items():
            cfg = _model_cfg(over)
            for tp in TPS:
                mesh = _mesh(tp)
                eng = TPEngine(cfg, params_from_numpy(trees[name], device="cpu"),
                               EngineConfig(**ecfg), mesh, device="cpu")
                out = _drive(eng, prompts, how)
                r = {"streams": out, "counters": _counters(eng),
                     "tp_rank": mesh.get_local_rank("tp")}
                if name == "plain":
                    r["shards"] = params_to_numpy(eng.params)
                    r["k_pages"] = tuple(eng.cache.k_pages.shape)
                res[name, tp] = r
        cfg = _model_cfg(dict(seed=0))
        dcfg = dataclasses.replace(cfg, num_layers=1)
        for tp in TPS:
            for label, sampling in (("greedy", SamplingParams()),
                                    ("sampled", SamplingParams(**SPEC["sampled"]))):
                eng = TPSpecDecodeEngine(
                    cfg, params_from_numpy(trees["plain"], device="cpu"), dcfg,
                    params_from_numpy(trees["draft"], device="cpu"), _spec_ecfg(sampling),
                    _mesh(tp), SpecConfig(num_draft_tokens=SPEC["k"]), device="cpu")
                out = _drive(eng, SPEC["prompts"], "run")
                res["spec", label, tp] = {"streams": out,
                                          "counters": _counters(eng, SPEC_COUNTERS)}
        params = params_from_numpy(trees["plain"], device="cpu")
        wide = dataclasses.replace(cfg, num_kv_heads=2)
        res["errors"] = {
            "heads": _error(lambda: TPEngine(wide, params, EngineConfig(**BASE_ECFG),
                                             _mesh(4), device="cpu")),
            "axis": _error(lambda: TPEngine(cfg, params, EngineConfig(**BASE_ECFG), _mesh(4),
                                            axis="dp", device="cpu")),
        }
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- the JAX side -----------------------------------------------------------


def _jax_models(over, quant):
    """(JAX config, JAX params, the params as numpy) of a case's model."""
    import jax
    import jax.numpy as jnp

    from quantizedmha_tpu.models import llama as jl
    from quantizedmha_tpu.quant.weights import quantize_llama_params as jquant

    kw = dict(MODEL, **{k: v for k, v in over.items() if k != "seed"})
    jc = jl.LlamaConfig(dtype=jnp.float32, **kw)
    jp = jl.init_params(jc, jax.random.PRNGKey(over["seed"]))
    if quant:
        jp = jquant(jp, bits=quant, group=32)
    return jc, jp, _numpy_tree(jp)


def _numpy_tree(jp):
    """A JAX params tree as params_from_numpy takes it."""
    from quantizedmha_tpu.quant.weights import QuantizedWeight as JQW
    from quantizedmha_tpu.quant.weights import QuantizedWeight4 as JQW4

    if isinstance(jp, dict):
        return {k: _numpy_tree(v) for k, v in jp.items()}
    if isinstance(jp, JQW):
        return {"values": np.asarray(jp.values), "scale": np.asarray(jp.scale)}
    if isinstance(jp, JQW4):
        return {"packed": np.asarray(jp.packed), "scale": np.asarray(jp.scale),
                "group": jp.group, "packing": jp.packing}
    return np.asarray(jp)


def _jax_tp_run(name, tp):
    """JAX's TPEngine on the case at TP degree tp: (streams, counters)."""
    from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
    from quantizedmha_tpu.serving.sharded import TPEngine as JTPEngine, make_tp_mesh

    over, ecfg, prompts, how, quant, _ = CASES[name]
    jc, jp, _ = _jax_models(over, quant)
    eng = JTPEngine(jc, jp, JEngineConfig(**ecfg), make_tp_mesh(tp))
    return _drive(eng, prompts, how), _counters(eng)


@pytest.fixture(scope="module")
def trees():
    out = {name: _jax_models(over, quant)[2] for name, (over, *_, quant, _) in CASES.items()}
    out["draft"] = _jax_models(dict(seed=1, num_layers=1), None)[2]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees):
    """Every rank's results: one spawn of WORLD gloo ranks for the file."""
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d), trees), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _port_run(name, trees):
    over, ecfg, prompts, how, _, _ = CASES[name]
    eng = Engine(_model_cfg(over), params_from_numpy(trees[name], device="cpu"),
                 EngineConfig(**ecfg), device="cpu")
    return _drive(eng, prompts, how), _counters(eng)


# --- tests ------------------------------------------------------------------


def test_local_config_divides_like_jax():
    from quantizedmha_tpu.models.llama import LlamaConfig as JLlamaConfig
    from quantizedmha_tpu.serving.sharded import local_config as jlocal

    for tp in (1, 2):
        got, want = local_config(tl.LlamaConfig.tiny(), tp), jlocal(JLlamaConfig.tiny(), tp)
        assert (got.num_heads, got.num_kv_heads, got.hd) == (
            want.num_heads, want.num_kv_heads, want.hd)
    for tp in (4, 8):
        with pytest.raises(ValueError, match="divide") as err:
            local_config(tl.LlamaConfig.tiny(), tp)
        with pytest.raises(ValueError) as jerr:
            jlocal(JLlamaConfig.tiny(), tp)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("variant", [{}, {"attention_bias": True},
                                     {"sandwich_norms": True, "rms_plus_one": True}])
def test_specs_match_jax_and_params(variant):
    """tp_param_specs and param_shardings equal JAX's entry for entry and
    mirror init_params' structure; the cache specs shard the kv-head axis
    of every pool field as JAX's do."""
    import jax.numpy as jnp

    from quantizedmha_tpu.models import llama as jl
    from quantizedmha_tpu.serving import sharded as js

    cfg = tl.LlamaConfig.tiny(**variant)
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **variant)
    specs = tp_param_specs(attention_bias=cfg.attention_bias,
                           sandwich_norms=cfg.sandwich_norms)
    jspecs = js.tp_param_specs(attention_bias=cfg.attention_bias,
                               sandwich_norms=cfg.sandwich_norms)
    for mine, theirs in ((specs, jspecs), (tl.param_shardings(cfg), jl.param_shardings(jcfg))):
        assert mine.keys() == theirs.keys() and mine["layers"].keys() == theirs["layers"].keys()
        for k in mine:
            if k != "layers":
                assert tuple(mine[k]) == tuple(theirs[k]), k
        for k in mine["layers"]:
            assert tuple(mine["layers"][k]) == tuple(theirs["layers"][k]), k
    params = tl.init_params(cfg, device="meta")
    assert params.keys() == specs.keys() and params["layers"].keys() == specs["layers"].keys()
    for mine, theirs in ((tp_cache_specs(), js.tp_cache_specs()),
                         (tp_mixed_cache_specs(), js.tp_mixed_cache_specs())):
        for f in dataclasses.fields(mine):
            assert tuple(getattr(mine, f.name)) == tuple(getattr(theirs, f.name)), f.name


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_matches_jax_and_unsharded(ranks, trees, name):
    """TPEngine at tp 2 and 4 on every rank: streams and counters equal the
    port's unsharded Engine's and JAX's TPEngine's (JAX :51, :72, :94, :119,
    :168, :197, :239; mixed, hybrid x mixed, w8a8, w4 and chunked besides).
    w8a8 is held to JAX's TPEngine alone, at each degree (each rank
    quantizes its own slice of a row)."""
    _, _, _, _, quant, jtp = CASES[name]
    want_port = None if quant == 8 else _port_run(name, trees)
    if isinstance(jtp, tuple):
        want_jax = {tp: _jax_tp_run(name, tp) for tp in jtp}
    else:
        want_jax = dict.fromkeys(TPS, _jax_tp_run(name, jtp) if jtp else None)
    for r in ranks:
        for tp in TPS:
            got = r[name, tp]
            for want in (want_port, want_jax[tp]):
                if want is not None:
                    assert got["streams"] == want[0], (tp, got["streams"], want[0])
                    assert got["counters"] == want[1], (tp, got["counters"], want[1])
    if name == "prefix":
        assert ranks[0]["prefix", 4]["counters"]["prefix_cache_hits"] == 1
        assert ranks[0]["prefix", 4]["counters"]["prefix_tokens_reused"] == 16
    if name == "hybrid":
        assert ranks[0]["hybrid", 2]["counters"]["pages_trimmed"] > 0


def test_tp_spec_engine_matches_jax_and_unsharded(ranks, trees):
    """TPSpecDecodeEngine at tp 2 and 4 (target and draft sharded): greedy
    streams and counters equal JAX's TPSpecDecodeEngine's and the port's
    SpecDecodeEngine's; sampled (rejection sampling, temperature 0.8, top-k
    8) equal the port's SpecDecodeEngine's (the generators differ from
    JAX's), and speculation pays (rounds < tokens) (JAX :197)."""
    from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
    from quantizedmha_tpu.serving.sampling import SamplingParams as JSamplingParams
    from quantizedmha_tpu.serving.sharded import TPSpecDecodeEngine as JTPSpec, make_tp_mesh
    from quantizedmha_tpu.serving.speculative import SpecConfig as JSpecConfig

    cfg = _model_cfg(dict(seed=0))
    dcfg = dataclasses.replace(cfg, num_layers=1)
    jc, jp, _ = _jax_models(dict(seed=0), None)
    jdc, jdp, _ = _jax_models(dict(seed=1, num_layers=1), None)
    jeng = JTPSpec(jc, jp, jdc, jdp, JEngineConfig(
        num_pages=32, page_size=16, max_batch=2, prefill_buckets=(16,),
        max_new_tokens=SPEC["max_new"], sampling=JSamplingParams()), make_tp_mesh(2),
        JSpecConfig(num_draft_tokens=SPEC["k"]))
    want_jax = (_drive(jeng, SPEC["prompts"], "run"), _counters(jeng, SPEC_COUNTERS))
    for label, sampling in (("greedy", SamplingParams()),
                            ("sampled", SamplingParams(**SPEC["sampled"]))):
        eng = SpecDecodeEngine(cfg, params_from_numpy(trees["plain"], device="cpu"), dcfg,
                               params_from_numpy(trees["draft"], device="cpu"),
                               _spec_ecfg(sampling), SpecConfig(num_draft_tokens=SPEC["k"]),
                               device="cpu")
        want = (_drive(eng, SPEC["prompts"], "run"), _counters(eng, SPEC_COUNTERS))
        for r in ranks:
            for tp in TPS:
                got = r["spec", label, tp]
                assert (got["streams"], got["counters"]) == want, (label, tp)
                if label == "greedy":
                    assert (got["streams"], got["counters"]) == want_jax, tp
        assert want[1]["spec_rounds"] < SPEC["max_new"]


@pytest.mark.parametrize("tp", TPS)
def test_shards_are_real_and_equal_jax_shard_tree(ranks, trees, tp):
    """Each rank's wq holds out / tp columns, its pages Hkv / tp heads, and
    every parameter shard equals, bit for bit, the addressable shard of
    JAX's shard_tree at the same mesh position (JAX :62)."""
    import jax

    from quantizedmha_tpu.serving.sharded import make_tp_mesh, shard_tree
    from quantizedmha_tpu.serving.sharded import tp_param_specs as jspecs

    _, jp, _ = _jax_models(CASES["plain"][0], None)
    placed = shard_tree(jp, jspecs(), make_tp_mesh(tp))
    paths = jax.tree_util.tree_flatten_with_path(placed)[0]
    for r in ranks:
        got = r["plain", tp]
        pos = got["tp_rank"]
        assert got["shards"]["layers"]["wq"].shape == (2, 128, 8 * 32 // tp)
        assert got["k_pages"][1] == 4 // tp
        for path, leaf in paths:
            node = got["shards"]
            for key in path:
                node = node[key.key]
            shard = next(s for s in leaf.addressable_shards if s.device == leaf.sharding.mesh
                         .devices.flat[pos])
            np.testing.assert_array_equal(node, np.asarray(shard.data))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tp", TPS)
def test_quantized_shards_equal_jax_shard_tree(bits, tp):
    """shard_params on quantized weights (no process group: an explicit
    (rank, size)) equals JAX's shard_tree bit for bit: an INT8 weight's
    per-channel scale cut with its columns and whole with its rows, an INT4
    weight's packed rows and group scales cut on both weight axes. The
    port's own out-major INT8 values keep their layout in every shard."""
    import jax

    from quantizedmha_tpu.serving.sharded import make_tp_mesh, shard_tree
    from quantizedmha_tpu.serving.sharded import tp_param_specs as jspecs

    name = "w8a8" if bits == 8 else "w4"
    _, jp, tree = _jax_models(CASES[name][0], bits)
    placed = shard_tree(jp, jspecs(), make_tp_mesh(tp))
    mine = params_from_numpy(tree, device="cpu")
    own = quantize_llama_params(tl.init_params(_model_cfg(dict(seed=0)),
                                               torch.Generator().manual_seed(0),
                                               device="cpu"), bits=8)
    for pos in range(tp):
        got = params_to_numpy(shard_params(mine, tp_param_specs(), (pos, tp)))
        flat = jax.tree_util.tree_flatten_with_path(
            placed, is_leaf=lambda x: hasattr(x, "addressable_shards"))[0]
        for path, leaf in flat:
            node = got
            for key in path:
                node = node[key.key] if hasattr(key, "key") else node[key.name]
            dev = leaf.sharding.mesh.devices.flat[pos]
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(node, np.asarray(shard.data))
        for k in ("wq", "wo", "w_down"):
            v = shard_params(own, tp_param_specs(), (pos, tp))["layers"][k].values
            assert v.transpose(-1, -2).is_contiguous(), k


def test_tp_engine_refusals(ranks):
    """TPEngine raises when tp does not divide the kv heads and when the mesh
    has no such axis; nothing falls back to one rank."""
    for r in ranks:
        assert "must divide" in r["errors"]["heads"]
        assert "have no 'dp'" in r["errors"]["axis"]


def test_shard_params_refuses_halves_rows_and_fused_projections():
    """A 'halves'-packed INT4 weight cut on its rows would mix rows of both
    halves in a shard (JAX's shard_tree does: its row shard of packed rows
    holds input rows i and in/2 + i); the port raises. Fused projections
    have no spec; the port names the unfused layout."""
    import jax.numpy as jnp

    from quantizedmha_tpu.quant.weights import quantize_weight4 as jq4

    w = np.random.default_rng(0).normal(0, 1, (2, 256, 64)).astype(np.float32)
    halves = quantize_weight4(torch.from_numpy(w), group=64, packing="halves")
    with pytest.raises(ValueError, match="halves"):
        shard_params({"w": halves}, {"w": tl.P(None, "tp", None)}, (0, 2))
    cols = shard_params({"w": halves}, {"w": tl.P(None, None, "tp")}, (1, 2))["w"]
    assert torch.equal(cols.packed, halves.packed[..., 32:])
    # JAX: rank 0's packed rows [0, 64) hold input rows 0-63 and 128-191,
    # not the contiguous 0-127 that its row-parallel product needs.
    jw = jq4(jnp.asarray(w), group=64, packing="halves")
    assert jw.packing == "halves" and np.asarray(jw.packed).shape == (2, 128, 64)
    layers = quantize_llama_params(tl.init_params(tl.LlamaConfig.tiny(dtype=torch.float32),
                                                  torch.Generator().manual_seed(0),
                                                  device="cpu"), bits=4, group=64)["layers"]
    fused = fuse_w4_projections(layers)
    with pytest.raises(ValueError, match="unfused layout"):
        shard_params(fused, tp_param_specs()["layers"], (0, 2))


def test_llama70b_tp8_plan_fits_h100():
    """The 70B plan, abstract (meta tensors; nothing is allocated): bf16
    weights under tp_param_specs at tp=8 plus an INT8 paged KV cache for 8 x
    8192-token sequences a rank equal JAX's plan (jax.eval_shape) and fit an
    H100's 80 GB (JAX :141, sized for the v5p's 96 GiB)."""
    import jax

    from quantizedmha_tpu.models import llama as jl
    from quantizedmha_tpu.serving.sharded import tp_param_specs as jspecs

    tp = 8
    cfg = tl.LlamaConfig.llama3_70b()
    lcfg = local_config(cfg, tp)
    assert (lcfg.num_heads, lcfg.num_kv_heads) == (8, 1)
    mine = weight_bytes(shard_params(tl.init_params(cfg, device="meta"), tp_param_specs(),
                                     (0, tp)))
    abstract = jax.eval_shape(lambda k: jl.init_params(jl.LlamaConfig.llama3_70b(), k),
                              jax.random.PRNGKey(0))

    def sharded(leaf, spec):
        n = leaf.size * 2
        return n // tp if "tp" in tuple(spec) else n
    theirs = sum(jax.tree_util.tree_leaves(jax.tree.map(
        sharded, abstract, jspecs(), is_leaf=lambda x: hasattr(x, "shape"))))
    assert mine == theirs
    kv = cfg.num_layers * lcfg.num_kv_heads * 8 * 8192 * cfg.hd * 2
    assert 15 * 2**30 < mine + kv < 80e9


def test_layer_by_layer_params_equal_init_and_quantize():
    """chip_smoke's serve_tp / serve_cp ranks make their weights layer by
    layer (LayerStack / Lazy leaves, shard_params keeping each rank's
    shard): the numbers of quantize_llama_params(init_params(...)) bit for
    bit, out-major INT8 values included, so that the unsharded engine on
    init_params' weights is the same model; a draft cut to the first layers
    equals those layers."""
    import chip_smoke

    cfg = tl.LlamaConfig.tiny(num_layers=3, dtype=torch.float32)
    full = quantize_llama_params(tl.init_params(cfg, torch.Generator().manual_seed(5),
                                                device="cpu"), bits=8)
    for keep in (None, 2):
        lazy = chip_smoke._serve_params_lazy(cfg, 5, keep_layers=keep, device="cpu")
        got = shard_params(lazy, tp_param_specs(), (0, 1))
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], full[k]), k
        for k, v in full["layers"].items():
            g = got["layers"][k]
            if isinstance(v, QuantizedWeight):
                assert torch.equal(g.values, v.values[:keep]), k
                assert torch.equal(g.scale, v.scale[:keep]), k
                assert g.values.transpose(-1, -2).is_contiguous(), k
            else:
                assert torch.equal(g, v[:keep]), k
