"""PyTorch port vs JAX package: the serving path (prefill, paged INT8
decode, continuous-batching engine) on a tiny f32 Llama with w8a16 weights
and flash_int8 attention, plus the port's hygiene rules.

Logit tolerance: a 1-ulp f32 difference between the frameworks (matmul
order, exp/pow/cos) can flip one int8 rounding of K/V in the cache or of P
in the kernel, a change the size of the int8 quantization step. The
bound is therefore atol = rtol = 1e-2 on logits of std ~1 — far above the
observed ~1e-5, far below the ~1e-1 int8-vs-float error of the path.
Greedy token streams must be equal."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu.serving import llama_adapter as jad
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu.serving.kv_cache import PageAllocator
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.serving import llama_adapter as tad
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "quantizedmha_tpu_torch"


def to_numpy_tree(t):
    if isinstance(t, jw.QuantizedWeight):
        return {"values": np.asarray(t.values), "scale": np.asarray(t.scale)}
    if isinstance(t, dict):
        return {k: to_numpy_tree(v) for k, v in t.items()}
    return np.asarray(t)


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, num_heads=4, num_kv_heads=2, attention_impl="flash_int8")
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jp = jw.quantize_llama_params(jl.init_params(jc, jax.random.PRNGKey(7)), bits=8)
    return jc, jp, tc, params_from_numpy(to_numpy_tree(jp), device="cpu")


def test_prefill_and_decode_logits_match_jax(models):
    jc, jp, tc, tp = models
    page = 16
    prompt = np.random.default_rng(3).integers(0, jc.vocab_size, 37).tolist()
    alloc = PageAllocator(12, page, scrap_page=0)
    pages = alloc.admit(0, len(prompt))
    toks = np.zeros((1, 64), np.int32)
    toks[0, :len(prompt)] = prompt
    jlog, jk, jv = jad.prefill_at(jc, jp, jnp.asarray(toks), jnp.int32(len(prompt) - 1))
    tlog, tk, tv = tad.prefill_at(tc, tp, torch.from_numpy(toks), len(prompt) - 1)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)

    n_write = len(pages) * page
    ids = np.asarray(pages, np.int32)
    jcache = jad.write_prefill(jc, jad.make_cache(jc, 12, page), jk[:, :, :n_write],
                               jv[:, :, :n_write], jnp.asarray(ids), page_size=page)
    tcache = tad.write_prefill(tc, tad.make_cache(tc, 12, page, device="cpu"),
                               tk[:, :, :n_write], tv[:, :, :n_write],
                               torch.from_numpy(ids), page_size=page)
    tok = int(np.argmax(np.asarray(jlog[0])))
    for _ in range(3):
        pos = alloc.lengths[0]
        pid, slot, _ = alloc.extend(0)
        args = ([tok], [pos], [pid], [slot], alloc.lengths_array([0]),
                alloc.block_table_array([0], 4))
        jd, jcache = jad.decode_step(jc, jp, jcache, *(jnp.asarray(a, jnp.int32) for a in args))
        td, tcache = tad.decode_step(tc, tp, tcache,
                                     *(torch.as_tensor(np.asarray(a, np.int32)) for a in args))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-2, atol=1e-2)
        tok = int(np.argmax(np.asarray(jd[0])))


def test_decode_loop_matches_stepwise(models):
    """The on-device loop equals n single decode_steps fed their argmax."""
    _, _, tc, tp = models
    page = 16
    prompt = torch.zeros((1, 32), dtype=torch.int32)
    prompt[0, :20] = torch.arange(5, 25)
    logits, k, v = tad.prefill_at(tc, tp, prompt, 19)
    caches = []
    for _ in range(2):
        c = tad.make_cache(tc, 6, page, device="cpu")
        tad.write_prefill(tc, c, k[:, :, :32] * (torch.arange(32) < 20)[None, None, :, None],
                          v[:, :, :32] * (torch.arange(32) < 20)[None, None, :, None],
                          torch.tensor([1, 2]), page_size=page)
        caches.append(c)
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    first = torch.argmax(logits, -1).to(torch.int32)
    out, _ = tad.decode_loop(tc, tp, caches[0], first, torch.tensor([20]), tables,
                             n_steps=5, page_size=page)
    tok, toks = first, []
    for i in range(5):
        pos = torch.tensor([20 + i])
        lg, _ = tad.decode_step(tc, tp, caches[1], tok, pos, tables[0, pos // page],
                                pos % page, pos + 1, tables)
        tok = torch.argmax(lg, -1).to(torch.int32)
        toks.append(int(tok))
    assert out[:, 0].tolist() == toks


def _serve(engine_cls, cfg_cls, cfg, params, prompts, **kw):
    ecfg = cfg_cls(num_pages=16, page_size=16, max_batch=2, max_pages_per_seq=16,
                   prefill_buckets=(128, 256), max_new_tokens=6, **kw)
    eng = engine_cls(cfg, params, ecfg) if engine_cls is JEngine else engine_cls(
        cfg, params, ecfg, device="cpu")
    rids = [eng.add_request(p) for p in prompts]
    return eng, eng.run(), rids


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_greedy_streams_match_jax(models, chunk):
    """Same requests through both engines: continuous batching (3 requests,
    2 lanes), bucketed prefill, paged decode; equal greedy streams."""
    jc, jp, tc, tp = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist() for n in (20, 100, 150)]
    _, want, _ = _serve(JEngine, JEngineConfig, jc, jp, prompts, decode_chunk=chunk)
    eng, got, rids = _serve(Engine, EngineConfig, tc, tp, prompts, decode_chunk=chunk)
    assert got == want
    assert all(len(got[r]) == 6 for r in rids)
    assert eng.alloc.free_pages == 15  # every page back but the scrap page


def test_long_prompt_fails_alone(models):
    """A prompt past the largest bucket needs chunked prefill, which is not
    ported: that request fails into `failed`, the others are served."""
    _, _, tc, tp = models
    prompts = [[1] * 30, [2] * 300, [3] * 40]
    eng, out, rids = _serve(Engine, EngineConfig, tc, tp, prompts, decode_chunk=2)
    assert set(eng.failed) == {rids[1]} and "chunked prefill" in eng.failed[rids[1]]
    assert out[rids[1]] == [] and len(out[rids[0]]) == 6 and len(out[rids[2]]) == 6


def test_eos_and_max_new(models):
    _, _, tc, tp = models
    eng = Engine(tc, tp, EngineConfig(num_pages=8, page_size=16, max_batch=2,
                                      prefill_buckets=(64,), max_new_tokens=4),
                 device="cpu")
    probe = eng.add_request([9] * 10)
    one = eng.add_request([9] * 10, max_new=1)
    out = eng.run()
    assert len(out[probe]) == 4 and len(out[one]) == 1
    eos = out[probe][1]
    eng2 = Engine(tc, tp, EngineConfig(num_pages=8, page_size=16, max_batch=2,
                                       prefill_buckets=(64,), max_new_tokens=4,
                                       eos_id=eos), device="cpu")
    r = eng2.add_request([9] * 10)
    assert eng2.run()[r] == out[probe][:out[probe].index(eos) + 1]


@pytest.mark.parametrize("field,value", [
    ("prefix_cache", True), ("interleaved_prefill", True), ("hybrid_kv", True),
    ("mixed_kv", {"boundary_tokens": 16, "int8_pages": 4, "int4_pages": 4}),
    ("cp_mesh", object())])
def test_unported_engine_options_raise(models, field, value):
    _, _, tc, tp = models
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(tc, tp, EngineConfig(**{field: value}), device="cpu")


def test_async_dispatch_refused(models):
    _, _, tc, tp = models
    with pytest.raises(ValueError):
        Engine(tc, tp, EngineConfig(async_dispatch=True, decode_chunk=4), device="cpu")


# --- hygiene ---------------------------------------------------------------


def test_port_imports_no_jax():
    code = ("import sys, quantizedmha_tpu_torch, quantizedmha_tpu_torch.serving.engine, "
            "quantizedmha_tpu_torch.models.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'quantizedmha_tpu' or m.startswith('quantizedmha_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_mention_no_jax():
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "quantizedmha_tpu." not in text.replace("quantizedmha_tpu_torch.", ""), path


def _entry_points(models):
    _, _, tc, tp = models
    x = torch.ones((8, 16))
    return {
        "solve": lambda: __import__("quantizedmha_tpu_torch").solve(x, x, x, 16, 2),
        "init_params": lambda: tl.init_params(tc),
        "params_from_numpy": lambda: params_from_numpy({"a": np.ones(2)}),
        "make_cache": lambda: tad.make_cache(tc, 4, 16),
        "Engine": lambda: Engine(tc, tp, EngineConfig()),
    }


@pytest.mark.parametrize("name", ["solve", "init_params", "params_from_numpy",
                                  "make_cache", "Engine"])
def test_entry_points_default_to_cuda(models, name):
    """Without a card and without device='cpu' an entry point raises; it
    never runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points(models)[name]()
