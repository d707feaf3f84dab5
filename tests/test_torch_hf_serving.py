"""PyTorch port vs JAX package: a Gemma-2 checkpoint that transformers
writes (Gemma2ForCausalLM, random weights, save_pretrained, no download),
loaded by both packages' load_llama with INT8 weights (w8a16), served in
f32 with attention_impl="flash_int8" through both engines with hybrid_kv:
the loaded leaves, the greedy streams and the counters equal. JAX's Pallas
kernels run in interpret mode; the port's plain versions.

Then the public names the port adds beside it, each held to its JAX twin:
the top-level mha_reference_shaped, reference.fake_quant_int8,
serving.append_token and profiling.trace.device_memory_profile (a snapshot
of the CUDA caching allocator, which raises without a card; JAX's writes a
pprof of the CPU's buffers)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantizedmha_tpu as jqm
import quantizedmha_tpu_torch as tqm
from quantizedmha_tpu.models import hf_loader as jh
from quantizedmha_tpu.serving.engine import Engine as JEngine
from quantizedmha_tpu.serving.engine import EngineConfig as JEngineConfig
from quantizedmha_tpu_torch.models import hf_loader as th
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from test_torch_hf_loader import _assert_tree_equal

COUNTERS = ("requests_admitted", "prefill_tokens", "pages_trimmed", "decode_steps")
ENGINE = dict(num_pages=48, page_size=4, max_batch=2, max_pages_per_seq=12,
              prefill_buckets=(8, 16), max_new_tokens=6, decode_chunk=2, hybrid_kv=True,
              hybrid_pages={"w8": 16, "full": 48})


@pytest.fixture(scope="module")
def gemma2_ckpt(tmp_path_factory):
    tfs = pytest.importorskip("transformers")
    path = tmp_path_factory.mktemp("gemma2") / "hf"
    torch.manual_seed(7)
    model = tfs.Gemma2ForCausalLM(tfs.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
        rms_norm_eps=1e-6, sliding_window=8, query_pre_attn_scalar=16.0,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0)).eval().float()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1 if p.dim() == 1 else 0.08)
    model.save_pretrained(path, safe_serialization=True)
    return path


def test_gemma2_checkpoint_served_w8a16_flash_int8_like_jax(gemma2_ckpt):
    jcfg = dataclasses.replace(jh.config_from_hf(gemma2_ckpt), dtype=jnp.float32,
                               attention_impl="flash_int8")
    tcfg = dataclasses.replace(th.config_from_hf(gemma2_ckpt), dtype=torch.float32,
                               attention_impl="flash_int8")
    assert tcfg.window_pattern == (8, None) and tcfg.hd == 16
    jp = jh.load_llama(gemma2_ckpt, jcfg, quantize=True, dtype=jnp.float32)
    tp = th.load_llama(gemma2_ckpt, tcfg, quantize=True, dtype=torch.float32, device="cpu")
    _assert_tree_equal(jp, tp)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 128, n).tolist() for n in (13, 6)]
    jeng = JEngine(jcfg, jp, JEngineConfig(**ENGINE))
    teng = Engine(tcfg, tp, EngineConfig(**ENGINE), device="cpu")
    for eng in (jeng, teng):
        for p in prompts:
            eng.add_request(list(p))
    want, got = jeng.run(), teng.run()
    assert teng.hybrid and jeng.hybrid
    assert got == want and all(len(s) == ENGINE["max_new_tokens"] for s in got.values())
    counts = [{c: e.metrics.counter(c) for c in COUNTERS} for e in (jeng, teng)]
    assert counts[1] == counts[0] and counts[1]["pages_trimmed"] > 0


# --- public names -------------------------------------------------------------

def test_mha_reference_shaped_exported_like_jax():
    assert "mha_reference_shaped" in tqm.__all__ and "mha_reference_shaped" in jqm.__all__
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 12, 16)).astype(np.float32) for _ in range(3))
    got = tqm.mha_reference_shaped(*map(torch.from_numpy, (q, k, v)), causal=True,
                                   use_rope=True)
    want = jqm.mha_reference_shaped(*map(jnp.asarray, (q, k, v)), causal=True, use_rope=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fake_quant_int8_matches_jax():
    from quantizedmha_tpu.reference import quant_ref as jref
    from quantizedmha_tpu_torch.reference import fake_quant_int8

    x = np.random.default_rng(1).standard_normal((2, 3, 16, 8)).astype(np.float32) * 3
    for axis in ((-2, -1), -1):
        want = np.asarray(jref.fake_quant_int8(jnp.asarray(x), axis=axis))
        np.testing.assert_array_equal(fake_quant_int8(torch.from_numpy(x), axis=axis).numpy(),
                                      want)


def test_append_token_matches_jax():
    from quantizedmha_tpu.serving import kv_cache as jkv
    from quantizedmha_tpu_torch.serving import PagedKVCacheState, append_token

    rng = np.random.default_rng(3)
    hkv, pages, page, d = 2, 5, 4, 8
    kp, vp = rng.integers(-127, 128, (2, hkv, pages, page, d)).astype(np.int8)
    ks, vs = rng.uniform(0.01, 0.05, (2, hkv, pages)).astype(np.float32)
    jstate = jkv.PagedKVCacheState(*(jnp.asarray(a) for a in (kp, vp, ks, vs)))
    tstate = PagedKVCacheState(*(torch.from_numpy(a.copy()) for a in (kp, vp, ks, vs)))
    for page_id, slot in ((3, 0), (3, 1), (1, 2)):  # a page's first token fits its scale
        k_tok, v_tok = rng.standard_normal((2, hkv, d)).astype(np.float32)
        jstate = jkv.append_token(jstate, jnp.asarray(k_tok), jnp.asarray(v_tok), page_id, slot)
        tstate = append_token(tstate, torch.from_numpy(k_tok), torch.from_numpy(v_tok),
                              page_id, slot)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)


def test_device_memory_profile_raises_without_a_card(tmp_path):
    from quantizedmha_tpu.profiling import trace as jtrace
    from quantizedmha_tpu_torch.profiling import trace as ttrace

    prof = jtrace.device_memory_profile(str(tmp_path / "jax" / "mem.prof"))
    assert prof and (tmp_path / "jax" / "mem.prof").read_bytes() == prof
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is the CPU's")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrace.device_memory_profile(str(tmp_path / "port" / "mem.pkl"))
    assert not (tmp_path / "port").exists()
