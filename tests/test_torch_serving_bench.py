"""PyTorch port vs JAX package: the serving benchmark's accounting
(decode_step_bytes, model_matmul_params), the layout of its device-drawn
parameters, and its decode loop on a tiny w4 model on the CPU.

Tolerances: byte and parameter counts are integers and must be equal; the
benchmark's row must carry every key the JAX package's row carries, and
its speed-of-light fields must agree with the standalone accounting.
The drawn values differ (torch.Generator vs jax.random) and are not
compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.harness import serving_bench as jsb
from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu_torch.harness import serving_bench as tsb
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.ops import w4_matmul as tm
from quantizedmha_tpu_torch.quant import weights as tw

TINY = dict(num_layers=2, num_heads=4, num_kv_heads=2, attention_impl="flash_int8")


def _layout(t):
    """{path: (shape, dtype name)} of a params tree, JAX or port."""
    if isinstance(t, (jw.QuantizedWeight, tw.QuantizedWeight)):
        return {"values": _layout(t.values), "scale": _layout(t.scale)}
    if isinstance(t, (jw.QuantizedWeight4, tw.QuantizedWeight4)):
        return {"packed": _layout(t.packed), "scale": _layout(t.scale),
                "meta": (t.group, t.packing)}
    if isinstance(t, dict):
        return {k: _layout(v) for k, v in t.items()}
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


@pytest.mark.parametrize("cfg_name", ["llama3_8b", "qwen2_7b"])
def test_model_matmul_params_equal_jax(cfg_name):
    assert (tsb.model_matmul_params(getattr(tl.LlamaConfig, cfg_name)())
            == jsb.model_matmul_params(getattr(jl.LlamaConfig, cfg_name)()))


@pytest.mark.parametrize("bits,lm_head_bits", [(8, None), (4, 8), (4, None)])
def test_device_init_layout_and_step_bytes_equal_jax(bits, lm_head_bits):
    jc = jl.LlamaConfig.tiny(num_layers=3, num_heads=4, num_kv_heads=2)
    tc = tl.LlamaConfig.tiny(num_layers=3, num_heads=4, num_kv_heads=2)
    jp = jsb.device_init_quant_params(jc, bits=bits, group=32, lm_head_bits=lm_head_bits)
    tp = tsb.device_init_quant_params(tc, bits=bits, group=32, lm_head_bits=lm_head_bits,
                                      device="cpu")
    assert _layout(tp) == _layout(jp)
    assert tw.weight_bytes(tp) == jw.weight_bytes(jp)
    for ctx, batch in ((40, 3), (129, 1)):
        assert (tsb.decode_step_bytes(tc, tp, batch, ctx, 16)
                == jsb.decode_step_bytes(jc, jp, batch, ctx, 16))
    if bits == 4:
        lo, hi = tm.unpack_nibbles(tp["layers"]["w_down"].packed)
        assert -7 <= int(lo.min()) and int(lo.max()) <= 7
        assert -7 <= int(hi.min()) and int(hi.max()) <= 7
        fused = tw.fuse_w4_projections(tp["layers"])
        jfused = jw.fuse_w4_projections(jp["layers"])
        assert _layout(fused) == _layout(jfused)


def test_device_init_refuses_halves_without_whole_groups():
    cfg = tl.LlamaConfig.tiny(num_layers=1, hidden_size=192, num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError, match="halves"):
        tsb.device_init_quant_params(cfg, bits=4, group=64, device="cpu")


def test_run_decode_bench_tiny_w4_model_has_jax_keys():
    jc = jl.LlamaConfig.tiny(**TINY)
    tc = tl.LlamaConfig.tiny(**TINY)
    kw = dict(batch=2, prompt_len=32, max_new=8, chunk=4, page_size=16, num_pages=32,
              hbm_gbps=819.0)
    jp = jsb.device_init_quant_params(jc, bits=4, group=32, lm_head_bits=8)
    jp = dict(jp, layers=jw.fuse_w4_projections(jp["layers"]))
    want = jsb.run_decode_bench(jc, jp, **kw)
    tp = tsb.device_init_quant_params(tc, bits=4, group=32, lm_head_bits=8, device="cpu")
    tp = dict(tp, layers=tw.fuse_w4_projections(tp["layers"]))
    row = tsb.run_decode_bench(tc, tp, device="cpu", **kw)
    assert set(want) <= set(row)
    assert row["measured_tokens"] == want["measured_tokens"] > 0
    assert row["decode_toks_per_s"] > 0
    assert row["hbm_bytes_per_step"] == want["hbm_bytes_per_step"] == tsb.decode_step_bytes(
        tc, tp, 2, 32 + 4 + (8 - 4) // 2, 16)
    assert row["decode_pct_hbm_sol"] == pytest.approx(
        100.0 * row["decode_sol_ms_per_step"] / row["decode_ms_per_step"])
    # Every request (the batch and the TTFT one) returned max_new tokens;
    # the engine counted every decode step it ran.
    assert row["tokens_per_request"] == [8] and row["requests_failed"] == 0
    assert row["decode_steps"] >= 8 + 8 and row["device"] == "cpu"


def test_run_decode_bench_needs_a_bandwidth_off_the_gpu():
    tc = tl.LlamaConfig.tiny(**TINY)
    tp = tsb.device_init_quant_params(tc, bits=8, device="cpu")
    with pytest.raises(ValueError, match="hbm_gbps"):
        tsb.run_decode_bench(tc, tp, batch=1, prompt_len=32, max_new=4, chunk=2,
                             page_size=16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsb.run_prefill_bench(tc, tp)


def test_w4_params_serve_through_the_kernel_wrapper(monkeypatch):
    """Decode matmuls of a fused w4 model go through ops.w4_matmul: 4 a
    layer a decode step, and none from prefills above _W4_DECODE_ROWS."""
    tc = tl.LlamaConfig.tiny(**TINY)
    tp = tsb.device_init_quant_params(tc, bits=4, group=32, lm_head_bits=8, device="cpu")
    tp = dict(tp, layers=tw.fuse_w4_projections(tp["layers"]))
    calls = []
    real = tw.w4_matmul
    monkeypatch.setattr(tw, "w4_matmul", lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    row = tsb.run_decode_bench(tc, tp, batch=2, prompt_len=128, max_new=6, chunk=3,
                               page_size=16, num_pages=64, hbm_gbps=1.0, device="cpu")
    assert len(calls) == 4 * tc.num_layers * row["decode_steps"]
    assert set(calls) <= {1, 2}
