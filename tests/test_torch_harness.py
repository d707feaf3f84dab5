"""PyTorch port vs JAX package: the harness's timing record and benchmark
loop, and the roofline's FLOP, byte and speed-of-light accounting.

Tolerances: counts of pairs, FLOPs and bytes are exact and must be equal;
shares and rates are float64 arithmetic on the same numbers and must agree
to 1e-12 relative. Timing's properties are the same arithmetic on the same
fields and must be equal."""

import importlib

import pytest
import torch

from quantizedmha_tpu.harness import timing as jtiming
from quantizedmha_tpu_torch.harness import timing as ttiming

# Both profiling packages export a `roofline` function that shadows the
# submodule's name.
jroof = importlib.import_module("quantizedmha_tpu.profiling.roofline")
troof = importlib.import_module("quantizedmha_tpu_torch.profiling.roofline")


@pytest.mark.parametrize("fields", [
    (2e-3, [3e-3, 1.5e-3, 2.5e-3], 1.8e-3),
    (2e-3, [], 0.0),
    (4.25e-4, [4.25e-4], 4.0e-4),
    (0.0, [1e-3, 2e-3], 0.0),
])
def test_timing_properties_equal_jax(fields):
    j, t = jtiming.Timing(*fields), ttiming.Timing(*fields)
    for name in ("median_s", "median_ms", "best_ms", "spread"):
        assert getattr(t, name) == getattr(j, name), name
    assert str(t) == str(j)


def test_benchmark_on_the_cpu_times_every_call():
    calls = []
    x = torch.randn(64, 64)

    def fn(a):
        calls.append(1)
        return a @ a

    t = ttiming.benchmark(fn, x, warmup=2, runs=4, repeats=3)
    assert len(calls) == 2 + 4 * 3
    assert len(t.pair_estimates_s) == 3 and all(s > 0 for s in t.pair_estimates_s)
    assert t.estimate_s == sorted(t.pair_estimates_s)[1] and t.best_s == min(t.pair_estimates_s)
    assert t.median_ms > 0 and t.best_ms <= t.median_ms
    with pytest.raises(ValueError, match="runs"):
        ttiming.benchmark(fn, x, runs=0)


def test_benchmark_reads_where_the_result_lies():
    assert ttiming._on_cuda((torch.zeros(1), {"a": [torch.zeros(1)]})) is False
    assert ttiming._on_cuda(None) is False


GRID = [
    # batch, heads, q_len, kv_len, head_dim, causal, window, sinks
    (1, 32, 8192, 8192, 32, False, None, 0),
    (2, 4, 128, 128, 64, True, None, 0),
    (1, 2, 100, 300, 128, True, None, 0),
    (1, 4, 128, 128, 64, True, 16, 0),
    (1, 4, 128, 128, 64, True, 16, 4),
    (3, 1, 37, 53, 32, True, 8, 3),
]


@pytest.mark.parametrize("case", GRID)
def test_attention_accounting_equals_jax(case):
    b, h, sq, skv, d, causal, window, sinks = case
    assert (troof.visible_pairs(b, h, sq, skv, causal, window, sinks)
            == jroof.visible_pairs(b, h, sq, skv, causal, window, sinks))
    assert (troof.attention_flops(b, h, sq, skv, d, causal, window, sinks)
            == jroof.attention_flops(b, h, sq, skv, d, causal, window, sinks))
    for kw in ({}, {"bytes_per_el": 2}, {"q_bytes": 4, "kv_bytes": 1, "o_bytes": 4}):
        assert (troof.attention_bytes(b, h, sq, skv, d, **kw)
                == jroof.attention_bytes(b, h, sq, skv, d, **kw))


@pytest.mark.parametrize("dtype", ["bf16", "bfloat16", "fp16", "int8"])
@pytest.mark.parametrize("time_s,flops,nbytes", [(0.02, 1e12, 1e9), (1e-3, 2.75e11, 1e8),
                                                 (5e-4, 1e9, 4e9)])
def test_roofline_equals_jax_on_the_same_spec(dtype, time_s, flops, nbytes):
    spec = ("test", 100.0, 200.0, 1000.0)
    got = troof.roofline(time_s, flops, nbytes, dtype=dtype, chip=troof.ChipSpec(*spec))
    want = jroof.roofline(time_s, flops, nbytes, dtype=dtype, chip=jroof.ChipSpec(*spec))
    for f in ("tflops_achieved", "pct_of_compute_sol", "pct_of_memory_sol"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)
    assert got.compute_bound == want.compute_bound
    assert got.chip == want.chip and got.dtype == want.dtype


def test_fp32_peak_is_bf16_over_three():
    spec = troof.chip_spec("NVIDIA H100 80GB HBM3")
    assert spec.peak_for("fp32") == spec.peak_for("float32") == spec.bf16_tflops / 3.0
    # Above the CUDA cores' float32 rate: no f32 kernel can beat 100%.
    assert spec.peak_for("fp32") > spec.cuda_core_tflops
    assert (spec.bf16_tflops, spec.int8_tops, spec.hbm_gbps) == (989.0, 1979.0, 3350.0)
    # solve(fa) at the reference workload: the f32 flash kernel's 3.74 ms
    # (PERF.md) stays under 100% of the fp32 speed of light; against the
    # CUDA cores' 67 TF/s it would read 110%.
    flops = troof.attention_flops(1, 32, 8192, 8192, 32)
    assert troof.roofline(3.74e-3, flops, 0, dtype="fp32", chip=spec).pct_of_compute_sol < 100


def test_unknown_card_raises(monkeypatch):
    with pytest.raises(ValueError, match="no peaks known"):
        troof.chip_spec("TPU v5 lite")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        troof.detect_chip()


def test_attention_achievable_is_the_busiest_unit():
    spec = troof.chip_spec("NVIDIA H100 80GB HBM3")
    r = troof.attention_achievable(2e-3, batch=1, heads=32, q_len=8192, kv_len=8192,
                                   head_dim=32, dtype="int8_bf16pv", chip=spec)
    pairs = 32 * 8192.0 * 8192
    assert r.t_vpu_s == pytest.approx(pairs / spec.exp_per_s, rel=1e-12)
    assert r.t_mxu_s == pytest.approx(2 * pairs * 32 / 1979e12 + 2 * pairs * 32 / 989e12,
                                      rel=1e-12)
    assert r.t_achievable_s == max(r.t_mxu_s, r.t_vpu_s, r.t_hbm_s) == r.t_vpu_s
    assert r.pct_of_achievable == pytest.approx(100 * r.t_vpu_s / 2e-3)
    assert not r.calibrated and "uncalibrated" in str(r)
    with pytest.raises(ValueError, match="SFU"):
        troof.attention_achievable(1.0, batch=1, heads=1, q_len=8, kv_len=8, head_dim=8,
                                   chip=troof.ChipSpec("test", 1.0, 2.0, 3.0))
