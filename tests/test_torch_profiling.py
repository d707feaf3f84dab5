"""PyTorch port vs JAX package: the profiling suite (bench-report compare,
device info, torch.profiler capture and its summary, memory budgets).

Tolerances: compare's markdown must equal the JAX package's character for
character; byte counts are exact; trace times are only required to be
positive (a CPU run measures no device)."""

import json

import pytest
import torch

from quantizedmha_tpu.profiling import compare as jcmp
from quantizedmha_tpu_torch.profiling import compare as tcmp
from quantizedmha_tpu_torch.profiling import device_info as di
from quantizedmha_tpu_torch.profiling import memory as mem
from quantizedmha_tpu_torch.profiling import trace as tr
from quantizedmha_tpu_torch.profiling import trace_summary as ts


def _payload(device="NVIDIA H100 80GB HBM3", **kernels):
    return {
        "device": device,
        "workload": {"n": 1024},
        "results": [
            {"kernel": k, "ms": ms, "tflops": tf, "pct_mxu_sol": sol,
             "pct_hbm_sol": None, "check": {"n_mismatch": 0, "n_nonfinite": 0},
             "error": None}
            for k, (ms, tf, sol) in kernels.items()
        ],
    }


def _pairs():
    err = _payload(fa_int8=(0.5, 200.0, 50.0))
    err["results"][0]["error"] = "boom"
    bad = _payload("cpu", fa=(3.0, None, None))
    bad["results"][0]["check"] = {"n_mismatch": 3, "n_nonfinite": 1}
    return [
        (_payload(fa=(2.0, 50.0, 25.0)), _payload(fa=(1.0, 100.0, 50.0))),
        (_payload(fa=(1.0, 100.0, 50.0)), _payload(fa=(2.0, 50.0, 25.0))),
        (_payload(fa=(1.0, 100.0, 50.0)), err),
        (_payload(fa=(1.0, 100.0, 50.0), unfused=(40.0, 7.0, 2.0)), bad),
    ]


@pytest.mark.parametrize("i", range(4))
def test_compare_reports_equal_jax(tmp_path, i):
    a, b = _pairs()[i]
    notes = {"fa": "doubled the block size"}
    assert (tcmp.compare_reports(a, b, "before", "after", notes=notes)
            == jcmp.compare_reports(a, b, "before", "after", notes=notes))
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    assert tcmp.main([str(pa), str(pb), "-o", str(tmp_path / "t.md"),
                      "--note", "fa=doubled"]) == 0
    assert jcmp.main([str(pa), str(pb), "-o", str(tmp_path / "j.md"),
                      "--note", "fa=doubled"]) == 0
    assert (tmp_path / "t.md").read_text() == (tmp_path / "j.md").read_text()
    assert "> doubled" in (tmp_path / "t.md").read_text()


def test_device_info_and_dump_on_the_cpu(tmp_path, monkeypatch):
    info = di.device_info("cpu")
    for key in ("platform", "device_kind", "num_devices", "peak_bf16_tflops",
                "peak_hbm_gbps"):
        assert key in info
    assert info["platform"] == "cpu" and info["peak_bf16_tflops"] is None
    out = di.dump(tmp_path / "device_info.txt", device="cpu")
    assert "device_kind" in out.read_text()
    assert json.loads(out.with_suffix(".json").read_text())["platform"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        di.device_info()


def test_capture_and_summarize_a_cpu_trace(tmp_path):
    x = torch.randn(128, 128)
    calls = []

    def fn(a):
        calls.append(1)
        with tr.annotate("region"):
            return torch.tanh(a @ a) @ a

    cap = tr.capture(fn, x, trace_dir=tmp_path / "t", iters=2, warmup=1)
    assert len(calls) == 3 and cap.iters == 2 and cap.wall_s > 0 and cap.per_iter_ms > 0
    assert "trace.json" in cap.files
    summary_file = json.loads((tmp_path / "t" / "capture_summary.json").read_text())
    assert summary_file["per_iter_ms"] == cap.per_iter_ms
    summary = ts.summarize_trace(str(tmp_path / "t"))
    assert summary.plane == "host" and summary.ops and summary.total_ms > 0
    names = [o.name for o in summary.ops]
    # Top-level operators only: the matmuls run inside the annotation.
    assert "region" in names and "aten::mm" not in names
    assert summary.ops == sorted(summary.ops, key=lambda o: -o.total_ms)
    md = summary.to_markdown(top=5)
    assert "| op |" in md and summary.plane in md
    with pytest.raises(FileNotFoundError):
        ts.summarize_trace(str(tmp_path / "empty"))


def test_device_plane_groups_kernels(tmp_path):
    """A Chrome trace with device kernels is summarized by kernel and by
    KERNEL_GROUPS, the grouping chip_smoke.py's profiles use."""
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": i * 10.0, "dur": d,
               "pid": 0, "tid": 7}
              for i, (n, d) in enumerate([("void flash_int8_bf16p_kernel<32>", 1400.0),
                                          ("nvjet_tst_128x256", 300.0),
                                          ("void flash_int8_bf16p_kernel<32>", 1500.0),
                                          ("elementwise_kernel", 20.0)])]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 9e3,
                   "pid": 1, "tid": 1})
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    s = ts.summarize_trace(str(tmp_path))
    assert s.plane == "device" and s.total_ms == pytest.approx(3.22)
    assert [(o.name, o.count) for o in s.ops][0] == ("void flash_int8_bf16p_kernel<32>", 2)
    assert [(g.name, g.count, g.total_ms) for g in s.groups] == [
        ("flash_int8_fwd", 2, 2.9), ("gemm", 1, 0.3), ("other", 1, 0.02)]
    host = ts.summarize_trace(str(tmp_path), plane_filter="host")
    assert host.plane == "host" and [o.name for o in host.ops] == ["aten::mm"]
    assert ts.group_of("w4_reduce_kernel") == "w4_matmul"
    with pytest.raises(ValueError, match="plane_filter"):
        ts.summarize_trace(str(tmp_path), plane_filter="tpu")


def test_memory_budget_fields():
    x = torch.ones(256, 256)
    b = mem.memory_budget(lambda a: torch.tanh(a @ a), x)
    assert b.argument_bytes == 256 * 256 * 4 and b.output_bytes == 256 * 256 * 4
    assert b.temp_bytes is None and b.alias_bytes == 0 and b.generated_code_bytes == 0
    assert "total" in str(b) and "not measured" in str(b)
    assert b.total_bytes == 2 * 256 * 256 * 4
    # An output that is a view of an argument aliases it.
    a = mem.memory_budget(lambda t: (t[:16], t @ t), x)
    assert a.alias_bytes == 256 * 256 * 4 and a.output_bytes == 2 * 256 * 256 * 4
