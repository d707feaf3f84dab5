"""PyTorch port vs JAX package: the harness's data layer (draws, on-disk
cases, shared input caches) and the check-then-profile CLI on the CPU.

Tolerances: drawn inputs and cached tensors must be bit-identical; the
CLI's goldens (the port's plain f32 reference and the JAX reference at
highest matmul precision) must agree within 1e-5; each rung's check in the
port's report uses the CLI's own tolerances, as the JAX report's does."""

import json

import numpy as np
import pytest
import torch

from quantizedmha_tpu.harness import cli as jcli
from quantizedmha_tpu.harness import data as jdata
from quantizedmha_tpu_torch.harness import cli as tcli
from quantizedmha_tpu_torch.harness import data as tdata

KERNELS = ["unfused", "fa", "fa_bf16", "fa_int8", "reference"]
RESULT_KEYS = {"kernel", "ms", "tflops", "pct_mxu_sol", "pct_hbm_sol", "check", "error",
               "skipped"}


@pytest.mark.parametrize("n,d_model,seed,random", [(8, 16, 7, True), (128, 128, 42, True),
                                                   (5, 3, 0, True), (8, 16, 42, False)])
def test_inputs_bit_identical_to_jax(n, d_model, seed, random):
    t = tdata.initialize_host_data(n, d_model, seed=seed, random=random)
    j = jdata.initialize_host_data(n, d_model, seed=seed, random=random)
    for name in ("q", "k", "v"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    assert (t.n, t.d_model) == (j.n, j.d_model) == (n, d_model)


@pytest.mark.parametrize("writer,reader", [(jdata, tdata), (tdata, jdata)])
def test_case_saved_by_one_package_loads_in_the_other(tmp_path, writer, reader):
    assert tdata.FORMAT_VERSION == jdata.FORMAT_VERSION
    tensors = {"Q": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
               "QI": np.arange(-6, 6, dtype=np.int8).reshape(3, 4),
               "S": np.arange(6, dtype=np.int32).reshape(2, 3) * 1000}
    writer.save_case(tmp_path / "case", tensors, {"n": 3})
    loaded, meta = reader.load_case(tmp_path / "case")
    assert meta["n"] == 3 and meta["format_version"] == 1
    for name, arr in tensors.items():
        assert loaded[name].dtype == arr.dtype and loaded[name].tobytes() == arr.tobytes()
    # The shape-keyed inputs cache is shared: what one writes the other reads.
    a = writer.cached_inputs(tmp_path / "cache", 8, 16, seed=3)
    b = reader.cached_inputs(tmp_path / "cache", 8, 16, seed=3)
    assert a.q.tobytes() == b.q.tobytes() and a.v.tobytes() == b.v.tobytes()
    assert len(list((tmp_path / "cache").glob("inputs_*"))) == 1
    with pytest.raises(ValueError, match="expected 6"):
        np.zeros(5, np.float32).tofile(tmp_path / "x.f32.bin")
        reader.read_tensor(tmp_path / "x.f32.bin", (2, 3))


def test_cached_reference_computes_once(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return np.full((4, 4), 2.0, np.float32)

    a = tdata.cached_reference(tmp_path, "k1", (4, 4), compute)
    b = tdata.cached_reference(tmp_path, "k1", (4, 4), compute)
    assert len(calls) == 1 and a.tobytes() == b.tobytes()


def _argv(tmp_path, *extra):
    """JAX's TestCli shape and run lengths."""
    return ["--n", "128", "--d-model", "128", "--heads", "2",
            "--warmup", "1", "--runs", "2", "--repeats", "1",
            "--cache-dir", str(tmp_path / "cache"), *extra]


def _port(tmp_path, *extra):
    return tcli.run(_argv(tmp_path, *extra, "--device", "cpu"))


@pytest.fixture(scope="module")
def jax_all(tmp_path_factory):
    """The JAX CLI's `--kernel all` report and its cache directory."""
    tmp = tmp_path_factory.mktemp("jax_cli")
    report = tmp / "jax.json"
    assert jcli.run(_argv(tmp, "--kernel", "all", "--json", str(report))) == 0
    return json.loads(report.read_text()), tmp


def test_all_kernels_report_matches_jax(jax_all, tmp_path):
    """The port's `--kernel all` on the JAX CLI's cache: the same inputs,
    its own golden (within 1e-5 of JAX's), the same report keys, and every
    rung checked and timed as in the JAX report."""
    jreport, jtmp = jax_all
    cache = jtmp / "cache"
    report = tmp_path / "port.json"
    rc = tcli.run(_argv(jtmp, "--kernel", "all", "--json", str(report), "--device", "cpu"))
    assert rc == 0
    payload = json.loads(report.read_text())
    assert set(payload) == set(jreport)
    assert payload["workload"] == jreport["workload"] and payload["device"] == "cpu"
    assert [r["kernel"] for r in payload["results"]] == KERNELS
    for got, want in zip(payload["results"], jreport["results"]):
        assert set(got) == set(want) == RESULT_KEYS
        assert got["kernel"] == want["kernel"]
        assert got["error"] is None and want["error"] is None
        assert set(got["check"]) == set(want["check"])
        assert got["check"]["n_mismatch"] == want["check"]["n_mismatch"] == 0
        assert got["check"]["n_nonfinite"] == 0
        assert (got["check"]["abs_tol"], got["check"]["rel_tol"]) == (
            want["check"]["abs_tol"], want["check"]["rel_tol"])
        assert got["ms"] > 0 and want["ms"] > 0
        # No roofline off the card: the CPU has no tensor cores.
        assert got["tflops"] is got["pct_mxu_sol"] is got["pct_hbm_sol"] is None
    goldens = sorted(p.name for p in cache.glob("ref_*"))
    assert len(goldens) == 2, goldens
    jkey = [g for g in goldens if not g.endswith("_torch")]
    assert len(jkey) == 1 and jkey[0] + "_torch" in goldens
    jgold, _ = jdata.load_case(cache / jkey[0])
    tgold, _ = tdata.load_case(cache / (jkey[0] + "_torch"))
    np.testing.assert_allclose(tgold["O"], jgold["O"], rtol=1e-5, atol=1e-5)
    assert len(list(cache.glob("inputs_*"))) == 1


def test_port_never_reads_a_jax_golden(tmp_path, capsys):
    """A golden under the JAX CLI's key (here a wrong one) is not the
    port's: the port computes and caches its own and passes."""
    assert jcli.run(_argv(tmp_path, "--kernel", "fa", "--no-check")) == 0
    args = tcli.build_parser().parse_args(_argv(tmp_path))
    key = tcli.golden_key(args)
    assert key.endswith("_torch")
    jkey = key[: -len("_torch")]
    tdata.save_case(tmp_path / "cache" / f"ref_{jkey}",
                    {"O": np.full((128, 128), 7.0, np.float32)}, {"key": jkey})
    assert _port(tmp_path, "--kernel", "fa") == 0
    assert "check [PASS]" in capsys.readouterr().out
    assert (tmp_path / "cache" / f"ref_{key}" / "meta.json").exists()


def test_single_kernel_check_and_time(tmp_path, capsys):
    rc = _port(tmp_path, "--kernel", "fa")
    out = capsys.readouterr().out
    assert rc == 0
    assert "check [PASS]" in out and "ms" in out


def test_no_check_skips_golden(tmp_path, capsys):
    rc = _port(tmp_path, "--kernel", "fa", "--no-check")
    out = capsys.readouterr().out
    assert rc == 0
    assert "check" not in out
    assert not list((tmp_path / "cache").glob("ref_*"))


def test_constant_inputs_reference_parity(tmp_path):
    report = tmp_path / "r.json"
    rc = _port(tmp_path, "--kernel", "fa", "--constant", "--json", str(report))
    assert rc == 0
    tensors, _ = tdata.load_case(next((tmp_path / "cache").glob("inputs_const_*")))
    np.testing.assert_array_equal(tensors["V"], 1.0)
    # With V == 1 every row of the output is exactly ones.
    assert json.loads(report.read_text())["results"][0]["check"]["max_abs"] == 0.0


@pytest.mark.parametrize("extra", [("--causal", "--rope"),
                                   ("--causal", "--window", "16", "--sinks", "2"),
                                   ("--softcap", "30.0")])
def test_masked_and_rope_goldens(tmp_path, extra):
    report = tmp_path / "r.json"
    rc = _port(tmp_path, "--kernel", "all", "--json", str(report), *extra)
    assert rc == 0
    results = {r["kernel"]: r for r in json.loads(report.read_text())["results"]}
    if "--window" in extra or "--softcap" in extra:
        assert results["unfused"]["skipped"] and results["unfused"]["ms"] is None
    for name, r in results.items():
        if not r["skipped"]:
            assert r["check"]["n_mismatch"] == 0 and r["ms"] > 0, name


@pytest.mark.parametrize("argv", [("--kernel", "nope"), ("--kernel", "fa", "--window", "8"),
                                  ("--kernel", "fa", "--causal", "--sinks", "2")])
def test_bad_arguments_rejected(tmp_path, argv):
    assert _port(tmp_path, *argv) == 2


def test_failed_check_is_not_timed_and_exits_1(tmp_path):
    report = tmp_path / "r.json"
    rc = _port(tmp_path, "--kernel", "all", "--int8-tol", "1e-9", "--json", str(report))
    assert rc == 1
    results = {r["kernel"]: r for r in json.loads(report.read_text())["results"]}
    assert results["fa_int8"]["check"]["n_mismatch"] > 0
    assert results["fa_int8"]["ms"] is None
    assert all(results[k]["ms"] > 0 for k in ("unfused", "fa", "fa_bf16", "reference"))


def test_rung_error_is_reported_and_exits_1(tmp_path, monkeypatch):
    from quantizedmha_tpu_torch import api

    real = api.solve

    def solve(*a, kernel, **kw):
        if kernel == "fa_bf16":
            raise RuntimeError("boom")
        return real(*a, kernel=kernel, **kw)

    monkeypatch.setattr(api, "solve", solve)
    report = tmp_path / "r.json"
    assert _port(tmp_path, "--kernel", "all", "--json", str(report)) == 1
    results = {r["kernel"]: r for r in json.loads(report.read_text())["results"]}
    assert results["fa_bf16"]["error"] == "RuntimeError: boom"
    assert results["fa_bf16"]["ms"] is None and results["fa"]["ms"] > 0


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.run(_argv(tmp_path, "--kernel", "fa"))
    assert tcli.build_parser().parse_args([]).device == "cuda"
