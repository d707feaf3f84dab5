"""The port's safetensors reader and writer (utils/safetensors_io.py)
against the `safetensors` package: the port's files read by safe_open and
the package's files read by the port, bit for bit, for every dtype the
port supports (F32, F16, BF16, I8, U8, I32, I64), with metadata, empty and
0-d tensors, and headers of every length mod 8 (the package pads; a
hand-made file need not, which puts the data at odd offsets). Tensors read
are views of one map (a slice copies nothing); other dtypes are refused by
name, reading and writing."""

import json
import struct

import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save

from quantizedmha_tpu_torch.utils import safetensors_io as sio

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.uint8, torch.int32,
          torch.int64]


def _tensors(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((3, 5, 7), generator=g) * 100
    t = x.to(dtype) if dtype.is_floating_point else x.to(torch.int64).to(dtype)
    return {"w": t, "w.narrow": t[1], "0d": t[0, 0, 0].clone(), "empty": t[:0]}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_port_writes_what_safetensors_reads(tmp_path, dtype):
    ts = _tensors(dtype, 0)
    sio.save_file(ts, tmp_path / "a.safetensors", metadata={"format": "pt", "k": "v"})
    (n,) = struct.unpack("<Q", (tmp_path / "a.safetensors").read_bytes()[:8])
    assert n % 8 == 0
    with safe_open(tmp_path / "a.safetensors", framework="pt") as f:
        assert f.metadata() == {"format": "pt", "k": "v"} and set(f.keys()) == set(ts)
        for k, t in ts.items():
            got = f.get_tensor(k)
            assert got.dtype == dtype and torch.equal(got, t), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_port_reads_what_safetensors_writes(tmp_path, dtype):
    ts = {k: v.clone() for k, v in _tensors(dtype, 1).items()}  # (it refuses shared storage)
    st_save(ts, tmp_path / "b.safetensors", metadata={"m": "1"})
    f = sio.SafetensorsFile(tmp_path / "b.safetensors")
    assert f.metadata == {"m": "1"} and set(f.keys()) == set(ts)
    for k, t in ts.items():
        got = f.get(k)
        assert got.dtype == dtype and got.shape == t.shape and torch.equal(got, t), k


@pytest.mark.parametrize("pad", range(8))
def test_header_of_any_length(tmp_path, pad):
    """An unpadded header of every length mod 8: the data lands at odd
    offsets, which the reader copies before viewing."""
    ts = {"a" * (1 + pad): torch.arange(6, dtype=torch.int64).reshape(2, 3),
          "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    header, offset, blobs = {}, 0, []
    for name, t in ts.items():
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": sio._NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    text = json.dumps(header).encode()
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(text)) + text + b"".join(blobs))
    f = sio.SafetensorsFile(path)
    for name, t in ts.items():
        assert torch.equal(f.get(name), t)
    sio.save_file(ts, tmp_path / "even.safetensors")  # the port's writer pads
    with safe_open(tmp_path / "even.safetensors", framework="pt") as g:
        for name, t in ts.items():
            assert torch.equal(g.get_tensor(name), t)


def test_reads_are_views_of_one_map(tmp_path):
    t = torch.randn(64, 32)
    sio.save_file({"w": t}, tmp_path / "w.safetensors")
    f = sio.SafetensorsFile(tmp_path / "w.safetensors")
    a, b = f.get("w"), f.get("w")
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    rows = a.narrow(0, 16, 16)
    assert rows.untyped_storage().data_ptr() == a.untyped_storage().data_ptr()
    assert torch.equal(rows, t[16:32])
    a[0, 0] = 1e9  # copy-on-write: the file keeps its bytes
    assert torch.equal(sio.SafetensorsFile(tmp_path / "w.safetensors").get("w"), t)


def test_other_dtypes_refused_by_name(tmp_path):
    st_save({"x": torch.zeros(2, dtype=torch.float64)}, tmp_path / "f64.safetensors")
    with pytest.raises(ValueError, match="'F64'"):
        sio.SafetensorsFile(tmp_path / "f64.safetensors")
    with pytest.raises(ValueError, match="float64"):
        sio.save_file({"x": torch.zeros(2, dtype=torch.float64)}, tmp_path / "y.safetensors")
    with pytest.raises(ValueError, match="strings"):
        sio.save_file({"x": torch.zeros(2)}, tmp_path / "z.safetensors", metadata={"n": 1})
