"""Input data manager and binary caches (counterpart of
quantizedmha_tpu/harness/data.py, kept as this package's own copy).

Parity with the reference's host data layer:
  - constant-1.0 or seeded random init (reference inputs/data.cu:9-30);
  - binary save/load of inputs keyed by shape, with metadata validation on
    load (data.cu:54-109);
  - binary cache of golden reference outputs keyed by the problem shape
    (drivers/main.cu:15-19,87-94; utils/verify.cu:106-151).

The draws (numpy's default_rng(seed).normal(0, scale)) and the on-disk
format (raw little-endian `{name}.{f32|i8|i32}.bin` tensors plus a
`meta.json` sidecar, FORMAT_VERSION) are the JAX package's, bit for bit:
a case saved by either package loads in the other, and both CLIs share
one inputs cache. Goldens are keyed by the caller (harness/cli.py tags
this package's).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Dict

import numpy as np

FORMAT_VERSION = 1


@dataclasses.dataclass
class HostData:
    """Host-side Q/K/V in the reference ABI layout: flat [N, d_model] f32."""

    q: np.ndarray
    k: np.ndarray
    v: np.ndarray

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def d_model(self) -> int:
        return self.q.shape[1]


def initialize_host_data(
    n: int,
    d_model: int,
    *,
    random: bool = True,
    seed: int = 42,
    scale: float = 0.5,
) -> HostData:
    """Constant-1.0 or seeded random inputs (data.cu:9-30 semantics).

    The reference's correctness gate used constant inputs, which §4.4 of
    SURVEY.md shows is blind to wrong attention weights (with V≡1 any
    row-stochastic attention gives output≡1) — so `random=True` is the
    default here and constants are opt-in for reference parity.
    """
    if random:
        rng = np.random.default_rng(seed)
        mk = lambda: rng.normal(0.0, scale, (n, d_model)).astype(np.float32)
        return HostData(mk(), mk(), mk())
    ones = np.ones((n, d_model), np.float32)
    return HostData(ones.copy(), ones.copy(), ones.copy())


# ---------------------------------------------------------------------------
# Raw-binary tensor IO ({name}.f32.bin + meta.json, generate_golden.cpp format)
# ---------------------------------------------------------------------------

_DTYPES = {"f32": np.float32, "i8": np.int8, "i32": np.int32}


def write_tensor(path: pathlib.Path, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr.tofile(path)


def read_tensor(path: pathlib.Path, shape, dtype=np.float32) -> np.ndarray:
    arr = np.fromfile(path, dtype=dtype)
    expect = int(np.prod(shape))
    if arr.size != expect:
        raise ValueError(f"{path}: expected {expect} elements, found {arr.size}")
    return arr.reshape(shape)


def save_case(directory, tensors: Dict[str, np.ndarray], meta: dict) -> None:
    """Write a golden case: {name}.{f32|i8|i32}.bin per tensor + meta.json.

    meta.json records shape/dtype per tensor so loads validate against the
    actual problem shape (data.cu:77-96 did this with an embedded header).
    """
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    meta = dict(meta)
    meta["format_version"] = FORMAT_VERSION
    meta["tensors"] = {}
    for name, arr in tensors.items():
        suffix = {np.float32: "f32", np.int8: "i8", np.int32: "i32"}[arr.dtype.type]
        fname = f"{name}.{suffix}.bin"
        write_tensor(directory / fname, arr)
        meta["tensors"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": suffix,
        }
    (directory / "meta.json").write_text(json.dumps(meta, indent=2))


def load_case(directory) -> tuple[Dict[str, np.ndarray], dict]:
    """Load a golden case saved by `save_case` (or the C++ generator)."""
    directory = pathlib.Path(directory)
    meta = json.loads((directory / "meta.json").read_text())
    tensors = {}
    for name, info in meta["tensors"].items():
        tensors[name] = read_tensor(
            directory / info["file"], info["shape"], _DTYPES[info["dtype"]]
        )
    return tensors, meta


# ---------------------------------------------------------------------------
# Shape-keyed caches (main.cu:15-19 `.cache/ref_N%d_d%d.bin` reborn)
# ---------------------------------------------------------------------------


def cached_inputs(
    cache_dir,
    n: int,
    d_model: int,
    *,
    seed: int = 42,
    random: bool = True,
) -> HostData:
    """Random inputs, cached on disk keyed by (N, d_model, seed) — the
    reference cached its profiling-phase random inputs the same way
    (main.cu:110-119, data.cu:54-109)."""
    cache_dir = pathlib.Path(cache_dir)
    tag = "rand" if random else "const"
    case_dir = cache_dir / f"inputs_{tag}_N{n}_d{d_model}_s{seed}"
    if (case_dir / "meta.json").exists():
        try:
            tensors, meta = load_case(case_dir)
            if meta.get("n") == n and meta.get("d_model") == d_model:
                return HostData(tensors["Q"], tensors["K"], tensors["V"])
        except (ValueError, KeyError):
            pass  # stale/corrupt cache: regenerate below
    data = initialize_host_data(n, d_model, random=random, seed=seed)
    save_case(
        case_dir,
        {"Q": data.q, "K": data.k, "V": data.v},
        {"n": n, "d_model": d_model, "seed": seed, "random": random},
    )
    return data


def cached_reference(
    cache_dir,
    key: str,
    shape,
    compute: Callable[[], np.ndarray],
) -> np.ndarray:
    """Golden-output cache (main.cu:87-94: compute CPU reference once, then
    reuse the binary). `key` must encode everything the output depends on."""
    cache_dir = pathlib.Path(cache_dir)
    case_dir = cache_dir / f"ref_{key}"
    if (case_dir / "meta.json").exists():
        try:
            tensors, _ = load_case(case_dir)
            out = tensors["O"]
            if tuple(out.shape) == tuple(shape):
                return out
        except (ValueError, KeyError):
            pass
    out = np.asarray(compute(), np.float32)
    save_case(case_dir, {"O": out}, {"key": key})
    return out
