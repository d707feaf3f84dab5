"""Build and bind the hand-written CUDA kernels.

Each source under `quantizedmha_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, loaded
with ctypes (no PyTorch headers: a build takes seconds, not minutes). A
library is built at first use into `quantizedmha_tpu_torch/_build/`, keyed
by a hash of its source, the shared headers (`csrc/*.cuh`) and the flags,
so a fresh checkout builds everything
it needs on the first call. `build_all()` compiles every source at once,
one `nvcc` process each.

Nothing here runs at import time: the CPU tests import every module on a
machine with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_int8_fwd", "paged_decode", "w4_matmul", "flash_fwd", "paged_prefill",
           "flash_bwd")
# No --use_fast_math: its approximate division and expf would break the
# bit-parity of the quantized payloads with the plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


class _Build(NamedTuple):
    name: str
    proc: subprocess.Popen
    tmp: Path
    out: Path


def _start_build(name: str) -> Optional[_Build]:
    """Start nvcc for one source unless its library is already built; the
    library is written under a temporary name and moved into place."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return _Build(name, proc, tmp, out)


def _finish_build(build: _Build) -> str:
    log = build.proc.communicate()[0].decode(errors="replace")
    if build.proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {build.name}.cu:\n{log}")
    build.out.with_suffix(".log").write_text(log)
    os.replace(build.tmp, build.out)
    return log


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel (one nvcc each); returns
    {name: compiler log} (the ptxas register/shared-memory report), empty
    for a library that was already built."""
    builds = {n: _start_build(n) for n in names}
    return {n: _finish_build(b) if b is not None else "" for n, b in builds.items()}


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build = _start_build(name)
        if build is not None:
            _finish_build(build)
        lib = ctypes.CDLL(str(library_path(name)))
        lib.qmha_error_string.argtypes = [ctypes.c_int]
        lib.qmha_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


class CudaKernel:
    """One exported C entry of a kernel library, with its launch count.

    `launches` goes up by one each time the entry launches its kernel and
    returns success; nothing else touches it except `reset`."""

    def __init__(self, library: str, symbol: str, argtypes: List):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self._function()(*args)
        if err != 0:
            msg = load(self.library).qmha_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1

    def reset(self) -> None:
        self.launches = 0


def ptr(t: Optional[torch.Tensor], align: Optional[int] = None) -> Optional[int]:
    """Device pointer of a tensor for a c_void_p argument (None -> NULL).
    The kernels read whole elements (16-byte vectors of the int8 K/V
    payloads, whose callers pass align=16), so the address must be aligned."""
    if t is None:
        return None
    p = t.data_ptr()
    align = align or t.element_size()
    if p % align:
        raise ValueError(f"kernel operand at {p:#x} is not {align}-byte aligned")
    return p


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
