"""The safetensors file format, read and written with torch alone.

The JAX package reads and writes checkpoints through the `safetensors`
package (and bf16 through ml_dtypes, which JAX loads); the port depends on
neither. A file is an 8-byte little-endian header length, a JSON header
({name: {"dtype", "shape", "data_offsets": [begin, end]}}, optionally
"__metadata__": {str: str}), padded with spaces to a multiple of 8 bytes,
then the data buffer, each tensor's bytes little-endian and row-major at
its offsets from the buffer's start.

`SafetensorsFile` maps a file (copy-on-write, so the tensors are writable
and nothing is copied until written) and returns each tensor as a CPU
tensor viewing the map: a rank that keeps a slice of it (`narrow`) reads
only those bytes. `save_file` writes a file that `safetensors.safe_open`
reads back.
"""

from __future__ import annotations

import json
import mmap
import pathlib
import struct
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # the format's own limit on the header


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported safetensors dtype {name!r} (supported: "
                         f"{', '.join(DTYPES)})")
    return DTYPES[name]


class SafetensorsFile:
    """One safetensors file, mapped: `keys()`, `metadata`, `get(name)`."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{self.path}: header of {n} bytes exceeds the format's limit")
            header = json.loads(f.read(n))
            size = self.path.stat().st_size
            self._start = 8 + n
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                         if size > self._start else None)
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__", None)
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, e in header.items():
            dt = _dtype(e["dtype"])
            shape = tuple(int(x) for x in e["shape"])
            begin, end = (int(x) for x in e["data_offsets"])
            nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(dt)
            if end - begin != nbytes or begin < 0 or self._start + end > size:
                raise ValueError(f"{self.path}: tensor {name!r} has offsets {begin}-{end} for "
                                 f"{nbytes} bytes in a file of {size}")
            self._entries[name] = (dt, shape, begin, end)
        self._buffer = (torch.frombuffer(self._map, dtype=torch.uint8)
                        if self._map is not None else None)

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        """The tensor as a CPU tensor viewing the map (a copy only where
        its offset is not a multiple of its element size)."""
        dt, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dt)
        raw = self._buffer[self._start + begin:self._start + end]
        if (self._start + begin) % _itemsize(dt):
            raw = raw.clone()
        return raw.view(dt).reshape(shape)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def save_file(tensors: Mapping[str, object], path,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` ({name: torch tensor or numpy array}) to `path`, in
    the order of their names, with `metadata` as the header's
    "__metadata__" (strings only)."""
    items = [(name, _as_tensor(tensors[name])) for name in sorted(tensors)]
    header: Dict[str, object] = {}
    if metadata is not None:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise ValueError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {t.dtype} for tensor {name!r} (supported: "
                             f"{', '.join(DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, t in items:
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())

