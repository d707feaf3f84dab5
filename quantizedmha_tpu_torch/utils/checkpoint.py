"""Checkpoint / resume (counterpart of quantizedmha_tpu/utils/checkpoint.py).

Step-numbered checkpoints of a tree of tensors (nested dicts and lists:
model parameters, optimizer state) under one directory, with resume,
retention and a sharded restore onto a mesh, in the JAX package's npz
layout:

    <dir>/step_<n>/leaves.npz   the leaves as arr_0, arr_1, ... in path order
    <dir>/step_<n>/tree.json    {"paths": [...]}: each leaf's key path
    <dir>/step_<n>/meta.json    {"step": n, "backend": "npz"}
    <dir>/step_<n>/.incomplete  present until the write is complete

Key paths are the JAX package's `_flatten_with_paths` strings ("layers/wq",
a list's entries by index), in its order (a dict's keys sorted), so a
checkpoint written by either package restores in the other. bfloat16
leaves are stored as the JAX package's numpy stores them, 2-byte void
(`|V2`) holding the raw bits, and read back by reinterpreting them. (The
JAX package's own restore cannot cast such a leaf, so a bf16 checkpoint
crosses from the JAX package to this one only.) Only the npz backend is
here: a checkpoint whose meta.json names orbax raises, as the JAX package
does when orbax is missing.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import struct
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_V2 = np.dtype("V2")


def _flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) in the JAX package's order: a dict's keys sorted, a
    list's or tuple's entries in order, None an empty subtree."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return [], []
    else:
        return ["/".join(prefix)], [tree]
    paths, leaves = [], []
    for k, v in items:
        p, l = _flatten_with_paths(v, prefix + (k,))
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """`leaves` put into the structure of `like` (in _flatten_with_paths's
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)
    return build(like)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2)
        return t.numpy()
    return np.asarray(leaf)


def _shape_dtype(like_leaf: Any):
    if isinstance(like_leaf, torch.Tensor):
        return tuple(like_leaf.shape), like_leaf.dtype
    a = np.asarray(like_leaf)
    return a.shape, a.dtype


def _device_of(like_leaf: torch.Tensor, device):
    """`device`, else the template leaf's (the CPU for a meta template)."""
    if device is not None:
        return device
    return "cpu" if like_leaf.device.type == "meta" else like_leaf.device


def _from_numpy(arr: np.ndarray, like_leaf: Any, device, copy: bool = True) -> Any:
    """arr cast to the template leaf's dtype: a tensor on `device` (else the
    template's own; a meta template gives the CPU) for a tensor template,
    else a numpy array. copy=False may return a tensor over arr's memory."""
    if isinstance(like_leaf, torch.Tensor):
        if arr.dtype == _V2:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=_device_of(like_leaf, device), dtype=like_leaf.dtype, copy=copy)
    return np.array(arr, dtype=np.asarray(like_leaf).dtype)


def _npz_arrays(path: pathlib.Path) -> Dict[str, np.ndarray]:
    """name -> array of an npz file. np.savez stores its members
    uncompressed: each large one is mapped from the file copy-on-write (read
    only where used, as a shard's rows are; nothing written back), at
    page-cache speed, where np.load would copy it through the zip reader in
    small chunks. Compressed and small members are read by np.load."""
    out: Dict[str, np.ndarray] = {}
    data = np.load(path)
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    with open(path, "rb") as f:
        for info in infos:
            name = info.filename[:-len(".npy")]
            if info.compress_type != zipfile.ZIP_STORED or info.file_size < 2**20:
                out[name] = data[name]
                continue
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            out[name] = np.memmap(path, dtype=dtype, mode="c", offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def _save_npz(path: pathlib.Path, tree: Any) -> None:
    paths, leaves = _flatten_with_paths(tree)
    np.savez(path / "leaves.npz", **{f"arr_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
    (path / "tree.json").write_text(json.dumps({"paths": paths}))


def _load_npz(path: pathlib.Path, like: Any, device=None, copy: bool = True) -> Any:
    data = _npz_arrays(path / "leaves.npz")
    n = len(data)
    like_paths, like_leaves = _flatten_with_paths(like)
    if len(like_leaves) != n:
        raise ValueError(f"checkpoint has {n} leaves, template has {len(like_leaves)}")
    tree_meta = path / "tree.json"
    if tree_meta.exists():
        saved_paths = json.loads(tree_meta.read_text())["paths"]
        if saved_paths != like_paths:
            bad = next((a, b) for a, b in zip(saved_paths, like_paths) if a != b) \
                if len(saved_paths) == len(like_paths) else (None, None)
            raise ValueError(
                f"checkpoint tree does not match template: first differing "
                f"path {bad[0]!r} (saved) vs {bad[1]!r} (template)")
    out = []
    for i, like_leaf in enumerate(like_leaves):
        leaf = data[f"arr_{i}"]
        want_shape, _ = _shape_dtype(like_leaf)
        if leaf.shape != want_shape:
            raise ValueError(f"checkpoint leaf {i} has shape {leaf.shape}, template "
                             f"expects {want_shape}")
        out.append(_from_numpy(leaf, like_leaf, device, copy))
        del leaf
    return _unflatten(like, out)


class CheckpointManager:
    """Step-numbered checkpoints under one directory.

    save(step, tree)  -> writes <dir>/step_<n>/
    restore(like, step=None) -> latest (or given) step restored into the
                                structure, shapes and dtypes of `like`
    restore_sharded(like, shardings, mesh) -> this rank's shard of it
    """

    def __init__(self, directory, *, keep: int = 3, backend: Optional[str] = None):
        if backend not in (None, "npz"):
            raise ValueError(f"backend {backend!r}: only 'npz' is available here")
        self.dir = pathlib.Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.backend = "npz"

    # -- inventory -----------------------------------------------------------

    def steps(self) -> list:
        out = []
        for child in self.dir.iterdir():
            m = _STEP_RE.match(child.name)
            if m and not (child / ".incomplete").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save / restore --------------------------------------------------------

    def save(self, step: int, tree: Any) -> pathlib.Path:
        path = self.dir / f"step_{step}"
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        # Removed only after a complete write, so a half-written checkpoint
        # is never offered for resume.
        marker = path / ".incomplete"
        marker.touch()
        _save_npz(path, tree)
        (path / "meta.json").write_text(json.dumps({"step": step, "backend": self.backend}))
        marker.unlink()
        self._gc()
        return path

    def restore(self, like: Any, step: Optional[int] = None, *, device=None) -> Any:
        """The checkpoint at `step` (the latest when None) in the structure
        of `like`: each leaf checked against the template leaf's shape and
        cast to its dtype; tensors on `device`, else on the template leaf's
        device (a meta template, which allocates nothing, gives the CPU)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return _load_npz(self._path(step), like, device)

    def _path(self, step: int) -> pathlib.Path:
        """A step's directory, checked to hold an npz checkpoint."""
        path = self.dir / f"step_{step}"
        meta = json.loads((path / "meta.json").read_text())
        if meta["backend"] == "orbax":
            raise RuntimeError("checkpoint written by orbax but orbax missing")
        return path

    def restore_sharded(self, like: Any, shardings: Any, mesh, step: Optional[int] = None, *,
                        axis: str = "tp", device=None) -> Any:
        """This rank's shard of the checkpoint, for resuming onto a mesh: the
        tree restored (restore) and cut by its PartitionSpecs along `axis`
        at this rank's index on `mesh` (serving.sharded.shard_params, the
        JAX package's device_put of each leaf with its sharding). `like`
        describes the whole checkpoint (meta tensors allocate nothing)."""
        from quantizedmha_tpu_torch.serving.sharded import shard_params
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        # The leaves over the file's pages: only each shard's rows are read.
        host = _load_npz(self._path(step), like, "cpu", copy=False)
        shards = shard_params(host, shardings, mesh, axis)
        del host
        moved = [x.to(_device_of(t, device), copy=True) if isinstance(t, torch.Tensor) else x
                 for x, t in zip(_flatten_with_paths(shards)[1], _flatten_with_paths(like)[1])]
        return _unflatten(like, moved)

    # -- retention -------------------------------------------------------------

    def _gc(self) -> None:
        steps = self.steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{old}", ignore_errors=True)
