"""Parameter conversion from the JAX package's layout.

`params_from_numpy` takes a models.llama params tree of the JAX package as
nested dicts of numpy arrays — a QuantizedWeight arriving as
{"values": ..., "scale": ...} and a QuantizedWeight4 as {"packed", "scale",
"group", "packing"} — and returns the port's parameters, leaf for
leaf, so both packages compute the same function from the same numbers.
`params_to_numpy` is its inverse, so that tests hold the port's updated
parameters to JAX's leaf by leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight, QuantizedWeight4


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)  # a writable copy


def params_from_numpy(tree: Any, device="cuda") -> Any:
    dev = resolve_device(device)
    if isinstance(tree, dict):
        if set(tree) == {"values", "scale"}:
            return QuantizedWeight(values=_tensor(tree["values"], dev),
                                   scale=_tensor(tree["scale"], dev))
        if set(tree) == {"packed", "scale", "group", "packing"}:
            return QuantizedWeight4(packed=_tensor(tree["packed"], dev),
                                    scale=_tensor(tree["scale"], dev),
                                    group=int(tree["group"]), packing=str(tree["packing"]))
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # exact through f32
        import ml_dtypes
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(tree: Any) -> Any:
    """The port's parameters as nested dicts of numpy arrays in the JAX
    package's layout (bf16 as ml_dtypes.bfloat16), the inverse of
    params_from_numpy."""
    if isinstance(tree, QuantizedWeight):
        return {"values": _array(tree.values), "scale": _array(tree.scale)}
    if isinstance(tree, QuantizedWeight4):
        return {"packed": _array(tree.packed), "scale": _array(tree.scale),
                "group": tree.group, "packing": tree.packing}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _array(tree)
