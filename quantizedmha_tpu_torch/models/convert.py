"""Parameter conversion from the JAX package's layout.

`params_from_numpy` takes a models.llama params tree of the JAX package as
nested dicts of numpy arrays — a QuantizedWeight arriving as
{"values": ..., "scale": ...} — and returns the port's parameters, leaf for
leaf, so both packages compute the same function from the same numbers.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight


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
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)
