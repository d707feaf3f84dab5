"""How far w8a8's logits move with depth on the H100 (a diagnostic).

    python -m quantizedmha_tpu_torch.harness.w8a8_depth [--layers 1 2 4 8 16 32]

Llama-3-8B's random INT8 weights (the serve phase's: seed 0,
quantize_llama_params bits=8), cut to the first L layers, one 256-token
prompt (numpy seed 0, the third of chip_smoke.py serve's prompts); for each
L the last-token logits' distances (max |a - b| / std(b), and the RMS over
std): the flash_int8 model against the reference-attention model in w8a8
and in w8a16, the reference model in w8a8 against w8a16, and each mode's
reference model against itself with the embeddings scaled by 1 + 2^-7 (a
small nudge of the input). One JSON line a depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from quantizedmha_tpu_torch.models import llama
from quantizedmha_tpu_torch.quant.weights import QuantizedWeight, quantize_llama_params


def _distance(a: torch.Tensor, b: torch.Tensor) -> dict:
    return {"max_over_std": ((a - b).abs().max() / b.std()).item(),
            "rms_over_std": ((a - b).pow(2).mean().sqrt() / b.std()).item()}


def _first_layers(params, n):
    layers = {k: (QuantizedWeight(v.values[:n], v.scale[:n]) if isinstance(v, QuantizedWeight)
                  else v[:n]) for k, v in params["layers"].items()}
    return dict(params, layers=layers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 8, 16, 32])
    args = ap.parse_args(argv)
    base = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_llama_params(llama.init_params(base, gen, device="cuda"), bits=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, base.vocab_size, 256).tolist() for _ in range(3)]
    toks = torch.tensor([prompts[2]], dtype=torch.int32, device="cuda")
    for n in args.layers:
        p = _first_layers(params, n)
        nudged = dict(p, embed=(p["embed"].float() * (1 + 2**-7)).to(p["embed"].dtype))
        out = {}
        for mode in ("w8a16", "w8a8"):
            for impl in ("flash_int8", "reference"):
                cfg = dataclasses.replace(base, num_layers=n, weight_quant_mode=mode,
                                          attention_impl=impl)
                out[mode, impl] = llama.forward(cfg, p, toks)[0, -1]
            cfg = dataclasses.replace(base, num_layers=n, weight_quant_mode=mode,
                                      attention_impl="reference")
            out[mode, "nudged"] = llama.forward(cfg, nudged, toks)[0, -1]
        print(json.dumps({
            "layers": n, "gpu": torch.cuda.get_device_name(0),
            "w8a8 flash_int8 vs reference": _distance(out["w8a8", "flash_int8"],
                                                      out["w8a8", "reference"]),
            "w8a16 flash_int8 vs reference": _distance(out["w8a16", "flash_int8"],
                                                       out["w8a16", "reference"]),
            "reference w8a8 vs w8a16": _distance(out["w8a8", "reference"],
                                                 out["w8a16", "reference"]),
            "w8a8 reference nudged": _distance(out["w8a8", "nudged"], out["w8a8", "reference"]),
            "w8a16 reference nudged": _distance(out["w8a16", "nudged"],
                                                out["w8a16", "reference"])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
