"""Model-level serving benchmark: continuous-batching decode throughput
against the device-memory speed of light (counterpart of
quantizedmha_tpu/harness/serving_bench.py).

Decode of a large LM at a small batch is bound by the bytes it reads, so
the score beside tokens/s is the share of the memory speed of light:

    step_bytes  = weight bytes read once per step (layers + lm_head)
                + B * (KV bytes read at the current context + KV written)
    SoL ms/step = step_bytes / HBM bandwidth
    pct_hbm_sol = SoL ms/step / measured ms/step

    python -m quantizedmha_tpu_torch.harness.serving_bench \\
        --weight-bits 4 --lm-head-bits 8 --batch 1 8 32

Weights are Llama-3-8B-shape and random, drawn on the card from a seeded
torch.Generator (its numbers differ from the JAX package's jax.random
draws; decode throughput depends on the byte layout, not on the values).
The bandwidth comes from `hbm_gbps` or from profiling/roofline.py's
CHIP_SPECS by the card's name; an unknown card raises. `--prefill` also
times one 2048-token prefill (`run_prefill_bench`) against the tensor
cores' bf16 speed of light. Not ported: `--async-dispatch` (a TPU
host-overlap trick the engine refuses).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.harness.timing import benchmark
from quantizedmha_tpu_torch.models.llama import LlamaConfig
from quantizedmha_tpu_torch.ops.w4_matmul import check_w4_layout, pack_nibbles
from quantizedmha_tpu_torch.profiling.roofline import (
    ChipSpec,
    attention_flops,
    detect_chip,
    roofline,
)
from quantizedmha_tpu_torch.quant.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    fuse_w4_projections,
    weight_bytes,
)
from quantizedmha_tpu_torch.serving import llama_adapter
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig

_W4_GROUP = 128
# run_prefill_bench's harness.timing.benchmark arguments.
PREFILL_TIMING = dict(warmup=2, runs=8, repeats=3)


def device_init_quant_params(cfg: LlamaConfig, seed: int = 0, bits: int = 8,
                             group: int = _W4_GROUP,
                             lm_head_bits: Optional[int] = None,
                             packing: str = "halves",
                             device="cuda") -> Dict[str, Any]:
    """Random Llama params with int8 (per-channel) or int4 (group-wise)
    layer matmuls, drawn on `device`, in the layout of
    quant.weights.quantize_llama_params. lm_head_bits=8 quantizes the
    output projection per channel too. Values are small uniform integers
    with small scales; each layer is drawn into its stacked tensor in turn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = cfg.num_layers

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device=dev) * 2e-4 + 1e-4

    def stacked(draw, shape, dtype):
        out = torch.empty((L, *shape), dtype=dtype, device=dev)
        for i in range(L):
            out[i] = draw(shape)
        return out

    def packed4(shape):
        return pack_nibbles(ints(shape, -7, 8), ints(shape, -7, 8))

    def qw(in_dim, out_dim):
        if bits == 4:
            check_w4_layout(in_dim, group, packing)
            return QuantizedWeight4(
                packed=stacked(packed4, (in_dim // 2, out_dim), torch.int8),
                scale=stacked(scales, (in_dim // group, out_dim), torch.float32),
                group=group, packing=packing)
        return QuantizedWeight(values=stacked(lambda s: ints(s, -64, 65), (in_dim, out_dim),
                                              torch.int8),
                               scale=stacked(scales, (out_dim,), torch.float32))

    def bf16(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    h, hd, inter = cfg.hidden_size, cfg.hd, cfg.intermediate_size
    layers = dict(
        attn_norm=torch.ones((L, h), dtype=cfg.dtype, device=dev),
        mlp_norm=torch.ones((L, h), dtype=cfg.dtype, device=dev),
        wq=qw(h, cfg.num_heads * hd),
        wk=qw(h, cfg.num_kv_heads * hd),
        wv=qw(h, cfg.num_kv_heads * hd),
        wo=qw(cfg.num_heads * hd, h),
        w_gate=qw(h, inter),
        w_up=qw(h, inter),
        w_down=qw(inter, h),
    )
    if lm_head_bits == 8:
        lm_head = QuantizedWeight(values=ints((h, cfg.vocab_size), -64, 65),
                                  scale=scales((cfg.vocab_size,)))
    else:
        lm_head = bf16((h, cfg.vocab_size))
    return dict(embed=bf16((cfg.vocab_size, h)), layers=layers,
                final_norm=torch.ones((h,), dtype=cfg.dtype, device=dev),
                lm_head=lm_head)


def decode_step_bytes(cfg: LlamaConfig, params: Dict[str, Any],
                      batch: int, ctx: int, page_size: int) -> float:
    """Least device-memory traffic of one batched decode step: every layer
    weight and the lm_head read once; per sequence, the INT8 K/V of `ctx`
    cached positions read at page granularity and one position written.
    The embedding table contributes a B-row gather and is left out."""
    wbytes = (weight_bytes(params["layers"]) + weight_bytes(params["lm_head"])
              + weight_bytes(params["final_norm"]))
    pages = -(-ctx // page_size)
    kv_read = cfg.num_layers * 2 * pages * page_size * cfg.num_kv_heads * cfg.hd
    kv_write = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.hd
    return float(wbytes + batch * (kv_read + kv_write))


def model_matmul_params(cfg: LlamaConfig) -> float:
    """Parameter count of the per-token matmuls (layers + lm_head)."""
    hd = cfg.hd
    per_layer = (cfg.hidden_size * cfg.num_heads * hd
                 + 2 * cfg.hidden_size * cfg.num_kv_heads * hd
                 + cfg.num_heads * hd * cfg.hidden_size
                 + 3 * cfg.hidden_size * cfg.intermediate_size)
    return float(cfg.num_layers * per_layer + cfg.hidden_size * cfg.vocab_size)


def run_decode_bench(cfg: LlamaConfig, params: Dict[str, Any], *,
                     batch: int = 8, prompt_len: int = 512,
                     max_new: int = 64, chunk: int = 16,
                     page_size: int = 128, num_pages: Optional[int] = None,
                     hbm_gbps: Optional[float] = None,
                     device="cuda") -> Dict[str, Any]:
    """Continuous-batching decode tok/s at one batch size.

    All prompts have one length and one budget, so the batch stays full
    for the measured window. The first engine step (B prefills and the
    first fused chunk, first-use costs included) is timed apart; the
    window starts after it, on a host-synced boundary (each fused chunk
    ends in one copy of its tokens to the host). Warm TTFT is one fresh
    request on the drained engine, admission to its first token. Beside
    the JAX package's keys (async_dispatch always False: the engine
    refuses that TPU host-overlap mode), the row carries the device, the
    engine's decode steps over the whole run, the failed requests and the
    token counts the requests returned."""
    dev = resolve_device(device)
    if hbm_gbps is None:
        if dev.type != "cuda":
            raise ValueError("hbm_gbps is required off the GPU")
        hbm_gbps = detect_chip(dev).hbm_gbps
    mpps = -(-(prompt_len + max_new + chunk + 1) // page_size)
    if num_pages is None:
        num_pages = batch * mpps + 2  # + scrap page + slack
    ecfg = EngineConfig(num_pages=num_pages, page_size=page_size, max_batch=batch,
                        prefill_buckets=(prompt_len,), max_new_tokens=max_new,
                        max_pages_per_seq=mpps, decode_chunk=chunk)
    eng = Engine(cfg, params, ecfg, device=dev)
    rng = np.random.default_rng(0)
    for _ in range(batch):
        eng.add_request(rng.integers(1, cfg.vocab_size, prompt_len).tolist(), max_new=max_new)

    t0 = time.perf_counter()
    eng.step()  # admissions (B prefills) + the first fused decode chunk
    t_first = time.perf_counter() - t0

    toks0 = eng.metrics.counter("tokens_generated")
    steps0 = eng.metrics.counter("decode_steps")
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    toks = eng.metrics.counter("tokens_generated") - toks0
    steps = eng.metrics.counter("decode_steps") - steps0

    toks_before = eng.metrics.counter("tokens_generated")
    t1 = time.perf_counter()
    eng.add_request(rng.integers(1, cfg.vocab_size, prompt_len).tolist(), max_new=max_new)
    while eng.metrics.counter("tokens_generated") == toks_before and (eng.queue or eng.active):
        eng.step()
    ttft_warm = time.perf_counter() - t1
    eng.run()  # drain the TTFT request before reporting

    ms_per_step = dt * 1e3 / max(steps, 1)
    # Speed of light at the mean context of the measured window.
    ctx_mid = prompt_len + chunk + (max_new - chunk) // 2
    step_bytes = decode_step_bytes(cfg, params, batch, ctx_mid, page_size)
    sol_ms = step_bytes / (hbm_gbps * 1e9) * 1e3
    return {
        "batch": batch,
        "prompt_len": prompt_len,
        "max_new": max_new,
        "decode_chunk": chunk,
        "async_dispatch": False,
        "decode_toks_per_s": toks / dt,
        "decode_ms_per_step": ms_per_step,
        "decode_ms_per_tok": ms_per_step / batch,
        "hbm_bytes_per_step": step_bytes,
        "hbm_bytes_per_tok": step_bytes / batch,
        "decode_sol_ms_per_step": sol_ms,
        "decode_pct_hbm_sol": 100.0 * sol_ms / ms_per_step,
        "first_step_s": t_first,
        "ttft_warm_s": ttft_warm,
        "measured_tokens": int(toks),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "hbm_gbps": hbm_gbps,
        "decode_steps": int(eng.metrics.counter("decode_steps")),
        "requests_failed": len(eng.failed),
        "tokens_per_request": sorted({len(t) for t in eng.finished.values()}),
    }


def prefill_flops(cfg: LlamaConfig, prompt_len: int) -> float:
    """FLOPs of one prefill: every token through the per-token matmuls,
    and every layer's causal attention, two products over the visible
    pairs (the JAX package's run_prefill_bench adds one layer's)."""
    return (2.0 * model_matmul_params(cfg) * prompt_len
            + cfg.num_layers * attention_flops(1, cfg.num_heads, prompt_len, prompt_len,
                                               cfg.hd, causal=True))


def run_prefill_bench(cfg: LlamaConfig, params: Dict[str, Any], *,
                      prompt_len: int = 2048, chip: Optional[ChipSpec] = None,
                      device="cuda") -> Dict[str, Any]:
    """Prefill TFLOP/s against the tensor cores' bf16 speed of light in
    every weight mode (cfg.weight_quant_mode: w8a16's matmuls run in bf16,
    w8a8's in int8 at up to twice that rate): `prefill_at` over
    `prompt_len` random tokens (numpy seed 0), timed by harness.timing.benchmark
    (PREFILL_TIMING). `chip` gives the peaks off the card. Beside
    the JAX package's keys (unrounded here) the row carries the device
    and the FLOPs counted."""
    dev = resolve_device(device)
    if chip is None:
        if dev.type != "cuda":
            raise ValueError("chip (a ChipSpec) is required off the GPU")
        chip = detect_chip(dev)
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(1, cfg.vocab_size, (1, prompt_len)),
        dtype=torch.int32, device=dev)
    t = benchmark(lambda: llama_adapter.prefill_at(cfg, params, toks, prompt_len - 1),
                  **PREFILL_TIMING)
    flops = prefill_flops(cfg, prompt_len)
    rl = roofline(t.median_s, flops, 0, dtype="bf16", chip=chip)
    return {
        "prefill_len": prompt_len,
        "prefill_ms": t.median_ms,
        "prefill_tflops": rl.tflops_achieved,
        "prefill_pct_mxu_sol": rl.pct_of_compute_sol,
        "prefill_flops": flops,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def model_name(weight_bits: int, lm_head_bits: Optional[int]) -> str:
    name = f"llama3-8b-shape-int{weight_bits}"
    return name + (f"-lmh{lm_head_bits}" if lm_head_bits else "")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--prefill", action="store_true",
                    help="also measure prefill TFLOP/s at 2048 tokens")
    ap.add_argument("--layers", type=int, default=None,
                    help="override num_layers (scaled-down debugging)")
    ap.add_argument("--weight-bits", type=int, choices=(4, 8), default=8,
                    help="layer-matmul weights: 8 per-channel w8a16, 4 group-128 w4a16")
    ap.add_argument("--lm-head-bits", type=int, choices=(8,), default=None,
                    help="quantize the output projection to int8 per channel (off: bf16)")
    ap.add_argument("--packing", choices=("halves", "pairs"), default="halves",
                    help="int4 nibble layout")
    ap.add_argument("--no-fuse-proj", action="store_true",
                    help="keep wq/wk/wv and w_gate/w_up as separate matmuls")
    ap.add_argument("--hbm-gbps", type=float, default=None,
                    help="device-memory bandwidth (default: CHIP_SPECS by card name)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), attention_impl="flash_int8")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    t0 = time.perf_counter()
    params = device_init_quant_params(cfg, seed=0, bits=args.weight_bits,
                                      lm_head_bits=args.lm_head_bits, packing=args.packing)
    if args.weight_bits == 4 and not args.no_fuse_proj:
        params = dict(params, layers=fuse_w4_projections(params["layers"]))
    gib = weight_bytes(params) / 2**30
    if not args.json:
        print(f"params on device: {gib:.2f} GiB in {time.perf_counter() - t0:.1f}s", flush=True)
    out = {"model": model_name(args.weight_bits, args.lm_head_bits), "params_gib": gib,
           "device": torch.cuda.get_device_name(0), "sweep": []}
    for b in args.batch:
        row = run_decode_bench(cfg, params, batch=b, prompt_len=args.prompt_len,
                               max_new=args.max_new, chunk=args.chunk,
                               hbm_gbps=args.hbm_gbps)
        out["sweep"].append(row)
        if not args.json:
            print(json.dumps(row), flush=True)
    if args.prefill:
        out["prefill"] = run_prefill_bench(cfg, params)
        if not args.json:
            print(json.dumps(out["prefill"]), flush=True)
    if args.json:
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
