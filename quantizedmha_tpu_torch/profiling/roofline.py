"""Roofline / speed-of-light reporting (counterpart of
quantizedmha_tpu/profiling/roofline.py).

Attention FLOPs and bytes from shapes, and a measured time's share of the
card's speed of light: the tensor cores' peak for the work's dtype and the
HBM bandwidth. The peaks are one table by `torch.cuda.get_device_name()`,
which `chip_smoke.py`'s bounds and the serving benchmark read as well; an
unknown card raises rather than borrowing another card's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device

# Dense peaks of one card by name (NVIDIA data sheet, SXM part, at its full
# 700 W power limit): bf16 tensor-core TFLOP/s, int8 tensor-core TOP/s, HBM
# GB/s, float32 TFLOP/s on the CUDA cores (outside the tensor cores), and
# exponentials a second on the SFUs (132 SMs x 16 a clock x 1.98 GHz boost).
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": (989.0, 1979.0, 3350.0, 67.0, 132 * 16 * 1.98e9),
}


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float
    int8_tops: float
    hbm_gbps: float
    cuda_core_tflops: Optional[float] = None  # float32 outside the tensor cores
    exp_per_s: Optional[float] = None         # SFU exponentials a second

    def peak_for(self, dtype: str) -> float:
        if dtype in ("int8",):
            return self.int8_tops
        if dtype in ("bf16", "bfloat16", "fp16"):
            return self.bf16_tflops
        # float32 to f32 accuracy on the tensor cores takes at least three
        # 16-bit products a product (hi*hi + hi*lo + lo*hi of a two-piece
        # split, fp16 or bf16 pieces); the f32 flash kernel runs six bf16
        # ones. So the fastest f32-accurate route is bf16 / 3, which is
        # above the CUDA cores' float32 rate (cuda_core_tflops): a share
        # against it can never exceed 100% whatever kernel does the work.
        return self.bf16_tflops / 3.0


def chip_spec(name: str) -> ChipSpec:
    """The ChipSpec of a card by its `torch.cuda.get_device_name()`."""
    if name not in CHIP_SPECS:
        raise ValueError(f"no peaks known for {name!r}: add it to CHIP_SPECS "
                         "or pass a ChipSpec")
    return ChipSpec(name, *CHIP_SPECS[name])


def detect_chip(device="cuda") -> ChipSpec:
    """The ChipSpec of a CUDA device; raises without a card or for a card
    not in CHIP_SPECS."""
    return chip_spec(torch.cuda.get_device_name(resolve_device(device)))


def visible_pairs(batch: int, heads: int, q_len: int, kv_len: int,
                  causal: bool = False, window=None, sinks: int = 0) -> float:
    """Number of VISIBLE (q, kv) score elements: full, causal
    (end-aligned), and causal sliding-window (+ attention sinks) masks.
    The common denominator of the FLOP count and the softmax model."""
    if not causal:
        return batch * heads * float(q_len) * kv_len
    qpos = np.arange(q_len, dtype=np.int64) + (kv_len - q_len)  # end-aligned
    visible = np.minimum(qpos + 1, kv_len)
    if window is not None:
        # last `window` positions, plus any sink cols [0, sinks) that fall
        # strictly before the window start (qpos + 1 - window).
        in_win = np.minimum(qpos + 1, window) + np.clip(
            np.minimum(sinks, qpos + 1 - window), 0, None)
        visible = np.minimum(visible, in_win)
    return batch * heads * float(visible.sum())


def attention_flops(batch: int, heads: int, q_len: int, kv_len: int,
                    head_dim: int, causal: bool = False,
                    window=None, sinks: int = 0) -> float:
    """FLOPs of the two attention matmuls (QK^T and PV), 2*N*M*d each,
    counting only visible (q, kv) pairs."""
    per_pair = 2.0 * 2.0 * head_dim  # two matmuls, 2 FLOPs/MAC each
    return visible_pairs(batch, heads, q_len, kv_len, causal, window,
                         sinks) * per_pair


def attention_bytes(batch: int, heads: int, q_len: int, kv_len: int,
                    head_dim: int, bytes_per_el: int = 4, *,
                    q_bytes: Optional[int] = None,
                    kv_bytes: Optional[int] = None,
                    o_bytes: Optional[int] = None) -> float:
    """Minimum HBM traffic of fused attention: read Q,K,V + write O once.
    Per-tensor byte widths matter for mixed-precision kernels: fa_int8
    reads fp32 Q and writes fp32 O around its int8 K/V."""
    qb = q_bytes if q_bytes is not None else bytes_per_el
    kb = kv_bytes if kv_bytes is not None else bytes_per_el
    ob = o_bytes if o_bytes is not None else bytes_per_el
    return float(
        batch * heads * (q_len * qb + 2 * kv_len * kb + q_len * ob) * head_dim
    )


# -- achievable-time model ----------------------------------------------------
#
# The least time of a fused attention forward on the card from its own
# units, each busy at its peak and all overlapped (a warp-specialised kernel
# runs the products, the exponentials and the copies at once):
#
#   t_mxu = qk_flops / peak(qk dtype) + pv_flops / peak(pv dtype)
#           (int8 and bf16 products share the tensor cores)
#   t_vpu = visible pairs / SFU exponentials a second (one exp a score)
#   t_hbm = minimum traffic / HBM bandwidth
#   t_ach = max(t_mxu, t_vpu, t_hbm)
#
# (The field names keep the JAX package's: t_mxu_s is the tensor cores'
# time and t_vpu_s the SFUs'.) No chip run has yet calibrated how far a
# kernel can come to it, so every report says calibrated=False.


@dataclasses.dataclass(frozen=True)
class AchievableReport:
    t_measured_s: float
    t_achievable_s: float
    pct_of_achievable: float
    t_mxu_s: float      # tensor-core floor
    t_vpu_s: float      # SFU exponentials floor
    t_hbm_s: float      # minimum-traffic floor
    chip: str
    dtype: str
    calibrated: bool = False

    def __str__(self) -> str:
        return (
            f"{self.t_measured_s * 1e3:.3f} ms = {self.pct_of_achievable:.1f}% of "
            f"achievable {self.t_achievable_s * 1e3:.3f} ms "
            f"(max of tensor cores {self.t_mxu_s * 1e3:.3f}, SFU exp "
            f"{self.t_vpu_s * 1e3:.3f}, HBM {self.t_hbm_s * 1e3:.3f}; "
            f"{'calibrated' if self.calibrated else 'uncalibrated'}) "
            f"[{self.dtype} on {self.chip}]"
        )


def attention_achievable(
    time_s: float,
    *,
    batch: int,
    heads: int,
    q_len: int,
    kv_len: int,
    head_dim: int,
    dtype: str = "int8",
    chip: Optional[ChipSpec] = None,
    causal: bool = False,
    window=None,
    sinks: int = 0,
    io_bytes: Optional[float] = None,
) -> AchievableReport:
    """Score a measured fused-attention time against the achievable-time
    model above. dtype: "int8" (both products int8), "int8_bf16pv" (int8
    QK, bf16 PV: solve's fa_int8), "bf16" or "fp32"; `io_bytes` overrides
    the minimum-traffic estimate."""
    chip = chip or detect_chip()
    if chip.exp_per_s is None:
        raise ValueError(f"no SFU rate known for {chip.name!r}")
    pairs = visible_pairs(batch, heads, q_len, kv_len, causal, window, sinks)
    qk_peak = chip.peak_for("int8" if dtype.startswith("int8") else dtype) * 1e12
    pv_peak = chip.bf16_tflops * 1e12 if dtype == "int8_bf16pv" else qk_peak
    qk_flops = pv_flops = 2.0 * pairs * head_dim
    t_mxu = qk_flops / qk_peak + pv_flops / pv_peak
    t_vpu = pairs / chip.exp_per_s
    if io_bytes is None:
        # fa_int8 reads fp32 Q/K/V and writes fp32 O (K/V are quantized on
        # the way in); the bf16 path moves 2-byte elements.
        el = 2 if dtype in ("bf16", "bfloat16") else 4
        io_bytes = attention_bytes(batch, heads, q_len, kv_len, head_dim, el)
    t_hbm = io_bytes / (chip.hbm_gbps * 1e9)
    t_ach = max(t_mxu, t_vpu, t_hbm)
    return AchievableReport(
        t_measured_s=time_s,
        t_achievable_s=t_ach,
        pct_of_achievable=100.0 * t_ach / time_s if time_s else 0.0,
        t_mxu_s=t_mxu,
        t_vpu_s=t_vpu,
        t_hbm_s=t_hbm,
        chip=chip.name,
        dtype=dtype,
    )


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    tflops_achieved: float
    pct_of_compute_sol: float
    pct_of_memory_sol: float
    compute_bound: bool
    chip: str
    dtype: str

    def __str__(self) -> str:
        bound = "compute" if self.compute_bound else "memory"
        return (
            f"{self.tflops_achieved:.1f} TFLOP/s = {self.pct_of_compute_sol:.1f}% of "
            f"{self.dtype} tensor-core SoL, {self.pct_of_memory_sol:.1f}% of HBM SoL "
            f"({bound}-bound) on {self.chip}"
        )


def roofline(
    time_s: float,
    flops: float,
    bytes_moved: float,
    dtype: str = "bf16",
    chip: Optional[ChipSpec] = None,
) -> RooflineReport:
    chip = chip or detect_chip()
    peak_tflops = chip.peak_for(dtype)
    achieved = flops / time_s / 1e12
    mem_sol_t = bytes_moved / (chip.hbm_gbps * 1e9)
    comp_sol_t = flops / (peak_tflops * 1e12)
    return RooflineReport(
        tflops_achieved=achieved,
        pct_of_compute_sol=100.0 * comp_sol_t / time_s,
        pct_of_memory_sol=100.0 * mem_sol_t / time_s,
        compute_bound=comp_sol_t > mem_sol_t,
        chip=chip.name,
        dtype=dtype,
    )
