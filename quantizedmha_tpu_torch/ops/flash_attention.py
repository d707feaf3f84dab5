"""Masking and block helpers shared by the attention entry points
(counterpart of the helper half of quantizedmha_tpu/ops/flash_attention.py).

The floating-point FlashAttention kernels of that module (`_fwd_kernel`
and the two backward kernels) are not ported yet; see ROADMAP.md queue 2.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def validate_masking(causal: bool, window, sinks: int) -> None:
    """One validation contract for every attention entry point: a masking
    knob one kernel would drop silently must raise everywhere."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sinks and window is None:
        raise ValueError("attention_sinks require a window")


def block_should_run(causal: bool, window, sinks: int,
                     first_q, last_q, first_kv, last_kv):
    """Block-level skip: run unless the block is wholly above the causal
    diagonal or wholly behind the window (sink blocks always considered).
    Positions are GLOBAL. Skipping such a block changes no output bit: all
    its scores are masked, so it adds p = 0 and never raises a row max."""
    if not causal:
        return True
    run = last_q >= first_kv
    if window is not None:
        in_window = (first_q - last_kv) < window
        if sinks:
            in_window |= first_kv < sinks
        run &= in_window
    return run


def pick_blocks(
    q_len: int,
    kv_len: int,
    head_dim: int,
    *,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
):
    """(block_q, block_kv) of the standard route. block_kv keeps the JAX
    package's default of 1024 because it fixes the numerics (the K/V quant
    block and the online-softmax step); block_q has no numerical effect
    and the TPU's VMEM caps on it do not apply, so it is the whole q_len
    unless given. head_dim is accepted for signature parity."""
    del head_dim
    return min(block_q or q_len, q_len), min(block_kv or 1024, kv_len)
