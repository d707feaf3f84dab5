"""The bf16 flash forward's tiles (csrc/flash_fwd.cu, TPU kernel 5) on the
CPU: the wgmma kernel's edge cases against JAX, and its walk emulated.

The CUDA kernel folds a kv head's whole GQA group into the rows of a
block: block row r holds q head hc·GB + r // NQ of the group at position
q0 + r % NQ (GB = min(group, ROWS), NQ = ROWS // GB; ROWS = 128 rows at
d=32, two consumers of 64, and 192 above, three), and the block walks the
64-key tiles that some row can see, skipping per warp of 16 rows the tiles
it cannot see and the masks of tiles it sees whole. Here:

- chip_smoke.py's FLASH_FWD_COVERAGE cases from the eighth up to
  FIRST_F32_CASE, whose f32 cases tests/test_torch_flash_fwd_f32_tiles.py
  holds (these: ragged q tiles, Skv under one tile, groups of 1, 3, 5, 8, 130 and 200,
  offsets per sequence, window + sinks with skipped tiles, softcap on
  mask-free tiles, d = 32, 64, 128): the port's plain version against JAX's
  flash_attention (Pallas in interpret mode, its online softmax stepping
  64 keys as the CUDA kernel does), within chip_smoke.flash_fwd_tolerances.
  JAX takes one (q_offset, kv_offset) a call, so a case with offsets per
  sequence runs JAX one sequence at a time.
- `_walk`, the kernel's algorithm in PyTorch (rows folded and regrouped by
  (q head, position), tile by tile, the same skips and mask-free tiles,
  p = 2^(x·log2 e − m·log2 e), P rounded to bf16 once; f32 inputs carry
  P whole, as the f32 route's six passes do), equal to the plain
  version within the same tolerance on every new case.
- Each planted fault of the bf16 kernel in chip_smoke.PLANTED_FAULTS as a
  switch of `_walk`: each must miss the tolerance by more than 5x.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention")

BK = 64  # the kernel's key tile


def _rows(d):
    """The kernel's block rows at head dim d: 64 a consumer."""
    return 128 if d == 32 else 192
LOG2E = 1.4426950408889634
NEW_CASES = {i: c for i, c in enumerate(chip_smoke.FLASH_FWD_COVERAGE)
             if 7 <= i < chip_smoke.FIRST_F32_CASE}


def _inputs(case, seed):
    """(q, k, v, offsets, masks) of a coverage case from numpy, as bf16 /
    f32 tensors on the CPU; offsets [B, 2]."""
    B, H, Hkv, Sq, Skv, D, causal, window, sinks, cap, bf16, offs = case
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.5, (B, H, Sq, D)).astype(np.float32)
    k, v = rng.normal(0, 1.0, (2, B, Hkv, Skv, D)).astype(np.float32)
    dt = torch.bfloat16 if bf16 else torch.float32
    q_off, kv_off = offs if offs is not None else (Skv - Sq, 0)
    offsets = tfa._offsets(q_off, kv_off, B, "cpu")
    tq, tk, tv = (torch.from_numpy(x).to(dt) for x in (q, k, v))
    return tq, tk, tv, offsets, dict(causal=causal, window=window, sinks=sinks, softcap=cap)


def _plain(q, k, v, offsets, masks):
    """The plain version at chip_smoke's step (min(1024, Skv) keys), its
    output and lse, and chip_smoke's tolerances on them."""
    sm = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm, block_kv=min(1024, k.shape[2]), **masks)
    o, lse = tfa._flash_fwd_plain(q, k, v, offsets, save_residuals=True, **kw)
    w_abs = tfa._flash_fwd_plain(q, k, v.abs(), offsets, save_residuals=False, **kw)
    tol, lse_tol = chip_smoke.flash_fwd_tolerances(q, k, v, o, lse, w_abs, sm_scale=sm,
                                                   softcap=masks["softcap"])
    return o, lse, tol, lse_tol


def _unmasked(masks, first_q, last_q, first_kv, last_kv, last_kloc, skv):
    """range_unmasked of flash_fwd.cu: no pair of the ranges is masked."""
    if last_kloc >= skv:
        return False
    if not masks["causal"]:
        return True
    ok = last_kv <= first_q
    if masks["window"] is not None:
        ok &= (last_q - first_kv) < masks["window"]
    return ok


def _visible(masks, qpos, kpos, kloc, skv):
    """pair_valid of flash_fwd.cu over [rows, keys]."""
    valid = kloc[None, :] < skv
    if masks["causal"]:
        valid = valid & (kpos[None, :] <= qpos[:, None])
        if masks["window"] is not None:
            in_win = (qpos[:, None] - kpos[None, :]) < masks["window"]
            if masks["sinks"]:
                in_win = in_win | (kpos[None, :] < masks["sinks"])
            valid = valid & in_win
    return valid


def _walk(q, k, v, offsets, masks, fault=None):
    """The bf16 kernel's algorithm block by block, (o, lse); `fault` plants
    the analogue of one of its PLANTED_FAULTS lines."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    ROWS = _rows(D)
    GB = min(G, ROWS)
    NQ = ROWS // GB
    HC = -(-G // GB)
    stages = 4 if D == 32 else 3  # the ring of K/V stages
    qs = tfa.scaled_q(q, D**-0.5).float()
    kf, vf = k.float(), v.float()
    mask_value = tfa.DEFAULT_MASK_VALUE
    o = torch.full((B, H, Sq, D), float("nan"), dtype=q.dtype)
    lse = torch.full((B, H, Sq), float("nan"))
    r = torch.arange(ROWS)
    for b in range(B):
        q_off, kv_off = int(offsets[b, 0]), int(offsets[b, 1])

        def should_run(lo, hi, t0):
            return tfa.block_should_run(masks["causal"], masks["window"], masks["sinks"], lo, hi,
                                        kv_off + t0, kv_off + min(t0 + BK, Skv) - 1)
        for kvh in range(Hkv):
            for hc in range(HC):
                for q0 in range(0, Sq, NQ):
                    gi = hc * GB + r // NQ
                    pos = q0 + r % NQ
                    exists = (r // NQ < GB) & (gi < G) & (pos < Sq)
                    q_gi = torch.clamp(gi + 1, max=G - 1) if fault == "wrong_head" else gi
                    Q = torch.zeros(ROWS, D)
                    Q[exists] = qs[b, kvh * G + q_gi[exists], pos[exists]]
                    qpos = q_off + pos

                    def span(r0, n):
                        sel = qpos[r0:r0 + n][exists[r0:r0 + n]]
                        return (int(sel.min()), int(sel.max())) if len(sel) else None

                    first_q, last_q = q_off + q0, q_off + min(q0 + NQ, Sq) - 1
                    tiles = [t0 for t0 in range(0, Skv, BK) if should_run(first_q, last_q, t0)]
                    m = torch.full((ROWS,), float("-inf"))
                    l = torch.zeros(ROWS)
                    acc = torch.zeros(ROWS, D)
                    for n, t0 in enumerate(tiles):
                        src = t0
                        if fault == "stale_stage":  # the stage holds another tile of the walk
                            src = tiles[n - stages + 1] if n >= stages - 1 else None
                        kt, vt = torch.zeros(BK, D), torch.zeros(BK, D)
                        if src is not None:
                            kt[:min(BK, Skv - src)] = kf[b, kvh, src:src + BK]
                            vt[:min(BK, Skv - src)] = vf[b, kvh, src:src + BK]
                        if fault == "v_neighbour":
                            vt = vt.reshape(4, 16, D)[[1, 0, 3, 2]].reshape(BK, D)
                        kloc = t0 + torch.arange(BK)
                        for c in range(ROWS // 64):
                            S = Q[64 * c:64 * c + 64] @ kt.T
                            for w in range(4):
                                rows = slice(64 * c + 16 * w, 64 * c + 16 * w + 16)
                                wspan = span(64 * c + 16 * w, 16)
                                if wspan is None or not should_run(*wspan, t0):
                                    continue  # p = 0: m, l and acc unchanged
                                lo = wspan[1] if fault == "unmasked_from_last_row" else wspan[0]
                                unmasked = _unmasked(masks, lo, wspan[1], kv_off + t0,
                                                     kv_off + t0 + BK - 1, t0 + BK - 1, Skv)
                                x = S[16 * w:16 * w + 16]
                                if masks["softcap"] is not None:
                                    x = masks["softcap"] * torch.tanh(x / masks["softcap"])
                                if not unmasked:
                                    ok = _visible(masks, qpos[rows], kv_off + kloc, kloc, Skv)
                                    x = torch.where(ok, x, torch.full_like(x, mask_value))
                                m_next = torch.maximum(m[rows], x.amax(dim=-1))
                                alpha = torch.exp(m[rows] - m_next)
                                live = (m_next > mask_value * 0.5) | unmasked
                                p = torch.exp2(x * LOG2E - (m_next * LOG2E)[:, None])
                                p = torch.where(live[:, None], p, torch.zeros_like(p))
                                l[rows] = alpha * l[rows] + p.sum(dim=-1)
                                if fault != "no_rescale":
                                    acc[rows] *= alpha[:, None]
                                # bf16 rounds P once; f32's six passes carry it whole
                                pb = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 else p
                                if fault == "keys_swapped":
                                    pb = pb.reshape(16, BK // 2, 2).flip(-1).reshape(16, BK)
                                acc[rows] += pb @ vt
                                m[rows] = m_next
                    heads = kvh * G + gi[exists]
                    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
                    o[b, heads, pos[exists]] = (acc * l_inv[:, None])[exists].to(q.dtype)
                    lse[b, heads, pos[exists]] = torch.where(
                        l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))[exists]
    return o, lse


def _jax(q, k, v, offsets, masks):
    """JAX's flash_attention with lse at a 64-key step, one sequence at a
    time (its offsets are one pair a call)."""
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    outs, lses = [], []
    for b in range(q.shape[0]):
        jq, jk, jv = (jnp.asarray(x[b:b + 1].float().numpy(), jdt) for x in (q, k, v))
        jo, jlse = jfa.flash_attention(
            jq, jk, jv, causal=masks["causal"], block_kv=BK, save_residuals=True,
            q_offset=int(offsets[b, 0]), kv_offset=int(offsets[b, 1]), window=masks["window"],
            logit_softcap=masks["softcap"], attention_sinks=masks["sinks"])
        outs.append(torch.from_numpy(np.asarray(jo, np.float32)).to(q.dtype))
        lses.append(torch.from_numpy(np.asarray(jlse, np.float32)))
    return torch.cat(outs), torch.cat(lses)


@pytest.mark.parametrize("i", sorted(NEW_CASES), ids=lambda i: f"flash_fwd{i}")
def test_plain_matches_jax_on_new_coverage_cases(i):
    q, k, v, offsets, masks = _inputs(NEW_CASES[i], seed=100 + i)
    o, lse, tol, lse_tol = _plain(q, k, v, offsets, masks)
    jo, jlse = _jax(q, k, v, offsets, masks)
    assert chip_smoke.err_over_tol(jo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(jlse, lse, lse_tol) <= 1.0


@pytest.mark.parametrize("i", sorted(NEW_CASES), ids=lambda i: f"flash_fwd{i}")
def test_folded_walk_matches_plain(i):
    q, k, v, offsets, masks = _inputs(NEW_CASES[i], seed=100 + i)
    o, lse, tol, lse_tol = _plain(q, k, v, offsets, masks)
    wo, wlse = _walk(q, k, v, offsets, masks)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0


def test_coverage_holds_the_kernels_edges():
    """The new cases reach every edge the issue of row folding has: a q
    tile that is ragged in positions, Skv under one tile, each group size,
    head chunks, offsets per sequence, windows with skipped tiles, softcap
    on whole tiles, and each head dim in bf16."""
    bf16 = [c for c in NEW_CASES.values() if c[10]]
    assert {c[5] for c in bf16} == {32, 64, 128}
    rows = {c: _rows(c[5]) for c in bf16}
    groups = {c: c[1] // c[2] for c in bf16}
    assert {1, 3, 5, 8}.issubset(groups.values())
    assert {c[5] for c in bf16 if groups[c] > rows[c]} == {32, 64}
    assert {32, 128} <= {c[5] for c in bf16 if rows[c] % groups[c]}
    assert any(c[3] % rows[c] and c[3] % (rows[c] // min(groups[c], rows[c])) for c in bf16)
    assert any(c[4] < BK for c in bf16)
    assert any(c[0] == 2 and isinstance(c[11], tuple) and isinstance(c[11][0], tuple)
               for c in bf16)
    assert any(c[7] is not None and c[8] and c[4] > c[7] + 2 * BK for c in bf16)
    assert any(c[9] is not None and not c[6] for c in bf16)


# The analogues of PLANTED_FAULTS's bf16 flash_fwd.cu lines, at a GQA-4
# causal shape whose warps straddle the diagonal.
FAULTS = {
    "v_neighbour": "bf16 P·V: each k16 step of P against the V rows of the neighbouring step",
    "keys_swapped": "bf16: P's two keys swapped when packed to the A fragment",
    "stale_stage": "bf16: next key tile copied into the stage being read",
    "no_rescale": "bf16: acc not rescaled when a row's max moved",
    "wrong_head": "bf16: a folded row's Q taken from the group's next q head",
    "unmasked_from_last_row": "bf16: a tile taken as wholly visible when the warp's last row sees it",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_analogues_miss_the_tolerance(fault):
    assert any(f[0] == "flash_fwd.cu" and f[1] == FAULTS[fault] for f in chip_smoke.PLANTED_FAULTS)
    case = (1, 8, 2, 150, 300, 64, True, None, 0, None, True, None)
    q, k, v, offsets, masks = _inputs(case, seed=7)
    o, lse, tol, lse_tol = _plain(q, k, v, offsets, masks)
    wo, wlse = _walk(q, k, v, offsets, masks, fault=fault)
    worst = max(chip_smoke.err_over_tol(wo, o, tol), chip_smoke.err_over_tol(wlse, lse, lse_tol))
    assert worst > 5.0 or math.isinf(worst)
