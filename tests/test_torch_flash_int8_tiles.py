"""The INT8 flash forward's bf16-P route (csrc/flash_int8_fwd.cu MODE_BF16_P,
TPU kernel 2) on the CPU: its edge cases against JAX, and its walk emulated.

The CUDA kernel holds 128 q rows a block (two consumers of 64, warps of
16) and walks, per quant block, the 64-key tiles of it that some row of
the block sees (the last one clipped at the block's end), twice: a max
sweep on the int32 scores, then an exp sweep that recomputes S, takes
P' = 2^(fma(s, f·log2 e, −shift·log2 e)) with s converted to f32 by a
magic number, rounds P' to bf16 and sums P'·[V | 1] per quant block (l on
the ones column), folded in at the block's end as acc·α + pv·vsc. Here:

- chip_smoke.py's MODE_BF16_P FLASH_COVERAGE cases from the tenth on
  (q rows not a multiple of 128, block_kv of 64, 96, 320 and 512, Skv under
  one tile, quant blocks wholly masked for some rows, window + sinks,
  softcap on mask-free tiles, d = 32, 64, 128, f32 and bf16 q, GQA with
  offsets per sequence): the port's plain version against JAX's
  flash_attention_int8_t_prequant (Pallas in interpret mode), within
  chip_smoke.flash_tolerances. JAX takes one (q_offset, kv_offset) a call,
  so a case with offsets per sequence runs JAX one sequence at a time.
  Under jit, XLA divides q by its row scale through a reciprocal (ROADMAP
  "Reference behaviours"), which rounds a q/scale that sits on a tie of
  the int8 grid the other way (bf16 q lands on ties often); the port
  divides exactly, as the JAX package's eager quantizers do. Rows where
  the two quantizers give other int8 Q are left out of that comparison,
  and must be under 2% of the rows.
- `_walk`, the kernel's algorithm in PyTorch, equal to the plain version
  within the same tolerance on those cases.
- The magic-number conversion equals float(s) for every |s| <= 128·127².
- Each planted fault of the kernel in chip_smoke.PLANTED_FAULTS as a switch
  of `_walk`: each must miss the tolerance by more than 5x.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantizedmha_tpu_torch.ops import flash_attention_int8 as tfa
from quantizedmha_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, block_should_run
from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks

jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention_int8")

BK = 64      # the kernel's key tile
ROWS = 128   # q rows of a block
LOG2E = 1.4426950408889634
NEW_CASES = {i: c for i, c in enumerate(chip_smoke.FLASH_COVERAGE) if i >= 9 and c[12] == 1}


def _inputs(case, seed):
    """(q, k_i8, k_scales, v_i8, v_scales, offsets, kw) of a coverage case
    from numpy; kw holds the plain version's keywords."""
    (B, H, Hkv, Sq, Skv, kv_len, D, bkv, causal, window, sinks, cap, mode, bf16,
     offs) = case
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 2.0, (B, H, Sq, D)).astype(np.float32)
    k, v = rng.normal(0, 1.0, (2, B, Hkv, Skv, D)).astype(np.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16 if bf16 else torch.float32)
    k_i8, ks = quantize_kv_blocks(torch.from_numpy(k), bkv)
    v_i8, vs = quantize_kv_blocks(torch.from_numpy(v), bkv)
    if offs is None:
        qo, kvo = [kv_len - Sq] * B, [0] * B
    elif isinstance(offs[0], tuple):
        qo, kvo = (list(x) for x in zip(*offs))
    else:
        qo, kvo = list(offs), [0] * B
    offsets = tfa._offsets(torch.tensor(qo), torch.tensor(kvo), B, "cpu")
    kw = dict(sm_scale=D**-0.5, causal=causal, kv_len=kv_len, block_kv=bkv, scale_clamp=1e-8,
              p_scale=127.0, window=window, softcap=cap, sinks=sinks, mode=mode)
    return tq, k_i8, ks, v_i8, vs, offsets, kw


def _plain(q, k_i8, ks, v_i8, vs, offsets, kw):
    """The plain version's output and lse, and chip_smoke's tolerances."""
    o, lse = tfa._flash_int8_plain(q, k_i8, ks, v_i8, vs, offsets, save_residuals=True, **kw)
    _, _, l = tfa._flash_int8_plain_state(q, k_i8, ks, v_i8, vs, offsets, **kw)
    tol, lse_tol = chip_smoke.flash_tolerances(o, lse, l, v_i8, vs, kw["block_kv"], kw["mode"])
    return o, lse, tol, lse_tol


def _jax(q, k_i8, ks, v_i8, vs, offsets, kw):
    """JAX's transposed INT8 route (bf16 P, summode mxu) with lse, one
    sequence at a time."""
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    outs, lses = [], []
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        jo, jlse = jfa.flash_attention_int8_t_prequant(
            jnp.asarray(q[sl].float().numpy(), jdt), jnp.asarray(k_i8[sl].numpy()),
            jnp.asarray(ks[sl].numpy()), jnp.asarray(v_i8[sl].numpy()),
            jnp.asarray(vs[sl].numpy()), kv_len=kw["kv_len"], sm_scale=kw["sm_scale"],
            causal=kw["causal"], q_offset=int(offsets[b, 0]), kv_offset=int(offsets[b, 1]),
            save_residuals=True, window=kw["window"], logit_softcap=kw["softcap"],
            attention_sinks=kw["sinks"])
        outs.append(torch.from_numpy(np.array(jo, np.float32)).to(q.dtype))
        lses.append(torch.from_numpy(np.array(jlse, np.float32)).reshape(1, q.shape[1], -1))
    return torch.cat(outs), torch.cat(lses)


@jax.jit
def _xla_q_rows(q):
    """The JAX kernel's per-row Q quantization as XLA compiles it (the
    kernel's own lines, on rows of [.., Sq, D])."""
    amax = jnp.max(jnp.abs(q), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    return jnp.clip(jnp.round(q / scale), -127.0, 127.0)


def _tie_rows(q):
    """[B, H, Sq]: rows whose int8 Q differs between XLA's jitted
    quantizer and the exact one (the port's)."""
    qf = q.float()
    scale = tfa.true_div(torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-8), 127.0)
    exact = torch.clamp(torch.round(qf / scale), -127, 127)
    xla = torch.from_numpy(np.array(_xla_q_rows(jnp.asarray(qf.numpy()))))
    return (exact != xla).any(dim=-1)


def _f32(x):
    """float64 -> float32, rounded once."""
    return x.to(torch.float32)


def _s32_to_f32(s, fault=None):
    """The kernel's exact conversion of the int32 scores, or the planted
    fault's (the scores taken as unsigned)."""
    if fault == "convert_unsigned":
        return (s.to(torch.int64) % 2**32).to(torch.float32)
    return s.to(torch.float32)


def _range_unmasked(kw, first_q, last_q, first_kv, last_kv, last_kloc, mask_tail):
    """range_unmasked of flash_int8_fwd.cu."""
    if mask_tail and last_kloc >= kw["kv_len"]:
        return False
    if not kw["causal"]:
        return True
    ok = last_kv <= first_q
    if kw["window"] is not None:
        ok &= (last_q - first_kv) < kw["window"]
    return ok


def _pair_valid(kw, qpos, kpos, kloc, mask_tail):
    """pair_valid of flash_int8_fwd.cu over [rows, keys]."""
    valid = torch.ones(len(qpos), len(kpos), dtype=torch.bool)
    if kw["causal"]:
        valid &= kpos[None, :] <= qpos[:, None]
        if kw["window"] is not None:
            in_win = (qpos[:, None] - kpos[None, :]) < kw["window"]
            if kw["sinks"]:
                in_win |= kpos[None, :] < kw["sinks"]
            valid &= in_win
    if mask_tail:
        valid &= kloc[None, :] < kw["kv_len"]
    return valid


def _walk(q, k_i8, ks, v_i8, vs, offsets, kw, fault=None):
    """The bf16-P kernel's algorithm block by block, (o, lse); `fault`
    plants the analogue of one of its PLANTED_FAULTS lines."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k_i8.shape[1], k_i8.shape[2]
    G, nkv, bkv = H // Hkv, Skv // kw["block_kv"], kw["block_kv"]
    mask_tail = kw["kv_len"] < Skv
    ln_p = math.log(127.0)
    qf = q.float()
    sq = tfa.true_div(torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=kw["scale_clamp"]),
                      127.0)
    q_int = torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int64)
    o = torch.full((B, H, Sq, D), float("nan"), dtype=q.dtype)
    lse = torch.full((B, H, Sq), float("nan"))
    for b in range(B):
        q_off, kv_off = int(offsets[b, 0]), int(offsets[b, 1])
        for h in range(H):
            kvh = h // G
            K = k_i8[b, kvh].to(torch.int64)
            V = v_i8[b, kvh].float()
            for q0 in range(0, Sq, ROWS):
                rows = torch.arange(q0, q0 + ROWS)
                exists = rows < Sq
                Q = torch.zeros(ROWS, D, dtype=torch.int64)
                Q[exists] = q_int[b, h, rows[exists]]
                sq_r = torch.ones(ROWS)
                sq_r[exists] = sq[b, h, rows[exists], 0]
                qpos = q_off + rows
                first_q, last_q = q_off + q0, q_off + min(q0 + ROWS, Sq) - 1
                m = torch.full((ROWS,), float("-inf"))
                l = torch.zeros(ROWS)
                acc = torch.zeros(ROWS, D)
                items = []  # the walk: (quant block, t0) of every item, both sweeps
                for j in range(nkv):
                    kb0, kb1 = j * bkv, (j + 1) * bkv
                    tiles = [t0 for t0 in range(kb0, kb1, BK)
                             if block_should_run(kw["causal"], kw["window"], kw["sinks"],
                                                 first_q, last_q, kv_off + t0,
                                                 kv_off + min(t0 + BK, kb1) - 1)]
                    items.append((j, kb1, tiles))

                def tile_of(t0, kb1):
                    """K and V of a stage: 64 rows from t0, zero past kb1."""
                    kt = torch.zeros(BK, D, dtype=torch.int64)
                    vt = torch.zeros(BK, D)
                    n = min(BK, kb1 - t0)
                    kt[:n], vt[:n] = K[t0:t0 + n], V[t0:t0 + n]
                    return kt, vt

                # The exp tiles in the walk's order (the stale-stage fault reads the
                # K of the one before).
                exp_order = [(kb1, t0) for _, kb1, tiles in items for t0 in tiles]
                item = 0
                for j, kb1, tiles in items:
                    if not tiles:
                        continue
                    kss = float(ks[b, kvh, j]) * kw["sm_scale"]
                    vj = min(j + 1, nkv - 1) if fault == "vsc_next" else j
                    vsc = float(vs[b, kvh, vj])
                    f = _f32(sq_r.double() * kss)
                    # Sweep 1.
                    imax = torch.full((ROWS,), -2**31, dtype=torch.int64)
                    any_masked = torch.zeros(ROWS, dtype=torch.bool)
                    for t0 in tiles:
                        tend = min(t0 + BK, kb1)
                        kt, _ = tile_of(t0, kb1)
                        S = Q @ kt.T
                        kloc = t0 + torch.arange(BK)
                        for w in range(ROWS // 16):
                            r = slice(16 * w, 16 * w + 16)
                            wq0 = q_off + q0 + 16 * w
                            if not block_should_run(kw["causal"], kw["window"], kw["sinks"], wq0,
                                                    wq0 + 15, kv_off + t0, kv_off + tend - 1):
                                any_masked[r] = True
                                continue
                            ok = (kloc < tend)[None, :].expand(16, BK).clone()
                            if not (tend - t0 == BK and _range_unmasked(
                                    kw, wq0, wq0 + 15, kv_off + t0, kv_off + tend - 1, tend - 1,
                                    mask_tail)):
                                valid = _pair_valid(kw, qpos[r], kv_off + kloc, kloc, mask_tail)
                                any_masked[r] |= (ok & ~valid).any(dim=1)
                                ok &= valid
                            s = torch.where(ok, S[r], torch.full_like(S[r], -2**31))
                            imax[r] = torch.maximum(imax[r], s.amax(dim=1))
                    mc = torch.where(any_masked, torch.tensor(DEFAULT_MASK_VALUE),
                                     torch.tensor(float("-inf")))
                    seen = imax != -2**31
                    dq = _f32(imax.double() * f.double())
                    if kw["softcap"] is not None:
                        dq = kw["softcap"] * torch.tanh(dq / kw["softcap"])
                    mc = torch.where(seen, dq, mc)
                    m_next = torch.maximum(m, mc)
                    alpha = torch.where(m_next == float("-inf"), torch.ones(ROWS),
                                        torch.exp(m - m_next))
                    shift = m_next - ln_p
                    f2 = _f32(f.double() * LOG2E)
                    shift2 = _f32(shift.double() * LOG2E)
                    # Sweep 2.
                    pv = torch.zeros(ROWS, D)
                    pv_ones = torch.zeros(ROWS)
                    for t0 in tiles:
                        tend = min(t0 + BK, kb1)
                        kt, vt = tile_of(t0, kb1)
                        if fault == "stale_stage":  # K and V of the exp tile before
                            kt, vt = (tile_of(exp_order[item - 1][1], exp_order[item - 1][0])
                                      if item > 0 else (torch.zeros_like(kt), torch.zeros_like(vt)))
                        item += 1
                        if fault == "v_unsigned":
                            vt = torch.where(vt < 0, vt + 128, vt - 128)
                        if fault == "pv_neighbour":
                            vt = vt.reshape(4, 16, D)[[1, 0, 3, 2]].reshape(BK, D)
                        if fault == "s8_k_step" and D > 32:
                            S = sum(Q[:, 16 * c:16 * c + 32] @ kt[:, 16 * c:16 * c + 32].T
                                    for c in range(D // 32))
                        else:
                            S = Q @ kt.T
                        kloc = t0 + torch.arange(BK)
                        P = torch.zeros(ROWS, BK)
                        for w in range(ROWS // 16):
                            r = slice(16 * w, 16 * w + 16)
                            wq0 = q_off + q0 + 16 * w
                            if not block_should_run(kw["causal"], kw["window"], kw["sinks"], wq0,
                                                    wq0 + 15, kv_off + t0, kv_off + tend - 1):
                                continue
                            lo = wq0 + 15 if fault == "unmasked_from_last_row" else wq0
                            unmasked = tend - t0 == BK and _range_unmasked(
                                kw, lo, wq0 + 15, kv_off + t0, kv_off + tend - 1, tend - 1,
                                mask_tail)
                            if kw["softcap"] is not None:
                                x = _f32(S[r].double() * f[r, None].double())
                                x = kw["softcap"] * torch.tanh(x / kw["softcap"])
                                pe = torch.exp(x - shift[r, None])
                            else:
                                s = _s32_to_f32(S[r], fault)
                                arg = _f32(s.double() * f2[r, None].double()
                                           - shift2[r, None].double())
                                pe = torch.exp2(arg)
                            if not unmasked:
                                keep = _pair_valid(kw, qpos[r], kv_off + kloc, kloc, mask_tail)
                                if fault != "tail_kept":
                                    keep &= (kloc < tend)[None, :]
                                pe = torch.where(keep, pe, torch.zeros_like(pe))
                            P[r] = pe
                        Pb = P.to(torch.bfloat16).float()
                        pv += Pb @ vt
                        if fault != "ones_dropped":
                            pv_ones += Pb.sum(dim=1)
                    a_rows = alpha.clone()
                    if fault == "no_rescale":  # rows g of each warp keep acc unscaled
                        a_rows[(torch.arange(ROWS) % 16) < 8] = 1.0
                    acc = acc * a_rows[:, None] + pv * vsc
                    l = alpha * l + pv_ones
                    m = m_next
                l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
                o[b, h, rows[exists]] = (acc * l_inv[:, None])[exists].to(q.dtype)
                lse[b, h, rows[exists]] = torch.where(
                    l > 0, m + torch.log(l) - ln_p, torch.full_like(l, float("-inf")))[exists]
    return o, lse


@pytest.mark.parametrize("i", sorted(NEW_CASES), ids=lambda i: f"fa8_{i}")
def test_plain_matches_jax_on_new_coverage_cases(i):
    inputs = _inputs(NEW_CASES[i], seed=200 + i)
    o, lse, tol, lse_tol = _plain(*inputs)
    jo, jlse = _jax(*inputs)
    ties = _tie_rows(inputs[0])
    assert ties.float().mean() < 0.02
    keep = ~ties
    assert chip_smoke.err_over_tol(jo[keep], o[keep], tol.expand_as(o)[keep]) <= 1.0
    assert chip_smoke.err_over_tol(jlse[keep], lse[keep], lse_tol[keep]) <= 1.0


@pytest.mark.parametrize("i", sorted(NEW_CASES), ids=lambda i: f"fa8_{i}")
def test_walk_matches_plain(i):
    inputs = _inputs(NEW_CASES[i], seed=200 + i)
    o, lse, tol, lse_tol = _plain(*inputs)
    wo, wlse = _walk(*inputs)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0


def test_magic_conversion_is_exact():
    """int32 -> f32 through the bits of 1.5·2^23 equals float(s) for every
    score a d=128 product can reach (|s| <= 128·127²)."""
    s = np.arange(-128 * 127**2, 128 * 127**2 + 1, dtype=np.int32)
    got = (s + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    assert np.array_equal(got, s.astype(np.float32))


def test_coverage_holds_the_kernels_edges():
    """The new cases reach the edges the issue of the bf16-P kernel names."""
    cases = list(NEW_CASES.values())
    assert all(c[12] == 1 for c in cases)
    assert any(c[3] % ROWS for c in cases)
    assert {64, 96, 320, 512} <= {c[7] for c in cases}
    assert any(c[4] < BK for c in cases)
    assert any(c[7] % BK for c in cases) and any(c[7] // BK > 2 for c in cases)
    assert {c[6] for c in cases} == {32, 64, 128}
    assert not any(c[6] == 128 and c[8] for c in cases)
    assert {c[13] for c in cases} == {False, True}
    assert any(c[9] is not None and c[10] for c in cases)
    assert any(c[11] is not None and not c[8] for c in cases)
    assert any(c[1] != c[2] and isinstance(c[14], tuple) and isinstance(c[14][0], tuple)
               for c in cases)


# The analogues of PLANTED_FAULTS's lines of flash_int8_fwd.cu and
# wgmma_s8.cuh, at a causal GQA shape with d=64, quant blocks of 96 keys
# (tiles clipped at each block's end) and a second sequence whose first 40
# rows see no key.
FAULTS = {
    "s8_k_step": "bf16 P: s8 operands' k32 step advanced 16 bytes, not 32 (d >= 64)",
    "convert_unsigned": "bf16 P: scores converted as unsigned (negative ones near 2^32)",
    "v_unsigned": "bf16 P: V converted as unsigned (biased by 128)",
    "ones_dropped": "bf16 P: the ones column zero (l dropped)",
    "stale_stage": "bf16 P: an item's K and V copied into the next stage (stale reads)",
    "vsc_next": "bf16 P: V scale of the next quant block",
    "tail_kept": "bf16 P: keys past a clipped tile's quant block kept",
    "unmasked_from_last_row":
        "bf16 P: a warp's tile taken as mask-free when its last row sees it whole",
    "pv_neighbour": "bf16 P: each k16 step of P against the V rows of the neighbouring step",
    "no_rescale": "bf16 P: acc not rescaled by alpha (rows g)",
}
FAULT_CASE = (2, 4, 2, 100, 288, 288, 64, 96, True, None, 0, None, 1, False,
              ((150, 0), (0, 40)))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_analogues_miss_the_tolerance(fault):
    assert any(f[0] in ("flash_int8_fwd.cu", "wgmma_s8.cuh") and f[1] == FAULTS[fault]
               for f in chip_smoke.PLANTED_FAULTS)
    inputs = _inputs(FAULT_CASE, seed=7)
    o, lse, tol, lse_tol = _plain(*inputs)
    wo, wlse = _walk(*inputs, fault=fault)
    worst = max(chip_smoke.err_over_tol(wo, o, tol), chip_smoke.err_over_tol(wlse, lse, lse_tol))
    assert worst > 5.0 or math.isinf(worst)


def test_every_planted_fault_has_an_analogue():
    lines = [f[1] for f in chip_smoke.PLANTED_FAULTS
             if f[0] in ("flash_int8_fwd.cu", "wgmma_s8.cuh") and f[1].startswith("bf16 P:")]
    assert sorted(lines) == sorted(FAULTS.values())
