"""The INT8 flash forward's int8-P route (csrc/flash_int8_fwd.cu MODE_INT8_P,
TPU kernel 1) on the CPU: its fragment layouts and its walk emulated.

The CUDA kernel holds 64 q rows a block (one consumer warpgroup, warps of
16 rows) and walks, per quant block, the 64-key tiles of it that some row
of the block sees (the last one clipped at the block's end), twice: a max
sweep on the int32 scores, then an exp sweep that recomputes S, takes
P' = 2^(fma(s, f·log2 e, −shift·log2 e)), sums the f32 P' into l and
rounds P' to int8 (the low byte of P' + 1.5·2^23) as the register A of an
s8 wgmma against Vᵀ, which the producer makes from V's rows by 4 x 4 byte
transposes. Here:

- The layout: S's accumulator fragments packed into the s8 register A and
  the producer's Vᵀ (its byte permutes, its key order and the 128-byte
  swizzle) emulated thread by thread; the product they make equals
  round(P') @ V exactly in int32, at d = 32, 64 and 128.
- The walk: `_walk`, the kernel's algorithm block by block, against JAX's
  flash_attention_int8_prequant(pv_dtype="int8") in interpret mode (a
  causal GQA prefill with block_kv = S, and window + sinks), and against
  the plain version on chip_smoke.py's MODE_INT8_P FLASH_COVERAGE cases,
  within chip_smoke.flash_tolerances: two P-rounding flips of the row and
  1e-5 of f32 order on the output, 1e-5 + 1e-6 |lse| on lse. As in the
  bf16-P tiles test, rows where XLA's jitted Q quantizer (a reciprocal)
  and the exact one give other int8 Q are left out of the JAX comparison.
- Each planted fault of the kernel in chip_smoke.PLANTED_FAULTS as a
  switch of the layout or the walk: each must break it.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_flash_int8_tiles as bf16p_tiles
from quantizedmha_tpu_torch.ops import flash_attention_int8 as tfa
from quantizedmha_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, block_should_run

jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention_int8")

BK = 64      # keys of an item
ROWS = 64    # q rows of a block
LOG2E = 1.4426950408889634
MAGIC = np.float32(12582912.0)  # 1.5 * 2^23
INT8P_CASES = {i: c for i, c in enumerate(chip_smoke.FLASH_COVERAGE) if c[12] == 0}
NEW_CASES = {i: c for i, c in INT8P_CASES.items() if i >= chip_smoke.FIRST_INT8P_CASE}


# --- the layout ---------------------------------------------------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on 32-bit words (selectors below 8)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _sw8(r, c):
    """Byte offset of 16-byte chunk c of row r in an int8 tile (wgmma_s8.cuh)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def _words(buf, at):
    return [int.from_bytes(bytes(buf[at + 4 * i:at + 4 * i + 4]), "little") for i in range(4)]


def _vt_tile(v_tile, fault=None):
    """Vᵀ as the producer writes it: v_tile [64, D] int8 copied into the
    swizzled raw tile, each unit's four rows transposed by byte permutes
    into D rows of 128 bytes."""
    D = v_tile.shape[1]
    raw = bytearray(64 * 128)
    for r in range(64):
        for c in range(D // 16):
            raw[_sw8(r, c):_sw8(r, c) + 16] = v_tile[r, 16 * c:16 * c + 16].astype(np.int8).tobytes()
    vt = bytearray(D * 128)
    for u in range(BK * D // 64):
        ut, uh, rest = u & 3, (u >> 3) & 1, u >> 4
        uc = rest % (BK // 32)
        ucc = 2 * (rest // (BK // 32)) + ((u >> 2) & 1)
        q, vr = 2 * uc + uh, 32 * uc + 16 * uh + 2 * ut
        w = [_words(raw, _sw8(vr + (i & 1) + 8 * (i >> 1), ucc)) for i in range(4)]
        for i in range(4):
            lo01 = _byte_perm(w[0][i], w[1][i], 0x5140)
            hi01 = _byte_perm(w[0][i], w[1][i], 0x7362)
            lo23 = _byte_perm(w[2][i], w[3][i], 0x5140)
            hi23 = _byte_perm(w[2][i], w[3][i], 0x7362)
            col = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
                   _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
            for k in range(4):
                d = 16 * ucc + 4 * i + k
                t = (ut + 1) & 3 if fault == "vt_shift" else ut
                at = _sw8(d, q) + 4 * t
                vt[at:at + 4] = col[k].to_bytes(4, "little")
    return vt


def _round_p(pe, fault=None):
    """rint(P') as the kernel takes it: the low byte of P' + 1.5·2^23 (an
    f32 add, round to nearest even; toward zero for the planted fault)."""
    pe = np.asarray(pe, np.float32)
    if fault == "p_trunc":
        return np.trunc(pe).astype(np.int64)
    return ((pe + MAGIC).view(np.uint32) & 0xFF).astype(np.int64)


def _register_a(pe, fault=None):
    """The s8 register A [64, 64] of one exp item from the f32 P' [64 rows,
    64 keys] as the warps' S accumulators hold it: thread (w, 4g + t) packs
    register 2hh + r of k32 step c from its keys 8j + 2t + (u & 1) of tiles
    j = 4c + 2hh + (u >> 1) (byte u) of row 16w + g + 8r; wgmma reads that
    register as k columns 32c + 16hh + 4t + u of that row."""
    p8 = _round_p(pe, fault)
    a = np.zeros((64, 64), np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for c in range(2):
                for hh in range(2):
                    for r in range(2):
                        row = 16 * w + g + 8 * r
                        for u in range(4):
                            key = 8 * (4 * c + 2 * hh + (u >> 1)) + 2 * t + (u & 1)
                            a[row, 32 * c + 16 * hh + 4 * t + u] = p8[row, key]
    return a


def _pv_product(pe, v_tile, fault=None):
    """The int32 P·V of one exp item: register A against the K-major Vᵀ
    tile that s8_desc names (row n, k byte kk at chunk kk / 16)."""
    D = v_tile.shape[1]
    vt = np.frombuffer(bytes(_vt_tile(v_tile, fault)), np.int8).astype(np.int64)
    b = np.array([[vt[_sw8(n, kk // 16) + kk % 16] for kk in range(BK)] for n in range(D)])
    return _register_a(pe, fault) @ b.T


def _layout_inputs(D, seed):
    rng = np.random.default_rng(seed)
    pe = rng.uniform(0, 126.9, (64, 64)).astype(np.float32)
    pe[::7, ::5] = np.floor(pe[::7, ::5]) + 0.5  # ties: round half to even
    pe[::3, 1::4] = 0.0                          # masked pairs
    v = rng.integers(-127, 128, (64, D))
    return pe, v


@pytest.mark.parametrize("D", [32, 64, 128])
def test_register_a_against_vt_is_round_p_times_v(D):
    pe, v = _layout_inputs(D, seed=D)
    want = np.rint(pe.astype(np.float64)).astype(np.int64) @ v
    np.testing.assert_array_equal(_pv_product(pe, v), want)


def test_byte_permutes_transpose_a_4x4_block():
    rows = [0x03020100, 0x13121110, 0x23222120, 0x33323130]
    lo01, hi01 = _byte_perm(rows[0], rows[1], 0x5140), _byte_perm(rows[0], rows[1], 0x7362)
    lo23, hi23 = _byte_perm(rows[2], rows[3], 0x5140), _byte_perm(rows[2], rows[3], 0x7362)
    cols = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
    assert cols == [0x30201000, 0x31211101, 0x32221202, 0x33231303]


# --- the walk -----------------------------------------------------------------

def _walk(q, k_i8, ks, v_i8, vs, offsets, kw, fault=None):
    """The int8-P kernel's algorithm block by block, (o, lse); `fault`
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
    f32 = bf16p_tiles._f32
    for b in range(B):
        q_off, kv_off = int(offsets[b, 0]), int(offsets[b, 1])
        for h in range(H):
            K = k_i8[b, h // G].to(torch.int64)
            V = v_i8[b, h // G].to(torch.int64)
            for q0 in range(0, Sq, ROWS):
                rows = torch.arange(q0, q0 + ROWS)
                exists = rows < Sq
                Q = torch.zeros(ROWS, D, dtype=torch.int64)
                Q[exists] = q_int[b, h, rows[exists]]
                sq_r = torch.ones(ROWS)
                sq_r[exists] = sq[b, h, rows[exists], 0]
                qpos = q_off + rows
                first_q, last_q = q_off + q0, q_off + min(q0 + ROWS, Sq) - 1
                items = []
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
                    vt = torch.zeros(BK, D, dtype=torch.int64)
                    n = min(BK, kb1 - t0)
                    kt[:n], vt[:n] = K[t0:t0 + n], V[t0:t0 + n]
                    return kt, vt

                def warp_mask(w, t0, tend, unmasked_lo=None):
                    """(runs, keep [16, 64]) of warp w on the tile."""
                    wq0 = q_off + q0 + 16 * w
                    if not block_should_run(kw["causal"], kw["window"], kw["sinks"], wq0,
                                            wq0 + 15, kv_off + t0, kv_off + tend - 1):
                        return False, None
                    kloc = t0 + torch.arange(BK)
                    lo = wq0 if unmasked_lo is None else unmasked_lo
                    if tend - t0 == BK and bf16p_tiles._range_unmasked(
                            kw, lo, wq0 + 15, kv_off + t0, kv_off + tend - 1, tend - 1, mask_tail):
                        return True, torch.ones(16, BK, dtype=torch.bool)
                    r = slice(16 * w, 16 * w + 16)
                    keep = bf16p_tiles._pair_valid(kw, qpos[r], kv_off + kloc, kloc, mask_tail)
                    if fault != "tail_kept":
                        keep &= (kloc < tend)[None, :]
                    return True, keep

                exp_order = [(kb1, t0) for _, kb1, tiles in items for t0 in tiles]
                item = 0
                m = torch.full((ROWS,), float("-inf"))
                l = torch.zeros(ROWS)
                acc = torch.zeros(ROWS, D)
                for j, kb1, tiles in items:
                    if not tiles:
                        continue
                    kss = float(ks[b, h // G, j]) * kw["sm_scale"]
                    vj = min(j + 1, nkv - 1) if fault == "vsc_next" else j
                    vsc = float(vs[b, h // G, vj])
                    f = f32(sq_r.double() * kss)
                    # Sweep 1.
                    imax = torch.full((ROWS,), -2**31, dtype=torch.int64)
                    any_masked = torch.zeros(ROWS, dtype=torch.bool)
                    for t0 in tiles:
                        tend = min(t0 + BK, kb1)
                        S = Q @ tile_of(t0, kb1)[0].T
                        kloc = t0 + torch.arange(BK)
                        for w in range(ROWS // 16):
                            r = slice(16 * w, 16 * w + 16)
                            runs, keep = warp_mask(w, t0, tend)
                            if not runs:
                                any_masked[r] = True
                                continue
                            present = (kloc < tend)[None, :]
                            any_masked[r] |= (present & ~keep).any(dim=1)
                            s = torch.where(keep & present, S[r], torch.full_like(S[r], -2**31))
                            imax[r] = torch.maximum(imax[r], s.amax(dim=1))
                    seen = imax != -2**31
                    mc = torch.where(any_masked, torch.tensor(DEFAULT_MASK_VALUE),
                                     torch.tensor(float("-inf")))
                    dq = f32(imax.double() * f.double())
                    if kw["softcap"] is not None:
                        dq = kw["softcap"] * torch.tanh(dq / kw["softcap"])
                    m_next = torch.maximum(m, torch.where(seen, dq, mc))
                    alpha = torch.where(m_next == float("-inf"), torch.ones(ROWS),
                                        torch.exp(m - m_next))
                    shift = m_next - math.log(127.0)
                    f2 = f32(f.double() * LOG2E)
                    shift2 = f32(shift.double() * LOG2E)
                    # Sweep 2.
                    pvi = torch.zeros(ROWS, D, dtype=torch.int64)
                    lsum = torch.zeros(ROWS)
                    for t0 in tiles:
                        tend = min(t0 + BK, kb1)
                        kt, vt = tile_of(t0, kb1)
                        if fault == "stale_stage":  # K and V of the exp item before
                            kt, vt = (tile_of(exp_order[item - 1][1], exp_order[item - 1][0])
                                      if item > 0 else (torch.zeros_like(kt), torch.zeros_like(vt)))
                        item += 1
                        S = Q @ kt.T
                        P = torch.zeros(ROWS, BK)
                        for w in range(ROWS // 16):
                            r = slice(16 * w, 16 * w + 16)
                            lo = q_off + q0 + 16 * w + 15 if fault == "unmasked_from_last_row" else None
                            runs, keep = warp_mask(w, t0, tend, lo)
                            if not runs:
                                continue
                            if kw["softcap"] is not None:
                                x = f32(S[r].double() * f[r, None].double())
                                x = kw["softcap"] * torch.tanh(x / kw["softcap"])
                                pe = torch.exp(x - shift[r, None])
                            else:
                                pe = torch.exp2(f32(S[r].double() * f2[r, None].double()
                                                    - shift2[r, None].double()))
                            P[r] = torch.where(keep, pe, torch.zeros_like(pe))
                        P8 = torch.from_numpy(_round_p(P.numpy(), fault))
                        lsum += (P8.float() if fault == "l_rounded" else P).sum(dim=1)
                        pvi += P8 @ vt
                    a_acc = torch.ones(ROWS) if fault == "no_alpha" else alpha
                    acc = acc * a_acc[:, None] + pvi.float() * vsc
                    l = alpha * l + lsum
                    m = m_next
                l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
                o[b, h, rows[exists]] = (acc * l_inv[:, None])[exists].to(q.dtype)
                lse[b, h, rows[exists]] = torch.where(
                    l > 0, m + torch.log(l) - ln_p, torch.full_like(l, float("-inf")))[exists]
    return o, lse


def _jax_int8(q, k_i8, ks, v_i8, vs, offsets, kw):
    """JAX's standard INT8 route (int8 P) with lse, one sequence at a time."""
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    outs, lses = [], []
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        jo, jlse = jfa.flash_attention_int8_prequant(
            jnp.asarray(q[sl].float().numpy(), jdt), jnp.asarray(k_i8[sl].numpy()),
            jnp.asarray(ks[sl].numpy()), jnp.asarray(v_i8[sl].numpy()),
            jnp.asarray(vs[sl].numpy()), kv_len=kw["kv_len"], sm_scale=kw["sm_scale"],
            causal=kw["causal"], block_kv=kw["block_kv"], q_offset=int(offsets[b, 0]),
            kv_offset=int(offsets[b, 1]), save_residuals=True, window=kw["window"],
            logit_softcap=kw["softcap"], attention_sinks=kw["sinks"], pv_dtype="int8")
        outs.append(torch.from_numpy(np.array(jo, np.float32)).to(q.dtype))
        lses.append(torch.from_numpy(np.array(jlse, np.float32)).reshape(1, q.shape[1], -1))
    return torch.cat(outs), torch.cat(lses)


# (B, H, Hkv, Sq, Skv, kv_len, D, block_kv, causal, window, sinks, softcap,
#  mode, bf16 q, offsets): a serve_w4-like causal GQA prefill whose one
# quant block holds every key, and window + sinks over several blocks.
JAX_CASES = {
    "prefill_one_quant_block": (1, 4, 1, 384, 384, 384, 64, 384, True, None, 0, None, 0, True,
                                None),
    "window_sinks": (1, 4, 2, 256, 320, 300, 32, 64, True, 64, 4, None, 0, False, None),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_walk_matches_jax(name):
    inputs = bf16p_tiles._inputs(JAX_CASES[name], seed=len(name))
    o, lse, tol, lse_tol = bf16p_tiles._plain(*inputs)
    wo, wlse = _walk(*inputs)
    jo, jlse = _jax_int8(*inputs)
    keep = ~bf16p_tiles._tie_rows(inputs[0])
    assert keep.float().mean() > 0.98
    assert chip_smoke.err_over_tol(wo[keep], jo[keep], tol.expand_as(o)[keep]) <= 1.0
    assert chip_smoke.err_over_tol(wlse[keep], jlse[keep], lse_tol[keep]) <= 1.0


@pytest.mark.parametrize("i", sorted(INT8P_CASES), ids=lambda i: f"fa8_{i}")
def test_walk_matches_plain_on_coverage_cases(i):
    inputs = bf16p_tiles._inputs(INT8P_CASES[i], seed=300 + i)
    o, lse, tol, lse_tol = bf16p_tiles._plain(*inputs)
    wo, wlse = _walk(*inputs)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0


def test_coverage_holds_the_kernels_edges():
    """The new int8-P cases reach the edges the kernel's walk has."""
    cases = list(NEW_CASES.values())
    assert all(c[12] == 0 for c in cases)
    assert any(c[3] == c[4] == c[7] == 512 for c in cases)        # serve_w4's quant block
    assert any(c[7] == 1024 and c[5] < c[4] for c in cases)       # a padded block of 1024
    assert any(c[3] % ROWS for c in cases)
    assert {1, 4, 8} <= {c[1] // c[2] for c in cases}
    assert {64, 96, 320} <= {c[7] for c in cases}
    assert any(c[4] < BK for c in cases)
    assert any(isinstance(c[14], tuple) and isinstance(c[14][0], tuple) for c in cases)
    assert any(c[9] is not None and c[10] for c in cases)
    assert any(c[11] is not None and not c[8] for c in cases)
    assert {c[6] for c in cases} == {32, 64, 128}
    assert {c[13] for c in cases} == {False, True}


# --- the planted faults -------------------------------------------------------

FAULTS = {
    "vt_shift": "int8 P: Vᵀ's keys one step off (lane t's P against lane t + 1's keys)",
    "p_trunc": "int8 P: P truncated, not rounded to nearest even",
    "l_rounded": "int8 P: l sums the rounded P, not the f32 P'",
    "vsc_next": "int8 P: V scale of the next quant block",
    "no_alpha": "int8 P: acc not rescaled by alpha",
    "tail_kept": "int8 P: keys past a clipped tile's quant block kept",
    "unmasked_from_last_row":
        "int8 P: a warp's tile taken as mask-free when its last row sees it whole",
    "stale_stage": "int8 P: an item's K and V copied into the next stage (stale reads)",
}
LAYOUT_FAULTS = {"vt_shift", "p_trunc"}
# Causal GQA, d=64, quant blocks of 96 keys (tiles clipped at each block's
# end) and a second sequence whose first 40 rows see no key.
FAULT_CASE = (2, 4, 2, 100, 288, 288, 64, 96, True, None, 0, None, 0, False,
              ((150, 0), (0, 40)))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_analogues_break_the_layout_or_the_walk(fault):
    assert any(f[0] == "flash_int8_fwd.cu" and f[1] == FAULTS[fault]
               for f in chip_smoke.PLANTED_FAULTS)
    if fault in LAYOUT_FAULTS:
        pe, v = _layout_inputs(64, seed=5)
        assert not np.array_equal(_pv_product(pe, v, fault), _pv_product(pe, v))
    if fault == "vt_shift":
        return
    inputs = bf16p_tiles._inputs(FAULT_CASE, seed=7)
    o, lse, tol, lse_tol = bf16p_tiles._plain(*inputs)
    wo, wlse = _walk(*inputs, fault=fault)
    worst = max(chip_smoke.err_over_tol(wo, o, tol), chip_smoke.err_over_tol(wlse, lse, lse_tol))
    assert worst > 1.0


def test_every_planted_fault_has_an_analogue():
    lines = [f[1] for f in chip_smoke.PLANTED_FAULTS
             if f[0] == "flash_int8_fwd.cu" and f[1].startswith("int8 P:")]
    assert sorted(lines) == sorted(FAULTS.values())
