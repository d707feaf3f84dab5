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
  round(P') @ V exactly in int32, at d = 32, 64 and 128. At d=256 (V's
  rows as two 128-byte halves) two consumers share the rows: consumer c
  writes the P of keys 32c..32c+31 as those words into its half of an
  item's 64 bytes of a swizzled P tile, and its P·V reads A from that tile
  and B from Vᵀ's rows 128c..128c+127 (O's columns 128c..); the two
  products side by side equal round(P') @ V too. S = Qq·Kqᵀ read through
  the k32 steps' descriptors from the swizzled tiles equals the integer
  product, at d=256 over both 128-byte halves of each row.
- The walk: `_walk`, the kernel's algorithm block by block (at d=256 each
  consumer's keys, the row maxes exchanged, its share of l added at the
  end), against JAX's
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
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_flash_int8_tiles as bf16p_tiles
from quantizedmha_tpu_torch.ops import flash_attention_int8 as tfa
from quantizedmha_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, block_should_run
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _sw8_d(D, rows, r, c):
    """sw8_d of flash_int8_fwd.cu: a row wider than 128 bytes (d=256) as
    128-byte halves, each half a tile of `rows` rows."""
    if D <= 128:
        return _sw8(r, c)
    return (c >> 3) * rows * 128 + _sw8(r, c & 7)


def _s_product(Q, K, fault=None):
    """S [64, 64] of one item as the s8 wgmma reads it: Q and K [64, D]
    int8 laid into their swizzled tiles (sw8_d), then for each k32 step kc
    the 32 bytes from 32·(kc % 4) of each row at the descriptor's base
    (s8_desc_d: at d=256 steps 4-7 on the second halves; the planted
    fault reads the first halves again)."""
    D = Q.shape[1]
    tiles = []
    for X in (Q, K):
        buf = bytearray(64 * max(D, 128))
        for r in range(64):
            for c in range(D // 16):
                at = _sw8_d(D, 64, r, c)
                buf[at:at + 16] = X[r, 16 * c:16 * c + 16].astype(np.int8).tobytes()
        tiles.append(np.frombuffer(bytes(buf), np.int8).astype(np.int64))
    S = np.zeros((64, 64), np.int64)
    for kc in range(D // 32):
        base = (kc >> 2) * 64 * 128 if D > 128 and fault != "s_half" else 0
        step = (kc & 3) if D > 128 else kc
        ops = [np.array([[t[base + _sw8(r, (32 * step + kk) // 16) + kk % 16] for kk in range(32)]
                         for r in range(64)]) for t in tiles]
        S += ops[0] @ ops[1].T
    return S


def _words(buf, at):
    return [int.from_bytes(bytes(buf[at + 4 * i:at + 4 * i + 4]), "little") for i in range(4)]


def _vt_tile(v_tile, fault=None):
    """Vᵀ as the producer writes it: v_tile [64, D] int8 copied into the
    swizzled raw tile, each unit's four rows transposed by byte permutes
    into D rows of 128 bytes."""
    D = v_tile.shape[1]
    raw = bytearray(64 * max(D, 128))
    for r in range(64):
        for c in range(D // 16):
            at = _sw8_d(D, BK, r, c)
            raw[at:at + 16] = v_tile[r, 16 * c:16 * c + 16].astype(np.int8).tobytes()
    vt = bytearray(D * 128)
    for u in range(BK * D // 64):
        ut, uh, rest = u & 3, (u >> 3) & 1, u >> 4
        uc = rest % (BK // 32)
        ucc = 2 * (rest // (BK // 32)) + ((u >> 2) & 1)
        q, vr = 2 * uc + uh, 32 * uc + 16 * uh + 2 * ut
        w = [_words(raw, _sw8_d(D, BK, vr + (i & 1) + 8 * (i >> 1), ucc)) for i in range(4)]
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


def _p_tile(pe, pb, fault=None):
    """The P tile (64 rows of 128 bytes, swizzled) after both d=256
    consumers wrote an exp item's P into bytes 64pb..64pb+63 of each row:
    consumer c's thread (w, 4g + t) writes word 2hh + r, byte u the P of key
    32c + 16hh + 8(u >> 1) + 2t + (u & 1) of row 16w + g + 8r, at chunk 4pb
    + 2c + hh, byte 4t (the planted fault: consumer 1 writes nothing, its
    bytes stale, zero here)."""
    p8 = _round_p(pe)
    tile = bytearray(64 * 128)
    for c in range(2):
        if fault == "p_half_stale" and c == 1:
            continue
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for hh in range(2):
                    for r in range(2):
                        row = 16 * w + g + 8 * r
                        at = _sw8(row, 4 * pb + 2 * c + hh) + 4 * t
                        for u in range(4):
                            key = 32 * c + 16 * hh + 8 * (u >> 1) + 2 * t + (u & 1)
                            tile[at + u] = int(p8[row, key])
    return tile


def _pv_product(pe, v_tile, fault=None, pb=0):
    """The int32 P·V of one exp item against the K-major Vᵀ tile that
    s8_desc names (row n, k byte kk at chunk kk / 16): at d <= 128 from the
    register A; at d=256 consumer c's A from the P tile's bytes 64pb.. (k32
    step kc at 64pb + 32kc), against Vᵀ's rows 128c..128c+127 for O's
    columns 128c.. (the planted faults: consumer 1 against rows 0-127, or
    each consumer against the other's)."""
    D = v_tile.shape[1]
    vt = np.frombuffer(bytes(_vt_tile(v_tile, fault)), np.int8).astype(np.int64)
    b = np.array([[vt[_sw8(n, kk // 16) + kk % 16] for kk in range(BK)] for n in range(D)])
    if D <= 128:
        return _register_a(pe, fault) @ b.T
    tile = np.frombuffer(bytes(_p_tile(pe, pb, fault)), np.int8).astype(np.int64)
    a = np.array([[tile[_sw8(row, (64 * pb + kk) // 16) + kk % 16] for kk in range(BK)]
                  for row in range(64)])
    out = np.zeros((64, D), np.int64)
    for c in range(2):
        first = 128 * c  # Vᵀ's first row of consumer c's product
        if fault == "pv_half" and c == 1:
            first = 0
        elif fault == "pv_swapped":
            first = 128 * (1 - c)
        out[:, 128 * c:128 * c + 128] = a @ b[first:first + 128].T
    return out


def _layout_inputs(D, seed):
    rng = np.random.default_rng(seed)
    pe = rng.uniform(0, 126.9, (64, 64)).astype(np.float32)
    pe[::7, ::5] = np.floor(pe[::7, ::5]) + 0.5  # ties: round half to even
    pe[::3, 1::4] = 0.0                          # masked pairs
    v = rng.integers(-127, 128, (64, D))
    return pe, v


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_register_a_against_vt_is_round_p_times_v(D):
    """At d=256: the P tile's two halves and the column halves, through
    either of an item's 64 bytes of the tile."""
    pe, v = _layout_inputs(D, seed=D)
    want = np.rint(pe.astype(np.float64)).astype(np.int64) @ v
    for pb in (0, 1) if D == 256 else (0,):
        np.testing.assert_array_equal(_pv_product(pe, v, pb=pb), want)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_scores_from_the_k_halves_are_q_kt(D):
    rng = np.random.default_rng(D + 1)
    Q, K = rng.integers(-127, 128, (2, 64, D))
    np.testing.assert_array_equal(_s_product(Q, K), Q @ K.T)


def test_byte_permutes_transpose_a_4x4_block():
    rows = [0x03020100, 0x13121110, 0x23222120, 0x33323130]
    lo01, hi01 = _byte_perm(rows[0], rows[1], 0x5140), _byte_perm(rows[0], rows[1], 0x7362)
    lo23, hi23 = _byte_perm(rows[2], rows[3], 0x5140), _byte_perm(rows[2], rows[3], 0x7362)
    cols = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
    assert cols == [0x30201000, 0x31211101, 0x32221202, 0x33231303]


def _round_f32(x):
    """An exact rational rounded to the nearest float32, ties to even
    (normal range)."""
    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.uint32)) & 1))


def _fma(a, b, c):
    """fmaf: a·b + c rounded once."""
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


@pytest.mark.parametrize("c", [50.0, 30.0, 20.0, 3.0, 1.0 / 3.0, 49.999996])
def test_branch_free_division_rounds_as_ieee_division(c):
    """div_rn of flash_int8_fwd.cu (the d=256 softcap's x / softcap): q =
    x·rc, then one FMA with the exact remainder, equals IEEE x / c, here
    on dequantized scores from 2^-20 to 2^12 and on the halfway cases the
    quotient's last bit decides."""
    c = np.float32(c)
    rc = np.float32(1) / c
    rng = np.random.default_rng(int(c * 1000))
    xs = (rng.uniform(-1, 1, 1500) * np.exp2(rng.uniform(-20, 12, 1500))).astype(np.float32)
    q = (xs / c).astype(np.float32)
    ties = (q.astype(np.float64) * np.float64(c)).astype(np.float32)  # x near c·q exactly
    for x in np.concatenate([xs, ties]):
        q0 = np.float32(x * rc)
        got = _fma(_fma(-c, q0, x), rc, q0)
        assert got == np.float32(x / c), (x, c)


# --- the walk -----------------------------------------------------------------

def _walk(q, k_i8, ks, v_i8, vs, offsets, kw, fault=None):
    """The int8-P kernel's algorithm block by block, (o, lse); `fault`
    plants the analogue of one of its PLANTED_FAULTS lines. At d <= 128 one
    consumer takes every key of a tile and every column of O; at d=256 two:
    consumer c keys 32c..32c+31 of each tile (its masks taken over them)
    and O's columns 128c.., their row maxes exchanged once a quant block,
    each consumer's share of l added at the end."""
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
    halves = [(0, BK)] if D <= 128 else [(0, 32), (32, 32)]  # a consumer's keys of a tile
    nc = len(halves)
    cols = [slice(D // nc * c, D // nc * (c + 1)) for c in range(nc)]  # its columns of O

    def scores(Q, kt):
        """S of an item; at d=256 the planted fault's k32 steps 4-7 read the
        first 128-byte halves of Q and K again."""
        if fault == "s_half" and D == 256:
            return 2 * (Q[:, :128] @ kt[:, :128].T)
        return Q @ kt.T

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

                def warp_mask(w, h0, h1, width, unmasked_lo=None):
                    """(runs, keep [16, width]) of warp w on a consumer's keys
                    h0..h0 + width - 1, of which [h0, h1) are present."""
                    wq0 = q_off + q0 + 16 * w
                    if not block_should_run(kw["causal"], kw["window"], kw["sinks"], wq0,
                                            wq0 + 15, kv_off + h0, kv_off + h1 - 1):
                        return False, None
                    kloc = h0 + torch.arange(width)
                    lo = wq0 if unmasked_lo is None else unmasked_lo
                    if h1 - h0 == width and bf16p_tiles._range_unmasked(
                            kw, lo, wq0 + 15, kv_off + h0, kv_off + h1 - 1, h1 - 1, mask_tail):
                        return True, torch.ones(16, width, dtype=torch.bool)
                    r = slice(16 * w, 16 * w + 16)
                    keep = bf16p_tiles._pair_valid(kw, qpos[r], kv_off + kloc, kloc, mask_tail)
                    if fault != "tail_kept":
                        keep &= (kloc < h1)[None, :]
                    return True, keep

                def parts(t0, tend):
                    """(consumer, its first key in the tile, width, h0, h1) of
                    the consumers with keys of the tile."""
                    return [(c, off, width, t0 + off, min(t0 + off + width, tend))
                            for c, (off, width) in enumerate(halves) if t0 + off < tend]

                exp_order = [(kb1, t0) for _, kb1, tiles in items for t0 in tiles]
                item = 0
                m = torch.full((nc, ROWS), float("-inf"))
                l = torch.zeros(nc, ROWS)
                acc = torch.zeros(ROWS, D)
                for j, kb1, tiles in items:
                    if not tiles:
                        continue
                    kss = float(ks[b, h // G, j]) * kw["sm_scale"]
                    vj = min(j + 1, nkv - 1) if fault == "vsc_next" else j
                    vsc = float(vs[b, h // G, vj])
                    f = f32(sq_r.double() * kss)
                    # Sweep 1, each consumer over its keys.
                    imax = torch.full((nc, ROWS), -2**31, dtype=torch.int64)
                    any_masked = torch.zeros(nc, ROWS, dtype=torch.bool)
                    for t0 in tiles:
                        tend = min(t0 + BK, kb1)
                        S = scores(Q, tile_of(t0, kb1)[0])
                        for c, off, width, h0, h1 in parts(t0, tend):
                            kloc = h0 + torch.arange(width)
                            for w in range(ROWS // 16):
                                r = slice(16 * w, 16 * w + 16)
                                runs, keep = warp_mask(w, h0, h1, width)
                                if not runs:
                                    any_masked[c, r] = True
                                    continue
                                present = (kloc < h1)[None, :]
                                any_masked[c, r] |= (present & ~keep).any(dim=1)
                                s = torch.where(keep & present, S[r, off:off + width],
                                                torch.full((16, width), -2**31))
                                imax[c, r] = torch.maximum(imax[c, r], s.amax(dim=1))
                    if fault != "max_unshared":  # the exchange: both fold with one m
                        imax = imax.amax(dim=0, keepdim=True).expand(nc, ROWS)
                        any_masked = any_masked.any(dim=0, keepdim=True).expand(nc, ROWS)
                    seen = imax != -2**31
                    mc = torch.where(any_masked, torch.tensor(DEFAULT_MASK_VALUE),
                                     torch.tensor(float("-inf")))
                    dq = f32(imax.double() * f.double())
                    if kw["softcap"] is not None:
                        dq = kw["softcap"] * torch.tanh(dq / kw["softcap"])
                    m_next = torch.maximum(m, torch.where(seen, dq, mc))
                    alpha = torch.where(m_next == float("-inf"), torch.ones(()),
                                        torch.exp(m - m_next))
                    shift = m_next - math.log(127.0)
                    f2 = f32(f.double() * LOG2E)
                    shift2 = f32(shift.double() * LOG2E)
                    # Sweep 2.
                    pvi = torch.zeros(ROWS, D, dtype=torch.int64)
                    lsum = torch.zeros(nc, ROWS)
                    for t0 in tiles:
                        tend = min(t0 + BK, kb1)
                        kt, vt = tile_of(t0, kb1)
                        if fault == "stale_stage":  # K and V of the exp item before
                            kt, vt = (tile_of(exp_order[item - 1][1], exp_order[item - 1][0])
                                      if item > 0 else (torch.zeros_like(kt), torch.zeros_like(vt)))
                        item += 1
                        S = scores(Q, kt)
                        P = torch.zeros(ROWS, BK)
                        for c, off, width, h0, h1 in parts(t0, tend):
                            for w in range(ROWS // 16):
                                r = slice(16 * w, 16 * w + 16)
                                lo = q_off + q0 + 16 * w + 15 if fault == "unmasked_from_last_row" else None
                                runs, keep = warp_mask(w, h0, h1, width, lo)
                                if not runs:
                                    continue
                                Sc = S[r, off:off + width].double()
                                if kw["softcap"] is not None:
                                    x = f32(Sc * f[r, None].double())
                                    x = kw["softcap"] * torch.tanh(x / kw["softcap"])
                                    pe = torch.exp(x - shift[c, r, None])
                                else:
                                    pe = torch.exp2(f32(Sc * f2[r, None].double()
                                                        - shift2[c, r, None].double()))
                                P[r, off:off + width] = torch.where(keep, pe, torch.zeros_like(pe))
                        P8 = torch.from_numpy(_round_p(P.numpy(), fault))
                        for c, (off, width) in enumerate(halves):
                            lsum[c] += (P8.float() if fault == "l_rounded" else P)[
                                :, off:off + width].sum(dim=1)
                        if fault == "p_half_stale" and D == 256:  # consumer 1's bytes never written
                            P8[:, 32:] = 0
                        pvi += P8 @ vt
                        if fault == "pv_half" and D == 256:  # O's columns 128-255 from V's 0-127
                            pvi[:, 128:] += P8 @ (vt[:, :128] - vt[:, 128:])
                        if fault == "pv_swapped" and D == 256:  # each half from the other's V
                            pvi = pvi - P8 @ vt + P8 @ torch.cat([vt[:, 128:], vt[:, :128]], 1)
                    a_acc = torch.zeros(ROWS, D)
                    for c in range(nc):
                        a_acc[:, cols[c]] = alpha[c][:, None]
                    if fault == "no_alpha":
                        a_acc[:] = 1.0
                    if fault == "wide_no_alpha" and D == 256:  # rows g, columns 2t: not rescaled
                        rows_g = (torch.arange(ROWS) % 16 < 8)[:, None]
                        even = (torch.arange(D) % 2 == 0)[None, :]
                        a_acc = torch.where(rows_g & even, torch.ones(()), a_acc)
                    acc = acc * a_acc + pvi.float() * vsc
                    l = alpha * l + lsum
                    m = m_next
                # Each consumer's l: its own share and the other's (the
                # planted fault: its own alone); lse from consumer 0's.
                lc = l if fault == "l_other_dropped" else l.sum(dim=0, keepdim=True).expand(nc, ROWS)
                out = torch.zeros(ROWS, D)
                for c in range(nc):
                    l_inv = torch.where(lc[c] == 0, torch.ones(()), 1.0 / lc[c])
                    out[:, cols[c]] = acc[:, cols[c]] * l_inv[:, None]
                o[b, h, rows[exists]] = out[exists].to(q.dtype)
                lse[b, h, rows[exists]] = torch.where(
                    lc[0] > 0, m[0] + torch.log(lc[0]) - ln_p,
                    torch.full_like(lc[0], float("-inf")))[exists]
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
    assert {c[6] for c in cases} == {32, 64, 128, 256}
    assert {c[13] for c in cases} == {False, True}
    # d=256's two consumers: rows whose block max lies in keys 32-63 of the
    # tiles, a window under a tile (one half of it seen, the other not),
    # kv_len inside a tile's first half.
    d256 = [c for c in cases if c[6] == 256]
    assert any(len(c) > 15 and c[15] < 1 for c in d256)
    assert any(c[9] is not None and c[9] < BK and not c[10] for c in d256)
    assert any(c[5] < c[4] and 0 < c[5] % BK < 32 for c in d256)


def test_coverage_max_lies_in_the_second_key_halves():
    """The d=256 case with K's keys 0-31 of each tile scaled down: the
    block max of nearly every row that sees a key 32-63 of some tile lies
    in such a key, so that the first consumer's own max is not the row's."""
    (i, case), = [(i, c) for i, c in INT8P_CASES.items() if len(c) > 15]
    q, k_i8, ks, v_i8, vs, offsets, kw = bf16p_tiles._inputs(case, seed=300 + i)
    B, H, Sq, D = q.shape
    G, Skv, bkv = H // k_i8.shape[1], k_i8.shape[2], kw["block_kv"]
    qf = q.float()
    sq = tfa.true_div(torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=kw["scale_clamp"]),
                      127.0)
    q_int = torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int64)
    kloc = torch.arange(Skv)
    second = kloc % BK >= 32
    hits = total = 0
    for b in range(B):
        qpos = int(offsets[b, 0]) + torch.arange(Sq)
        valid = bf16p_tiles._pair_valid(kw, qpos, kloc + int(offsets[b, 1]), kloc, False)
        for h in range(H):
            S = q_int[b, h] @ k_i8[b, h // G].to(torch.int64).T
            for kb0 in range(0, Skv, bkv):
                blk = slice(kb0, kb0 + bkv)
                vis = valid[:, blk]
                rows = (vis & second[None, blk]).any(dim=1)
                s = torch.where(vis, S[:, blk], torch.full_like(S[:, blk], -2**40))
                at = s.argmax(dim=1) + kb0
                hits += int((second[at] & rows).sum())
                total += int(rows.sum())
    assert total > 1000 and hits >= 0.98 * total


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
FAULTS_D256 = {
    "s_half": "d=256 int8 P: S's k32 steps 4-7 read the first 128-byte halves of Q and K",
    "pv_half": "d=256 int8 P: P·V's second column half against Vᵀ's first (O's columns 128-255)",
    "pv_swapped": "d=256 int8 P: each consumer's P·V against the other's V columns",
    "wide_no_alpha": "d=256 int8 P: acc in registers not rescaled by alpha (rows g, even columns)",
    "p_half_stale": "d=256 int8 P: the second consumer's P half never written (stale bytes)",
    "max_unshared": "d=256 int8 P: the row-max exchange skipped (each consumer its own keys' max)",
    "l_other_dropped": "d=256 int8 P: the other consumer's share of l not added at the end",
}
LAYOUT_FAULTS = {"vt_shift", "p_trunc"}
LAYOUT_FAULTS_D256 = {"pv_half", "pv_swapped", "p_half_stale"}
# Causal GQA, d=64, quant blocks of 96 keys (tiles clipped at each block's
# end) and a second sequence whose first 40 rows see no key.
FAULT_CASE = (2, 4, 2, 100, 288, 288, 64, 96, True, None, 0, None, 0, False,
              ((150, 0), (0, 40)))
# d=256: causal GQA 2 over two quant blocks of 128 keys (alpha moves), a
# partial second q tile.
FAULT_CASE_D256 = (1, 4, 2, 100, 256, 256, 256, 128, True, None, 0, None, 0, False, None)


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


@pytest.mark.parametrize("fault", sorted(FAULTS_D256))
def test_planted_d256_fault_analogues_break_the_layout_or_the_walk(fault):
    assert any(f[0] == "flash_int8_fwd.cu" and f[1] == FAULTS_D256[fault]
               for f in chip_smoke.PLANTED_FAULTS)
    rng = np.random.default_rng(9)
    if fault == "s_half":
        Q, K = rng.integers(-127, 128, (2, 64, 256))
        assert not np.array_equal(_s_product(Q, K, fault), Q @ K.T)
    if fault in LAYOUT_FAULTS_D256:
        pe, v = _layout_inputs(256, seed=6)
        assert not np.array_equal(_pv_product(pe, v, fault), _pv_product(pe, v))
    inputs = bf16p_tiles._inputs(FAULT_CASE_D256, seed=8)
    o, lse, tol, lse_tol = bf16p_tiles._plain(*inputs)
    wo, wlse = _walk(*inputs)
    assert max(chip_smoke.err_over_tol(wo, o, tol), chip_smoke.err_over_tol(wlse, lse, lse_tol)) <= 1.0
    fo, flse = _walk(*inputs, fault=fault)
    assert max(chip_smoke.err_over_tol(fo, o, tol), chip_smoke.err_over_tol(flse, lse, lse_tol)) > 1.0


def test_every_planted_fault_has_an_analogue():
    lines = [f[1] for f in chip_smoke.PLANTED_FAULTS if f[0] == "flash_int8_fwd.cu"
             and f[1].startswith(("int8 P:", "d=256 int8 P:"))]
    assert sorted(lines) == sorted([*FAULTS.values(), *FAULTS_D256.values()])
