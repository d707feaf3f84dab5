"""The INT8 flash forward's bf16-P routes (csrc/flash_int8_fwd.cu
MODE_BF16_P and MODE_BF16_P_F32L, TPU kernels 2 and, with bf16 P, 1) on the
CPU: their edge cases against JAX, their walk emulated, and the d=256 P
tile's layout.

The CUDA kernel holds 128 q rows a block (two consumers of 64, warps of
16) and walks, per quant block, the 64-key tiles of it that some row of
the block sees (the last one clipped at the block's end), twice: a max
sweep on the int32 scores, then an exp sweep that recomputes S, takes
P' = 2^(fma(s, f·log2 e, −shift·log2 e)) with s converted to f32 by a
magic number, rounds P' to bf16 and sums P'·V per quant block, folded in
at the block's end as acc·α + pv·vsc. l: MODE_BF16_P sums the bf16 P' on
the tensor cores (the ones column of [V | 1]); MODE_BF16_P_F32L sums the
f32 P' on the CUDA cores, lane t of a quad the keys 8j + 2t and 8j + 2t +
1 of each n8 tile, the quad's sums added at the block's end. At d=256 a
block holds 64 rows, which both consumers share: consumer c takes keys
32c..32c+31 of every tile (S from the two 128-byte halves of Q and K, its
masks, its row max, exchanged with the other's once a quant block, and
its share of l: MODE_BF16_P a ones product over its bf16 P', MODE_BF16_P_F32L
its lanes' f32 P'; the shares added at the end) and O's columns 128c..:
both write their bf16 P' into a P tile, from which each one's P·V reads
all 64 keys against V's two 64-column blocks of its half. Here:

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
  within the same tolerance on those cases, and on the cases that hold the
  d=256 instances and MODE_BF16_P_F32L (NEW_MODE_CASES) and on
  chip_smoke.FLASH_ONE_SIDED's; on the d=256 cases that tell the two
  consumers' key halves apart, the walk and JAX (summode "mxu" or "vpu"
  by the mode) against the plain version.
- The d=256 P tile: both consumers' words written into it and read back
  through the K-major A descriptor of each k16 step, against V's column
  half through the MN-major B descriptor, give bf16(P') @ V.
- The magic-number conversion equals float(s) for every |s| <= 128·127².
- Each planted fault of the kernel in chip_smoke.PLANTED_FAULTS as a switch
  of `_walk` (or of the layout): each must miss the tolerance by more than
  5x.
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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention_int8")

BK = 64      # the kernel's key tile
ROWS = 128   # q rows of a block
LOG2E = 1.4426950408889634
NEW_CASES = {i: c for i, c in enumerate(chip_smoke.FLASH_COVERAGE)
             if i >= 9 and c[12] == 1 and c[6] <= 128}
# MODE_BF16_P at d=256 and MODE_BF16_P_F32L at every head dim.
NEW_MODE_CASES = {i: c for i, c in enumerate(chip_smoke.FLASH_COVERAGE)
                  if c[12] == 2 or (c[12] == 1 and c[6] == 256)}


def _inputs(case, seed):
    """(q, k_i8, k_scales, v_i8, v_scales, offsets, kw) of a coverage case
    from numpy; kw holds the plain version's keywords."""
    (B, H, Hkv, Sq, Skv, kv_len, D, bkv, causal, window, sinks, cap, mode, bf16,
     offs, *k_lo) = case
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 2.0, (B, H, Sq, D)).astype(np.float32)
    k, v = rng.normal(0, 1.0, (2, B, Hkv, Skv, D)).astype(np.float32)
    if k_lo:  # K's keys 0-31 of every 64-key tile scaled (chip_smoke.flash_coverage_inputs)
        k[..., np.arange(Skv) % 64 < 32, :] *= np.float32(k_lo[0])
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
    """JAX's transposed INT8 route (bf16 P; l over the bf16 P', summode
    mxu, or in mode 2 over the f32 P', summode vpu) with lse, one sequence
    at a time."""
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
            attention_sinks=kw["sinks"], summode="vpu" if kw["mode"] == 2 else "mxu")
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


def _lane_of_key(n):
    """Lane t of a quad whose S accumulator holds key j of a tile (keys
    8c + 2t and 8c + 2t + 1 of n8 tile c), for keys 0..n-1."""
    return (torch.arange(n) % 8) // 2


def _walk(q, k_i8, ks, v_i8, vs, offsets, kw, fault=None):
    """The bf16-P kernel's algorithm block by block, (o, lse), in the mode
    kw names; `fault` plants the analogue of one of its PLANTED_FAULTS
    lines. At d <= 128 a block holds 128 rows and one consumer takes every
    key of a tile and every column of O for its 64 of them. At d=256 two
    consumers share the block's 64 rows: consumer c takes keys 32c..32c+31
    of each tile (its masks taken over them) and O's columns 128c..; their
    row maxes are exchanged once a quant block; both halves of P', rounded
    to bf16, go into the P tile that each consumer's P·V reads against V's
    column half; each consumer keeps its share of l (MODE_BF16_P: its ones
    product over its bf16 P'; MODE_BF16_P_F32L: its lanes' f32 P'), the
    two added at the end. l is kept per consumer and per lane of the quad
    ([consumers, rows, 4]): the same in every lane but where the quad sum
    misses one."""
    B, H, Sq, D = q.shape
    wide = D == 256
    ROWS = 64 if wide else 128  # q rows of a block
    halves = [(0, 32), (32, 32)] if wide else [(0, BK)]  # a consumer's keys of a tile
    nc = len(halves)
    cols = [slice(D // nc * c, D // nc * (c + 1)) for c in range(nc)]  # its columns of O
    f32l = kw["mode"] == 2
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
    lane = _lane_of_key(BK)
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
                m = torch.full((nc, ROWS), float("-inf"))
                l = torch.zeros(nc, ROWS, 4)
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

                def parts(t0, tend):
                    """(consumer, its first key in the tile, width, h0, h1) of
                    the consumers with keys of the tile ([h0, h1) present)."""
                    return [(c, off, width, t0 + off, min(t0 + off + width, tend))
                            for c, (off, width) in enumerate(halves) if t0 + off < tend]

                def warp_sees(w, h0, h1):
                    wq0 = q_off + q0 + 16 * w
                    return block_should_run(kw["causal"], kw["window"], kw["sinks"], wq0,
                                            wq0 + 15, kv_off + h0, kv_off + h1 - 1)

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
                    # Sweep 1, each consumer over its keys.
                    imax = torch.full((nc, ROWS), -2**31, dtype=torch.int64)
                    any_masked = torch.zeros(nc, ROWS, dtype=torch.bool)
                    for t0 in tiles:
                        S = Q @ tile_of(t0, kb1)[0].T
                        for c, off, width, h0, h1 in parts(t0, min(t0 + BK, kb1)):
                            kloc = h0 + torch.arange(width)
                            for w in range(ROWS // 16):
                                r = slice(16 * w, 16 * w + 16)
                                wq0 = q_off + q0 + 16 * w
                                if not warp_sees(w, h0, h1):
                                    any_masked[c, r] = True
                                    continue
                                ok = (kloc < h1)[None, :].expand(16, width).clone()
                                if not (h1 - h0 == width and _range_unmasked(
                                        kw, wq0, wq0 + 15, kv_off + h0, kv_off + h1 - 1, h1 - 1,
                                        mask_tail)):
                                    valid = _pair_valid(kw, qpos[r], kv_off + kloc, kloc, mask_tail)
                                    any_masked[c, r] |= (ok & ~valid).any(dim=1)
                                    ok &= valid
                                s = torch.where(ok, S[r, off:off + width],
                                                torch.full((16, width), -2**31))
                                imax[c, r] = torch.maximum(imax[c, r], s.amax(dim=1))
                    if fault != "max_unshared":  # the exchange: both fold with one m
                        imax = imax.amax(dim=0, keepdim=True).expand(nc, ROWS)
                        any_masked = any_masked.any(dim=0, keepdim=True).expand(nc, ROWS)
                    mc = torch.where(any_masked, torch.tensor(DEFAULT_MASK_VALUE),
                                     torch.tensor(float("-inf")))
                    seen = imax != -2**31
                    dq = _f32(imax.double() * f.double())
                    if kw["softcap"] is not None:
                        dq = kw["softcap"] * torch.tanh(dq / kw["softcap"])
                    mc = torch.where(seen, dq, mc)
                    m_next = torch.maximum(m, mc)
                    alpha = torch.where(m_next == float("-inf"), torch.ones(()),
                                        torch.exp(m - m_next))
                    shift = m_next - ln_p
                    f2 = _f32(f.double() * LOG2E)
                    shift2 = _f32(shift.double() * LOG2E)
                    # Sweep 2.
                    pv = torch.zeros(ROWS, D)
                    pv_ones = torch.zeros(nc, ROWS)
                    l_lane = torch.zeros(nc, ROWS, 4)  # F32L: each lane's sum of the f32 P'
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
                        elif wide:  # k32 steps 0-3 from the first halves, 4-7 the second
                            S = Q[:, :128] @ kt[:, :128].T + Q[:, 128:] @ kt[:, 128:].T
                        else:
                            S = Q @ kt.T
                        P = torch.zeros(ROWS, BK)
                        for c, off, width, h0, h1 in parts(t0, tend):
                            kloc = h0 + torch.arange(width)
                            for w in range(ROWS // 16):
                                r = slice(16 * w, 16 * w + 16)
                                wq0 = q_off + q0 + 16 * w
                                if not warp_sees(w, h0, h1):
                                    continue
                                lo = wq0 + 15 if fault == "unmasked_from_last_row" else wq0
                                unmasked = h1 - h0 == width and _range_unmasked(
                                    kw, lo, wq0 + 15, kv_off + h0, kv_off + h1 - 1, h1 - 1,
                                    mask_tail)
                                Sc = S[r, off:off + width]
                                if kw["softcap"] is not None:
                                    x = _f32(Sc.double() * f[r, None].double())
                                    x = kw["softcap"] * torch.tanh(x / kw["softcap"])
                                    pe = torch.exp(x - shift[c, r, None])
                                else:
                                    s = _s32_to_f32(Sc, fault)
                                    arg = _f32(s.double() * f2[r, None].double()
                                               - shift2[c, r, None].double())
                                    pe = torch.exp2(arg)
                                if not unmasked:
                                    keep = _pair_valid(kw, qpos[r], kv_off + kloc, kloc, mask_tail)
                                    if fault != "tail_kept":
                                        keep &= (kloc < h1)[None, :]
                                    pe = torch.where(keep, pe, torch.zeros_like(pe))
                                P[r, off:off + width] = pe
                        Pb = P.to(torch.bfloat16).float()
                        if wide:  # the P tile against V's 64-column blocks 2c and 2c + 1
                            Pt = Pb.clone()
                            if fault == "p_half_stale":  # consumer 1's words never written
                                Pt[:, 32:] = 0.0
                            for c in range(nc):
                                first = 128 * c
                                if fault == "pv_half" and c == 1:
                                    first = 0
                                elif fault == "pv_swapped":
                                    first = 128 * (1 - c)
                                pv[:, cols[c]] += Pt @ vt[:, first:first + 128]
                        else:
                            pv += Pb @ vt
                        for c, (off, width) in enumerate(halves):
                            keys = slice(off, off + width)
                            if f32l:
                                summed = (Pb if fault == "l_bf16" else P)[:, keys]
                                for t in range(4):
                                    l_lane[c, :, t] += summed[:, lane[keys] == t].sum(dim=1)
                            elif fault == "ones_last_k16":  # its second k16 step dropped
                                pv_ones[c] += Pb[:, off:off + 16].sum(dim=1)
                            elif fault != "ones_dropped":
                                pv_ones[c] += Pb[:, keys].sum(dim=1)
                    a_acc = torch.zeros(ROWS, D)
                    for c in range(nc):
                        a_acc[:, cols[c]] = alpha[c][:, None]
                    if fault == "no_rescale":  # rows g of each warp keep acc unscaled
                        a_acc[(torch.arange(ROWS) % 16) < 8] = 1.0
                    if fault == "wide_no_alpha" and wide:  # rows g, even columns: unscaled
                        rows_g = (torch.arange(ROWS) % 16 < 8)[:, None]
                        even = (torch.arange(D) % 2 == 0)[None, :]
                        a_acc = torch.where(rows_g & even, torch.ones(()), a_acc)
                    acc = acc * a_acc + pv * vsc
                    if f32l:  # lane t's quad sum (the fault's misses lane t ^ 3)
                        lb = l_lane.sum(dim=2, keepdim=True).expand(nc, ROWS, 4)
                        if fault == "quad_lane" and not wide:
                            lb = lb - l_lane[:, :, [3, 2, 1, 0]]
                    else:
                        lb = pv_ones[:, :, None].expand(nc, ROWS, 4)
                    l = alpha[:, :, None] * l + lb
                    m = m_next
                # Each consumer's l: its own share and the other's (the planted
                # fault: its own alone). Column c of o is lane (c % 8) // 2's;
                # lse is consumer 0's lane 0's.
                lc = l if fault == "l_other_dropped" else l.sum(dim=0, keepdim=True).expand(
                    nc, ROWS, 4)
                out = torch.zeros(ROWS, D)
                for c in range(nc):
                    l_inv = torch.where(lc[c] == 0, torch.ones(()), 1.0 / lc[c])
                    out[:, cols[c]] = acc[:, cols[c]] * l_inv[:, _lane_of_key(D)[cols[c]]]
                o[b, h, rows[exists]] = out[exists].to(q.dtype)
                l0 = lc[0, :, 0]
                lse[b, h, rows[exists]] = torch.where(
                    l0 > 0, m[0] + torch.log(l0) - ln_p, torch.full_like(l0, float("-inf")))[exists]
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


# A d=256 MODE_BF16_P case, a d=256 and a d=64 MODE_BF16_P_F32L case (GQA
# with offsets per sequence, softcap, window + sinks between them), and
# the one-sided cases at d=32.
WALK_MODE_CASES = [min(i for i, c in NEW_MODE_CASES.items() if c[12] == 1),
                   min(i for i, c in NEW_MODE_CASES.items() if c[12] == 2),
                   min(i for i, c in NEW_MODE_CASES.items() if c[12] == 2 and c[6] == 64)]
ONE_SIDED_SMALL = [c[:3] + (512,) + c[4:] for c in chip_smoke.FLASH_ONE_SIDED if c[4] == 32]


@pytest.mark.parametrize("i", WALK_MODE_CASES, ids=lambda i: f"fa8_{i}")
def test_walk_matches_plain_on_new_modes(i):
    """The walk of MODE_BF16_P at d=256 and of MODE_BF16_P_F32L, against
    the plain version in the case's mode."""
    inputs = _inputs(NEW_MODE_CASES[i], seed=300 + i)
    o, lse, tol, lse_tol = _plain(*inputs)
    wo, wlse = _walk(*inputs)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0


@pytest.mark.parametrize("case", ONE_SIDED_SMALL, ids=lambda c: f"mode{c[-1]}")
def test_walk_holds_the_one_sided_cases(case):
    """On a one-sided case (chip_smoke.one_sided_inputs, 512 keys), the
    walk in the case's mode meets its plain version's tolerance and the
    walk in the other bf16-P mode misses it by more than 10x."""
    *operands, kw = chip_smoke.one_sided_inputs(case, "cpu")
    kw = {k: x for k, x in kw.items() if k != "save_residuals"}
    o, lse, tol, lse_tol = _plain(*operands, kw)
    wo, wlse = _walk(*operands, kw)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0
    other, _ = _walk(*operands, dict(kw, mode=3 - kw["mode"]))
    assert chip_smoke.err_over_tol(other, o, tol) > 10.0


@pytest.mark.parametrize("i", sorted(NEW_CASES), ids=lambda i: f"fa8_{i}")
def test_walk_matches_plain(i):
    inputs = _inputs(NEW_CASES[i], seed=200 + i)
    o, lse, tol, lse_tol = _plain(*inputs)
    wo, wlse = _walk(*inputs)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0


# The d=256 cases that tell the two consumers' key halves apart (K's keys
# 0-31 of each tile at a quarter in both modes, a 40-key window, kv_len
# inside a tile's first half).
KEY_HALF_CASES = {i: c for i, c in NEW_MODE_CASES.items()
                  if c[6] == 256 and (len(c) > 15 or c[9] == 40 or 0 < c[5] % BK < 32)}


@pytest.mark.parametrize("i", sorted(KEY_HALF_CASES), ids=lambda i: f"fa8_{i}")
def test_walk_and_jax_hold_the_key_half_cases(i):
    """The two-consumer walk and JAX (summode by the case's mode) against
    the plain version, on the cases that tell the d=256 consumers' key
    halves apart."""
    inputs = _inputs(KEY_HALF_CASES[i], seed=300 + i)
    o, lse, tol, lse_tol = _plain(*inputs)
    wo, wlse = _walk(*inputs)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0
    jo, jlse = _jax(*inputs)
    keep = ~_tie_rows(inputs[0])
    assert keep.float().mean() > 0.98
    assert chip_smoke.err_over_tol(jo[keep], o[keep], tol.expand_as(o)[keep]) <= 1.0
    assert chip_smoke.err_over_tol(jlse[keep], lse[keep], lse_tol[keep]) <= 1.0


def test_key_half_cases_reach_the_split_edges():
    """Modes 1 and 2 with the rows' maxes in keys 32-63 of their tiles
    (softcap; nearly every row that sees such a key has its block max
    there, so that consumer 0's own max is not the row's), a window under
    a tile (one half of it seen, the other not) and kv_len inside a tile's
    first half."""
    cases = KEY_HALF_CASES
    assert len(cases) == 4
    k_lo = {i: c for i, c in cases.items() if len(c) > 15}
    assert {c[12] for c in k_lo.values()} == {1, 2} and all(c[11] for c in k_lo.values())
    assert any(c[9] is not None and c[9] < BK and not c[10] for c in cases.values())
    assert any(c[5] < c[4] and 0 < c[5] % BK < 32 for c in cases.values())
    for i, case in k_lo.items():
        q, k_i8, _, _, _, offsets, kw = _inputs(case, seed=300 + i)
        B, H, Sq, D = q.shape
        G, Skv, bkv = H // k_i8.shape[1], k_i8.shape[2], kw["block_kv"]
        qf = q.float()
        sq = tfa.true_div(torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-8), 127.0)
        q_int = torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int64)
        kloc = torch.arange(Skv)
        second = kloc % BK >= 32
        qpos = int(offsets[0, 0]) + torch.arange(Sq)
        valid = _pair_valid(kw, qpos, kloc + int(offsets[0, 1]), kloc, False)
        hits = total = 0
        for h in range(H):
            S = q_int[0, h] @ k_i8[0, h // G].to(torch.int64).T
            for kb0 in range(0, Skv, bkv):
                blk = slice(kb0, kb0 + bkv)
                vis = valid[:, blk]
                rows = (vis & second[None, blk]).any(dim=1)
                at = torch.where(vis, S[:, blk], torch.full_like(S[:, blk], -2**40)).argmax(1)
                hits += int((second[at + kb0] & rows).sum())
                total += int(rows.sum())
        assert total > 1000 and hits >= 0.98 * total


def _sw(r, c):
    """sw of mma_bf16.cuh: the element offset of 16-byte chunk c of row r
    in a bf16 tile of 64-column blocks with the 128-byte swizzle."""
    return (c >> 3) * (64 * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3)


def _p_tile(pb_vals, buf, fault=None):
    """Buffer `buf` of the d=256 P tile (two bf16 tiles of 64 rows x 64
    keys) after both consumers wrote an exp item's bf16 P': consumer c's
    thread (w, 4g + t) writes its word a[kk][2hh + r], the keys 32c + 16kk
    + 8hh + 2t and + 1 of row 16w + g + 8r, at element 2t of chunk 4c + 2kk
    + hh (the planted fault: consumer 1 writes nothing, its words stale,
    zero here)."""
    tile = np.zeros(2 * 64 * 64)
    for c in range(2):
        if fault == "p_half_stale" and c == 1:
            continue
        for w, lane, kk, hh, r in np.ndindex(4, 32, 2, 2, 2):
            g, t = lane >> 2, lane & 3
            row, key = 16 * w + g + 8 * r, 32 * c + 16 * kk + 8 * hh + 2 * t
            at = buf * 64 * 64 + _sw(row, 4 * c + 2 * kk + hh) + 2 * t
            tile[at:at + 2] = pb_vals[row, key:key + 2]
    return tile


def _v_tile(v):
    """The producer's bf16 V tile: key r's columns 8c..8c+7 at chunk c."""
    tile = np.zeros(64 * v.shape[1])
    for r in range(64):
        for c in range(v.shape[1] // 8):
            tile[_sw(r, c):_sw(r, c) + 8] = v[r, 8 * c:8 * c + 8]
    return tile


def _desc_k_major(tile, start, rows=64, k=16):
    """The K-major operand (64 rows x 16 k) that a 128-byte-swizzled
    descriptor at element `start` (1024-byte-aligned base) names: row r's
    k16 slice from 128-byte row r, its 16-byte chunks XORed with r % 8."""
    r, e = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    base, off = start - start % 512, start % 512  # (a k16 step's 32 bytes within the atom's row)
    chunk = (off // 8 + e // 8) ^ (r % 8)
    return tile[base + (r // 8) * 512 + (r % 8) * 64 + chunk * 8 + e % 8]


def _desc_mn_major(tile, start, n=128, k=16, lbo=64 * 64):
    """The MN-major B operand (16 k x n) that a 128-byte-swizzled
    descriptor at element `start` (an 8-row atom) names: k row kr of the
    64-column block n // 64 at `lbo` elements per block, its 16-byte
    chunks XORed with kr % 8."""
    kr, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    chunk = ((nn % 64) // 8) ^ (kr % 8)
    return tile[start + (nn // 64) * lbo + kr * 64 + chunk * 8 + nn % 8]


def _p_tile_pv(pe, v, fault=None, buf=0):
    """One exp item's P·V at d=256 as the two consumers issue it: consumer
    c's four k16 steps, A through tile_desc(P tile buffer, 0, kk), B
    through tile_desc_mn(V's blocks 2c.., 16kk) (the planted faults:
    consumer 1 against blocks 0-1, or each against the other's)."""
    pb_vals = torch.from_numpy(pe).to(torch.bfloat16).double().numpy()
    pt, vt = _p_tile(pb_vals, buf, fault), _v_tile(v)
    out = np.zeros((64, 256))
    for c in range(2):
        block = 2 * c
        if fault == "pv_half" and c == 1:
            block = 0
        elif fault == "pv_swapped":
            block = 2 * (1 - c)
        for kk in range(4):
            a = _desc_k_major(pt, buf * 64 * 64 + 16 * kk)
            b = _desc_mn_major(vt, block * 64 * 64 + 16 * kk * 64)
            out[:, 128 * c:128 * c + 128] += a @ b
    return out


def _layout_inputs(seed):
    rng = np.random.default_rng(seed)
    pe = rng.uniform(0, 127.0, (64, 64)).astype(np.float32)
    pe[::3, 1::4] = 0.0  # masked pairs
    v = rng.integers(-127, 128, (64, 256)).astype(np.float64)
    return pe, v


@pytest.mark.parametrize("buf", [0, 1])
def test_p_tile_against_v_half_is_bf16_p_times_v(buf):
    """Both consumers' bf16 P' through either buffer of the P tile, each
    consumer's P·V against V's column half: bf16(P') @ V exactly (bf16 x
    int8 products and their sums of 64 are exact in float64)."""
    pe, v = _layout_inputs(seed=3 + buf)
    want = torch.from_numpy(pe).to(torch.bfloat16).double().numpy() @ v
    np.testing.assert_array_equal(_p_tile_pv(pe, v, buf=buf), want)


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


# The faults of the d=256 instances and of MODE_BF16_P_F32L, each at a case
# of its own: (PLANTED_FAULTS line, case). The f32-l sum over the bf16 P'
# moves l by under one bf16 ulp of P' a key, so only a one-sided case shows
# it.
D256_CASE = (1, 2, 1, 70, 192, 192, 256, 96, True, None, 0, None, 1, False, None)
MODE_FAULTS = {
    "pv_half": ("d=256 bf16 P: P·V's second column half against V's first (O's columns 128-255)",
                D256_CASE),
    "pv_swapped": ("d=256 bf16 P: each consumer's P·V against the other's V columns", D256_CASE),
    "p_half_stale": ("d=256 bf16 P: the second consumer's P half never written (stale bytes)",
                     D256_CASE),
    "max_unshared": ("d=256 bf16 P: the row-max exchange skipped (each consumer its own keys' max)",
                     D256_CASE[:12] + (2, False, None, 0.25)),
    "l_other_dropped": ("d=256 bf16 P: the other consumer's share of l not added at the end",
                        D256_CASE[:12] + (2, False, None)),
    "wide_no_alpha": ("d=256 bf16 P: acc in registers not rescaled by alpha (rows g, even columns)",
                      D256_CASE),
    "ones_last_k16": ("d=256 bf16 P: the ones product (l) dropped for the last k16 step",
                      D256_CASE),
    "l_bf16": ("bf16 P, f32 l: l sums the bf16-rounded P', not the f32 P'", ONE_SIDED_SMALL[1]),
    "quad_lane": ("bf16 P, f32 l: the quad sum of l misses one lane (t ^ 3)",
                  (1, 2, 1, 70, 192, 192, 64, 96, True, None, 0, None, 2, False, None)),
}
# The d=256 faults that break the P tile's layout as well.
LAYOUT_FAULTS_D256 = {"pv_half", "pv_swapped", "p_half_stale"}


@pytest.mark.parametrize("fault", sorted(MODE_FAULTS))
def test_planted_mode_fault_analogues_miss_the_tolerance(fault):
    what, case = MODE_FAULTS[fault]
    line = [f for f in chip_smoke.PLANTED_FAULTS if f[1] == what]
    assert len(line) == 1 and (line[0][0] == "flash_int8_fwd.cu"
                               or "flash_int8_fwd" in line[0][4])
    if len(case) == 8:
        *operands, kw = chip_smoke.one_sided_inputs(case, "cpu")
        inputs = (*operands, {k: x for k, x in kw.items() if k != "save_residuals"})
    else:
        inputs = _inputs(case, seed=9)
    o, lse, tol, lse_tol = _plain(*inputs)
    wo, wlse = _walk(*inputs, fault=fault)
    worst = max(chip_smoke.err_over_tol(wo, o, tol), chip_smoke.err_over_tol(wlse, lse, lse_tol))
    # (a d=256 fault by 10x, as the faults phase holds it on the card)
    assert worst > (10.0 if what.startswith("d=256") else 5.0) or math.isinf(worst)
    if fault in LAYOUT_FAULTS_D256:
        pe, v = _layout_inputs(seed=4)
        assert not np.array_equal(_p_tile_pv(pe, v, fault=fault), _p_tile_pv(pe, v))


def test_every_planted_fault_has_an_analogue():
    lines = [f[1] for f in chip_smoke.PLANTED_FAULTS
             if f[0] in ("flash_int8_fwd.cu", "wgmma_s8.cuh") and f[1].startswith("bf16 P:")]
    assert sorted(lines) == sorted(FAULTS.values())
    mode_lines = [f[1] for f in chip_smoke.PLANTED_FAULTS
                  if (f[0] == "flash_int8_fwd.cu" and f[1].startswith(("d=256 bf16 P", "bf16 P,")))
                  or (f[0] != "flash_int8_fwd.cu" and "flash_int8_fwd" in (f[4:] or [()])[0])]
    assert sorted(mode_lines) == sorted(w for w, _ in MODE_FAULTS.values())
