"""The f32 flash forward's six bf16 passes (csrc/flash_fwd.cu, TPU kernel
5's f32 route) on the CPU: its pieces, its products, its walk emulated.

The CUDA kernel takes every f32 operand a as three bf16 pieces, a0 =
bf16(a), a1 = bf16(a − a0), a2 = bf16(a − a0 − a1) (the split pass for Q
scaled in f32, K and V; the consumers for P), and a product a·b as the six
bf16 products a0b0, a0b1, a1b0, a0b2, a1b1, a2b0, the small ones first, as
the TPU's Precision.HIGHEST does. Its blocks fold the GQA group into 192
rows at d=32, 128 at d=64 and 64 at d=128, and walk 64-key tiles (32 at
d=128). Here:

- the pieces add back to a exactly for 2^-110 <= |a| <= bf16's largest
  value, and within 2^-134 below (f32 subnormals included);
- the six products stay within 1.02·2^-24·sum_i |q_i||k_i| of the f64 dot;
- `_walk`, the kernel's algorithm in PyTorch (pieces, six products small
  first, p = 2^(x·log2 e − m·log2 e), P split into pieces, each tile's P·V
  summed from zero and added to acc), equal to the plain version within
  chip_smoke.flash_fwd_tolerances on the f32 FLASH_FWD_COVERAGE cases and
  on FLASH_FWD_PIECES;
- the plain version against JAX's f32 flash_attention (Pallas in interpret
  mode, Precision.HIGHEST) on the same cases;
- each planted fault of the f32 route in chip_smoke.PLANTED_FAULTS as a
  switch of `_walk`: the wrong residual, V's planes copied from K's, the
  split pass's unwritten edge (read as NaN, as chip_smoke poisons the
  planes) and the walk's faults (a stale stage, no rescale, the next q
  head's Q, a tile taken as mask-free from the warp's last row, a tile's
  P·V left out) miss the tolerance by more than 5x. A dropped third piece is at
  most 2^-17 of its value, while the tolerance must allow the plain
  version's f32 order (D·2^-24 of |q||k| for a score, 2^-20 of w_abs for
  P·V): on FLASH_FWD_PIECES, built for it, Q's, K's and V's miss by more
  than 2x, P's by more than 1.5x (the third piece of a p in (0.5, 1) is
  at most 2^-18 of it).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_flash_fwd_tiles as bf16_tiles
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RING = {32: (192, 64), 64: (128, 64), 128: (64, 32)}  # block rows, keys a tile
STAGES = 3  # the ring of K/V stages
ORDER = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))  # (piece of a, piece of b)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
F32_CASES = {i: c for i, c in enumerate(chip_smoke.FLASH_FWD_COVERAGE)
             if i >= chip_smoke.FIRST_F32_CASE}
BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def _split3(x, residual=True):
    """split3 of flash_fwd.cu: three bf16 pieces as f32 tensors; with
    residual=False the fault's a1 = bf16(a) − a0."""
    x0 = x.to(torch.bfloat16).float()
    r1 = x - x0 if residual else x0 - x0
    x1 = r1.to(torch.bfloat16).float()
    x2 = (r1 - x1).to(torch.bfloat16).float()
    return x0, x1, x2


def _f32_from_bits(rng, n, exp_lo, exp_hi):
    """n f32 values with uniform random mantissas and signs and biased
    exponents in [exp_lo, exp_hi] (0: subnormal)."""
    bits = (rng.integers(0, 2, n, dtype=np.uint32) << 31
            | rng.integers(exp_lo, exp_hi + 1, n).astype(np.uint32) << 23
            | rng.integers(0, 1 << 23, n, dtype=np.uint32))
    return torch.from_numpy(bits.view(np.float32).copy())


@pytest.mark.parametrize("kind", ["random", "tiny", "huge", "subnormal"])
def test_pieces_add_back(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        x = torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
    elif kind == "tiny":  # 2^-110 <= |x| < 2^-100
        x = _f32_from_bits(rng, 4096, 127 - 110, 127 - 101)
    elif kind == "huge":  # 2^100 <= |x| <= bf16's largest
        x = _f32_from_bits(rng, 4096, 127 + 100, 127 + 127)
        x = x.clamp(-BF16_MAX, BF16_MAX)
    else:  # f32 subnormals and the normals below 2^-110
        x = torch.cat([_f32_from_bits(rng, 2048, 0, 0), _f32_from_bits(rng, 2048, 1, 127 - 111)])
    x0, x1, x2 = _split3(x)
    total = x0.double() + x1.double() + x2.double()
    if kind == "subnormal":
        assert float((total - x.double()).abs().max()) <= 2.0**-134
    else:
        assert torch.equal(total, x.double())
        assert bool((x1.abs() <= 2.0**-8 * x0.abs()).all())
        assert bool((x2.abs() <= 2.0**-17 * x0.abs()).all())


@pytest.mark.parametrize("D", [32, 64, 128])
def test_six_products_within_bound_of_the_f64_dot(D):
    """Six products of the pieces, summed exactly (f64) and in f32 small
    first, against the f64 dot: the three left out are at most 1.02·2^-24
    of sum_i |q_i||k_i|; the f32 sum adds its own order, inside the
    tolerance's (9D/8 + 2)·2^-24."""
    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.normal(0, 1, (64, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (64, D)).astype(np.float32))
    qp, kp = _split3(q), _split3(k)
    exact = q.double() @ k.double().T
    l1 = q.double().abs() @ k.double().abs().T
    six = sum(qp[a].double() @ kp[b].double().T for a, b in ORDER)
    assert float(((six - exact).abs() / l1).max()) <= 1.02 * 2.0**-24
    s = torch.zeros(64, 64)
    for a, b in ORDER:
        s = s + qp[a] @ kp[b].T
    assert float(((s.double() - exact).abs() / l1).max()) <= (9 * D / 8 + 2) * 2.0**-24


def _six(a, b, order):
    """sum over order of a[i] @ b[j]ᵀ in f32, the small products first."""
    s = torch.zeros(a[0].shape[0], b[0].shape[0])
    for i, j in order:
        s = s + a[i] @ b[j].T
    return s


def _walk(q, k, v, offsets, masks, fault=None):
    """The f32 kernel's algorithm block by block, (o, lse); `fault` plants
    the analogue of one of its PLANTED_FAULTS lines."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    ROWS, TK = RING[D]
    GB = min(G, ROWS)
    NQ = ROWS // GB
    HC = -(-G // GB)
    residual = fault != "residual"
    qp = _split3(tfa.scaled_q(q, D**-0.5), residual)
    kp = _split3(k, residual)
    vp = _split3(k if fault == "k_as_v" else v, residual)
    if fault == "split_edge":  # V's last 32 plane values unwritten (NaN)
        vp = tuple(x.clone() for x in vp)
        for x in vp:
            x.view(-1)[-32:] = float("nan")
    s_order = [o for o in ORDER if not (fault == "q_third" and o == (2, 0))
               and not (fault == "k_third" and o == (0, 2))]
    pv_order = [o for o in ORDER if not (fault == "p_third" and o == (2, 0))
                and not (fault == "v_third" and o == (0, 2))]
    mask_value = tfa.DEFAULT_MASK_VALUE
    o = torch.full((B, H, Sq, D), float("nan"))
    lse = torch.full((B, H, Sq), float("nan"))
    r = torch.arange(ROWS)
    for b in range(B):
        q_off, kv_off = int(offsets[b, 0]), int(offsets[b, 1])

        def should_run(lo, hi, t0):
            return tfa.block_should_run(masks["causal"], masks["window"], masks["sinks"], lo, hi,
                                        kv_off + t0, kv_off + min(t0 + TK, Skv) - 1)
        for kvh in range(Hkv):
            for hc in range(HC):
                for q0 in range(0, Sq, NQ):
                    gi = hc * GB + r // NQ
                    pos = q0 + r % NQ
                    exists = (r // NQ < GB) & (gi < G) & (pos < Sq)
                    q_gi = torch.clamp(gi + 1, max=G - 1) if fault == "wrong_head" else gi
                    Q = [torch.zeros(ROWS, D) for _ in range(3)]
                    for j in range(3):
                        Q[j][exists] = qp[j][b, kvh * G + q_gi[exists], pos[exists]]
                    qpos = q_off + pos

                    def span(r0, n):
                        sel = qpos[r0:r0 + n][exists[r0:r0 + n]]
                        return (int(sel.min()), int(sel.max())) if len(sel) else None

                    first_q, last_q = q_off + q0, q_off + min(q0 + NQ, Sq) - 1
                    m = torch.full((ROWS,), float("-inf"))
                    l = torch.zeros(ROWS)
                    acc = torch.zeros(ROWS, D)
                    tiles = [t0 for t0 in range(0, Skv, TK) if should_run(first_q, last_q, t0)]
                    for n, t0 in enumerate(tiles):
                        src = t0
                        if fault == "stale_stage":  # the stage holds another tile of the walk
                            src = tiles[n - STAGES + 1] if n >= STAGES - 1 else None
                        kt, vt = [torch.zeros(TK, D) for _ in range(3)], [
                            torch.zeros(TK, D) for _ in range(3)]
                        if src is not None:
                            n_keys = min(TK, Skv - src)
                            for j in range(3):
                                kt[j][:n_keys] = kp[j][b, kvh, src:src + n_keys]
                                vt[j][:n_keys] = vp[j][b, kvh, src:src + n_keys]
                        kloc = t0 + torch.arange(TK)
                        S = _six(Q, kt, s_order)
                        for w in range(ROWS // 16):
                            rows = slice(16 * w, 16 * w + 16)
                            wspan = span(16 * w, 16)
                            if wspan is None or not should_run(*wspan, t0):
                                continue  # p = 0: m, l and acc unchanged
                            lo = wspan[1] if fault == "unmasked_from_last_row" else wspan[0]
                            unmasked = bf16_tiles._unmasked(masks, lo, wspan[1], kv_off + t0,
                                                            kv_off + t0 + TK - 1, t0 + TK - 1, Skv)
                            x = S[rows]
                            if masks["softcap"] is not None:
                                x = masks["softcap"] * torch.tanh(x / masks["softcap"])
                            if not unmasked:
                                ok = bf16_tiles._visible(masks, qpos[rows], kv_off + kloc, kloc,
                                                         Skv)
                                x = torch.where(ok, x, torch.full_like(x, mask_value))
                            m_next = torch.maximum(m[rows], x.amax(dim=-1))
                            alpha = torch.exp(m[rows] - m_next)
                            live = (m_next > mask_value * 0.5) | unmasked
                            m2 = m_next * LOG2E
                            arg = (x.double() * LOG2E.double() - m2.double()[:, None]).float()
                            p = torch.where(live[:, None], torch.exp2(arg), torch.zeros_like(x))
                            l[rows] = alpha * l[rows] + p.sum(dim=-1)
                            pv = _six(_split3(p, residual), [t.T for t in vt], pv_order)
                            if fault != "no_rescale":
                                acc[rows] = acc[rows] * alpha[:, None]
                            if fault != "no_merge":
                                acc[rows] = acc[rows] + pv
                            m[rows] = m_next
                    heads = kvh * G + gi[exists]
                    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
                    o[b, heads, pos[exists]] = (acc * l_inv[:, None])[exists]
                    lse[b, heads, pos[exists]] = torch.where(
                        l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))[exists]
    return o, lse


def _pieces_inputs(i):
    """(q, k, v, offsets, masks) of FLASH_FWD_PIECES case i on the CPU."""
    case = chip_smoke.FLASH_FWD_PIECES[i]
    q, k, v = chip_smoke.flash_fwd_pieces_inputs(torch.Generator().manual_seed(200 + i), case,
                                                 device="cpu")
    return q, k, v, tfa._offsets(0, 0, case[0], "cpu"), dict(causal=True, window=None, sinks=0,
                                                              softcap=None)


def _case_inputs(name):
    if name.startswith("pieces"):
        return _pieces_inputs(int(name[len("pieces"):]))
    i = int(name[len("flash_fwd"):])
    return bf16_tiles._inputs(F32_CASES[i], seed=100 + i)


CASES = [f"flash_fwd{i}" for i in sorted(F32_CASES)] + [
    f"pieces{i}" for i in range(len(chip_smoke.FLASH_FWD_PIECES))]


@pytest.mark.parametrize("name", CASES)
def test_walk_matches_plain(name):
    q, k, v, offsets, masks = _case_inputs(name)
    o, lse, tol, lse_tol = bf16_tiles._plain(q, k, v, offsets, masks)
    wo, wlse = _walk(q, k, v, offsets, masks)
    assert chip_smoke.err_over_tol(wo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(wlse, lse, lse_tol) <= 1.0


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    q, k, v, offsets, masks = _case_inputs(name)
    o, lse, tol, lse_tol = bf16_tiles._plain(q, k, v, offsets, masks)
    jo, jlse = bf16_tiles._jax(q, k, v, offsets, masks)
    assert chip_smoke.err_over_tol(jo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(jlse, lse, lse_tol) <= 1.0


def test_f32_cases_hold_the_kernels_edges():
    """The f32 cases reach each head dim (and so each ring: 192, 128 and 64
    rows, 32-key tiles at d=128), a walk longer than the ring at each, a
    group folded into the rows with rows left empty, a ragged q tile,
    offsets per sequence, a window with sinks, softcap, and a ragged key
    tile."""
    cases = list(F32_CASES.values())
    assert all(not c[10] for c in cases)
    assert {c[5] for c in cases} == {32, 64, 128}
    for D in (32, 64, 128):
        assert any(c[5] == D and -(-c[4] // RING[D][1]) > 3 for c in cases)
    assert any(RING[c[5]][0] % (c[1] // c[2]) for c in cases)
    assert any(c[3] % (RING[c[5]][0] // min(c[1] // c[2], RING[c[5]][0])) for c in cases)
    assert any(isinstance(c[11], tuple) and isinstance(c[11][0], tuple) for c in cases)
    assert any(c[7] is not None and c[8] for c in cases)
    assert any(c[9] is not None for c in cases)
    assert any(c[4] % RING[c[5]][1] for c in cases)


# The analogues of PLANTED_FAULTS's f32 flash_fwd.cu lines: (description,
# case, least err/tol).
FAULTS = {
    "q_third": ("f32: Q's third piece dropped (S without q2·k0)", "pieces1", 2.0),
    "k_third": ("f32: K's third piece dropped (S without q0·k2)", "pieces1", 2.0),
    "p_third": ("f32: P's third piece dropped (P·V without p2·v0)", "pieces0", 1.5),
    "v_third": ("f32: V's third piece dropped (P·V without p0·v2)", "pieces0", 2.0),
    "residual": ("f32: a1 taken as bf16(a) − a0, not the exact residual a − a0",
                 "flash_fwd18", 5.0),
    "k_as_v": ("f32: V's planes copied from K's", "flash_fwd18", 5.0),
    "split_edge": ("f32 split pass: V's last 32 values (its last row at d=32) left unwritten",
                   "flash_fwd19", 5.0),
    "stale_stage": ("f32: next key tile copied into the stage being read", "flash_fwd18", 5.0),
    "no_rescale": ("f32: acc not rescaled when a row's max moved", "flash_fwd18", 5.0),
    "wrong_head": ("f32: a folded row's Q taken from the group's next q head", "flash_fwd18", 5.0),
    "unmasked_from_last_row": ("f32: a tile taken as wholly visible when the warp's last row "
                               "sees it", "flash_fwd18", 5.0),
    "no_merge": ("f32: a tile's P·V never added to acc", "flash_fwd18", 5.0),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_analogues_miss_the_tolerance(fault):
    what, name, least = FAULTS[fault]
    assert any(f[0] == "flash_fwd.cu" and f[1] == what for f in chip_smoke.PLANTED_FAULTS)
    q, k, v, offsets, masks = _case_inputs(name)
    o, lse, tol, lse_tol = bf16_tiles._plain(q, k, v, offsets, masks)
    wo, wlse = _walk(q, k, v, offsets, masks, fault=fault)
    worst = max(chip_smoke.err_over_tol(wo, o, tol), chip_smoke.err_over_tol(wlse, lse, lse_tol))
    assert worst > least or math.isinf(worst)
