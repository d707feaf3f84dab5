"""The bf16 w4 dequant-matmul's tiles (csrc/w4_matmul.cu, TPU kernels 8-9)
on the CPU: the tensor-core kernel's instruction sequence and tile walk
emulated in numpy.

The CUDA kernel computes outᵀ = Wᵀ·xᵀ on wgmma: a block owns 256 output
columns (two consumer warpgroups of two m64 tiles each) and up to 64 rows
of x; per k16 step a consumer thread (warp w, lane 4g + t) reads 4 bytes
(its columns colw..colw + 3, colw = 128c + 32w + 4g) of packed rows 2t,
2t + 1, 2t + 8 and 2t + 9, makes each nibble's exact value by the f32
magic-number trick, multiplies by its f32 scale and rounds pairs to bf16:
the A fragments of both planes. Here:

- `nibble`, the kernel's LOP3 + FADD sequence on uint32 words, equals
  `unpack_nibbles` for all 256 byte values, at every byte position of a
  word, in both planes.
- `fragment_map`, the thread -> (packed row, column) map of the A
  fragments and the epilogue's column of each accumulator row, covers each
  (k, column) of a 256-column k16 step exactly once and writes every
  product back to its own column.
- The scale-slot walk (two bits a step) and the stage's slot count equal
  the groups the stage's packed rows belong to, for groups of 1-8 k16
  steps.
- `walk`, the kernel's tile walk (stages of 64 packed rows, k16 steps, the
  two planes, split-K partials added in split order) in f32, is within
  chip_smoke.w4_tolerance of the port's plain version, and within its
  golden form (one bf16 rounding of each weight more) of the JAX package's
  w4_matmul (Pallas in interpret mode) on the same bf16 values held in f32,
  which keeps w = q*s unrounded: R = 1, 5, 8, 17, 64 and 100, both
  packings, groups 32, 64 and 128 (one to four scale rows a stage),
  column tails.
- Each planted fault of chip_smoke.PLANTED_FAULTS in w4_matmul.cu's
  tensor-core route as a switch of `walk`: each must miss the tolerance
  by more than 5x.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from quantizedmha_tpu_torch.ops import w4_matmul as tm
from quantizedmha_tpu_torch.quant import weights as tw

jm = importlib.import_module("quantizedmha_tpu.ops.w4_matmul")

TC_COLS, KS = 256, 64  # the block's columns, packed rows a stage


def _nibble_offset(hi, b):
    """(bit offset O in the word or in word >> 12, shifted) of byte b's
    nibble, as the kernel's `nibble` picks it."""
    if hi:
        return (4, 12, 8, 16)[b], b >= 2
    return (0, 8, 16, 12)[b], b == 3


def nibble(words, hi, b, *, lo_twos=False, lo_bias=False):
    """q of byte b's nibble in uint32 words, as f32: (w & 0xF << O) ^ magic
    viewed as f32, less 2^(23-O) + 8. lo_twos and lo_bias plant the faults
    "the low plane's nibbles read as two's complement" and "its +8 bias left
    in"."""
    o, shifted = _nibble_offset(hi, b)
    src = (words >> np.uint32(12)) if shifted else words
    magic = np.uint32(((150 - o) << 23) | ((8 << o) if hi or lo_twos else 0))
    bits = (src & np.uint32(0xF << o)) ^ magic
    bias = (1 << (23 - o)) + (0 if lo_bias and not hi else 8)
    return bits.view(np.float32) - np.float32(bias)


def _bf16(a):
    """Round f32 to bf16 (nearest even) and back to f32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def test_nibble_sequence_equals_unpack_for_every_byte():
    byte = np.arange(256, dtype=np.uint32)
    lo, hi = tm.unpack_nibbles(torch.arange(256, dtype=torch.int32).to(torch.int8))
    for b in range(4):
        words = byte << np.uint32(8 * b)  # the byte at position b, others zero
        np.testing.assert_array_equal(nibble(words, False, b), lo.numpy().astype(np.float32))
        np.testing.assert_array_equal(nibble(words, True, b), hi.numpy().astype(np.float32))
    # Neighbouring bytes of the word do not leak into a nibble.
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for b in range(4):
        byte_b = ((words >> np.uint32(8 * b)) & np.uint32(0xFF)).astype(np.int32)
        lo, hi = tm.unpack_nibbles(torch.from_numpy(byte_b).to(torch.int8))
        np.testing.assert_array_equal(nibble(words, False, b), lo.numpy().astype(np.float32))
        np.testing.assert_array_equal(nibble(words, True, b), hi.numpy().astype(np.float32))


def test_weight_rounding_equals_plain():
    """bf16(f32(q * s)) of the emulation is the plain version's w."""
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, 10000).astype(np.float32)
    s = (rng.random(10000) * 2.0**rng.integers(-20, 4, 10000)).astype(np.float32)
    got = _bf16(q * s)
    want = (torch.from_numpy(q) * torch.from_numpy(s)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def fragment_map(*, k_pair_swap=False, col_perm=False):
    """(src_k, src_col) [c, j, arow, kk]: the packed row (within the k16
    step) and block column of A element (arow, kk) of consumer c's m64 tile
    j; dst [c, j, arow]: the block column the epilogue writes that
    accumulator row to. k_pair_swap and col_perm plant the faults "A
    fragment's k pair swapped" and "output columns permuted"."""
    src_k = np.full((2, 2, 64, 16), -1)
    src_col = np.full((2, 2, 64, 16), -1)
    dst = np.full((2, 2, 64), -1)
    for c in range(2):
        for w in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                colw = 128 * c + 32 * w + 4 * g
                for j in range(2):
                    for e in range(4):
                        byte = 2 * j + (e & 1)
                        rows = (2 * t, 2 * t + 1) if e < 2 else (2 * t + 8, 2 * t + 9)
                        if k_pair_swap and j == 0 and e == 0:
                            rows = rows[::-1]
                        arow = 16 * w + g + 8 * (e & 1)
                        k_lo = 2 * t + 8 * (e >= 2)
                        for half in range(2):
                            src_k[c, j, arow, k_lo + half] = rows[half]
                            src_col[c, j, arow, k_lo + half] = colw + byte
                # Epilogue: v = {acc[0][.][u], acc[0][.][2+u], acc[1][.][u],
                # acc[1][.][2+u]} to columns colw..colw + 3.
                order = ((0, 0), (1, 0), (0, 1), (1, 1)) if col_perm else \
                    ((0, 0), (0, 1), (1, 0), (1, 1))
                for pos, (j, h) in enumerate(order):
                    dst[c, j, 16 * w + g + 8 * h] = colw + pos
    return src_k, src_col, dst


def test_fragment_map_covers_each_weight_once_and_writes_it_back():
    src_k, src_col, dst = fragment_map()
    pairs = src_k * TC_COLS + src_col
    assert sorted(pairs.ravel().tolist()) == list(range(16 * TC_COLS))
    assert sorted(dst.ravel().tolist()) == list(range(TC_COLS))
    # Every A row holds one column, its k pairs in order, and the epilogue
    # writes the row's sums to that column.
    assert (src_col == src_col[..., :1]).all()
    assert (src_col[..., 0] == dst).all()
    assert (src_k == np.arange(16)).all()
    # A thread's 4 columns are neighbours: one 4-byte word of a packed row.
    cols = src_col[..., 0].reshape(2, 2, 4, 2, 8)  # c, j, w, h, g
    assert (cols % 4 == 2 * np.arange(2)[None, :, None, None, None]
            + np.arange(2)[None, None, None, :, None]).all()
    # The faults' maps break it.
    k, col, d = fragment_map(k_pair_swap=True)
    assert not (k == np.arange(16)).all()
    k, col, d = fragment_map(col_perm=True)
    assert not (col[..., 0] == d).all()


def stage_slots(rpg):
    """The most scale groups a stage (64 packed rows from a multiple of 64)
    meets: the C entry's `p.slots`."""
    return max((kb + KS - 1) // rpg - kb // rpg + 1 for kb in range(0, KS * rpg, KS))


def step_slots(kb, rpg):
    """Each k16 step's slot as the consumer counts it (two bits a step)."""
    rpg16, m, j, bits = rpg // 16, (kb // 16) % (rpg // 16), 0, 0
    for kc in range(4):
        bits |= j << (2 * kc)
        m += 1
        if m == rpg16:
            m, j = 0, j + 1
    return [(bits >> (2 * kc)) & 3 for kc in range(4)]


@pytest.mark.parametrize("rpg", [16, 32, 48, 64, 80, 128])
def test_scale_slots_follow_the_groups(rpg):
    slots = stage_slots(rpg)
    assert slots == max(len({(kb + r) // rpg for r in range(KS)})
                        for kb in range(0, 8 * KS * rpg, KS))
    for kb in range(0, 8 * KS * rpg, KS):
        want = [(kb + 16 * kc) // rpg - kb // rpg for kc in range(4)]
        assert step_slots(kb, rpg) == want
        assert max(want) < slots


def walk(x, packed, scale, *, group, packing, fault=None):
    """The tensor-core kernel's tile walk in numpy f32: x [R, in] bf16
    values (f32 array), packed [k2, n] int8, scale [gn, n] f32 -> out
    [R, n] bf16 values (f32 array). `fault` plants one of
    chip_smoke.PLANTED_FAULTS' bf16 faults."""
    R, in_dim = x.shape
    k2, n = packed.shape
    gn = scale.shape[0]
    halves = packing == "halves"
    rpg = group if halves else group // 2
    hi_goff = gn // 2 if halves else 0
    planes = (x[:, :k2], x[:, k2:]) if halves else (x[:, 0::2], x[:, 1::2])
    chunk, splits = tm.split_k(R, k2, n)
    src_k, src_col, dst = fragment_map(k_pair_swap=fault == "k_pair_swap",
                                       col_perm=fault == "col_perm")
    src_k, src_col, dst = src_k.reshape(256, 16), src_col.reshape(256, 16), dst.reshape(256)
    pk = np.zeros((k2 + 2 * KS, n + TC_COLS), np.uint8)  # zero past the edges
    pk[:k2, :n] = packed.view(np.uint8)
    out = np.zeros((R, n), np.float32)
    for r0 in range(0, R, 64):
        xr = [p[r0:r0 + 64] for p in planes]
        rows = xr[0].shape[0]
        for n0 in range(0, n, TC_COLS):
            total = np.zeros((TC_COLS, rows), np.float32)
            for sp in range(splits):
                if fault == "split" and sp == 1:
                    continue
                k0 = sp * chunk
                k1 = min(k0 + chunk, k2)
                acc = np.zeros((TC_COLS, rows), np.float32)
                for kb in range(k0, k1, KS):
                    g0 = kb // rpg
                    slots = step_slots(kb, rpg)
                    tile = kb + KS if fault == "next_stage" else kb
                    for kc in range(4):
                        r_lo = tile + 16 * kc
                        raw = pk[r_lo:r_lo + 16, n0:n0 + TC_COLS]  # [16, 256] bytes
                        raw = np.where((np.arange(r_lo, r_lo + 16) < k1)[:, None], raw, 0)
                        words = raw.reshape(16, 64, 4).copy().view(np.uint32)[..., 0]
                        ks = kb + 16 * kc + np.arange(16)
                        for plane in range(2):
                            grp = g0 + slots[kc] + plane * hi_goff
                            if fault == "hi_group" and plane == 1:
                                grp = min(g0 + slots[kc] + hi_goff + 1, gn - 1)
                            s = np.zeros(TC_COLS, np.float32)
                            cols = np.arange(n0, min(n0 + TC_COLS, n))
                            if (kb + 16 * kc) < k1:
                                s[:cols.size] = scale[grp, cols]
                            q = np.zeros((16, TC_COLS), np.float32)
                            for b in range(4):
                                q[:, b::4] = nibble(words, plane == 1, b,
                                                    lo_twos=fault == "lo_twos",
                                                    lo_bias=fault == "lo_bias")
                            wq = _bf16(q * s[None, :])  # [k, column]
                            a = wq[src_k, src_col]  # [A row, kk]
                            bx = np.zeros((16, rows), np.float32)
                            ok = ks < k1
                            bx[ok] = xr[plane][:, ks[ok]].T
                            part = (a @ bx).astype(np.float32)
                            acc[dst] = acc[dst] + part
                total = acc if sp == 0 else total + acc  # split order
            width = min(TC_COLS, n - n0)
            out[r0:r0 + rows, n0:n0 + width] = total[:width].T
    return _bf16(out)


# (R, in, out, group, packing): one to four scale rows a stage, column
# tails, splits of one to several stages, two row tiles.
CASES = [(1, 512, 264, 128, "halves"), (5, 1024, 520, 32, "pairs"),
         (17, 256, 96, 32, "halves"), (64, 512, 200, 64, "pairs"),
         (100, 512, 136, 128, "pairs"), (8, 768, 272, 32, "pairs")]


def _case(R, in_dim, n, group, packing, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (in_dim, n)).astype(np.float32)
    w.flat[rng.integers(0, w.size, 3)] *= 30.0
    x = _bf16(rng.normal(0, 1, (R, in_dim)))
    q = tw.quantize_weight4(torch.from_numpy(w), group=group, packing=packing)
    return x, q


@pytest.mark.parametrize("case", CASES)
def test_walk_within_tolerance_of_plain_and_jax(case):
    R, in_dim, n, group, packing = case
    x, q = _case(*case, seed=sum(case[:4]))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = torch.from_numpy(walk(x, q.packed.numpy(), q.scale.numpy(), group=group,
                                packing=packing))
    plain = tm._w4_matmul_plain(xt, q.packed, q.scale, group=group, packing=packing)
    assert chip_smoke.err_over_tol(got, plain, chip_smoke.w4_tolerance(xt, q, plain)) <= 1.0
    want = jm.w4_matmul(jnp.asarray(x), jnp.asarray(q.packed.numpy()),
                        jnp.asarray(q.scale.numpy()), group=group, packing=packing,
                        interpret=True)
    want = torch.from_numpy(np.array(want))
    tol = chip_smoke.w4_tolerance(xt, q, want, golden=True)
    assert chip_smoke.err_over_tol(got, want, tol) <= 1.0


FAULTS = ["hi_group", "lo_bias", "split", "k_pair_swap", "lo_twos", "next_stage", "col_perm"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_analogues_miss_by_5x(fault):
    """Each bf16 fault of w4_matmul.cu in chip_smoke.PLANTED_FAULTS, planted
    in the walk, misses the plain version's tolerance by more than 5x on a
    halves-packed product of 16 splits of one stage."""
    x, q = _case(8, 2048, 512, 128, "halves", seed=3)
    assert tm.split_k(8, 1024, 512) == (64, 16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plain = tm._w4_matmul_plain(xt, q.packed, q.scale, group=128, packing="halves")
    tol = chip_smoke.w4_tolerance(xt, q, plain)
    got = torch.from_numpy(walk(x, q.packed.numpy(), q.scale.numpy(), group=128,
                                packing="halves", fault=fault))
    assert chip_smoke.err_over_tol(got, plain, tol) > 5.0


def test_planted_faults_name_their_lines():
    """Every bf16 fault above is a line of w4_matmul.cu in PLANTED_FAULTS."""
    lines = [f for f in chip_smoke.PLANTED_FAULTS if f[0] == "w4_matmul.cu"]
    assert len(lines) == len(FAULTS)
    text = (tm.cuda_lib.CSRC / "w4_matmul.cu").read_text()
    for _, _, old, new in lines:
        assert text.count(old) == 1 and old != new
