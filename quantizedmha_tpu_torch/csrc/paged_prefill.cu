// Paged multi-token causal attention over the INT8 KV cache, or over the
// nibble-packed INT4 one, for Hopper (sm_90a): one kernel template per q
// dtype, each over both page formats.
//
// Replaces the Pallas TPU kernels quantizedmha_tpu/ops/paged_prefill.py:63
// _prefill_kernel (entry paged_prefill) and :323 _prefill_kernel_int4
// (entry paged_prefill_int4): a prefill chunk's (or a prefix-cache
// suffix's) queries attend straight from the pages through the block
// table, with per-sequence q_starts and lengths.
//
// Numerics contract, against _paged_prefill_plain in ops/paged_prefill.py
// (q times sm_scale in f32, s = (q · k) · k_scale in f32, P·V in f32):
//   Masks: kpos <= qpos and kpos < length, and with a window kpos > qpos -
//   window OR'd with kpos < sinks; masked scores are mask_value; the online
//   softmax zeroes p on rows whose running max is still the mask value, and
//   l sums the f32 p. o = acc · (l == 0 ? 1 : 1/l) in q's dtype, lse = m +
//   log(max(l, 1e-38)) or -inf when l == 0.
//   bf16 q (every main path; tensor cores, wgmma): s = (q_bf16 · k) with
//   f32 accumulation, then times sm_scale · k_scale[key] in f32, per key
//   column. int8 and int4 values are exact in bf16 and so is q, so S
//   differs from the plain version's only by the summation order. P·V takes
//   P rounded to bf16 once (round to nearest even) with each key's V scale
//   folded in first, bf16(p · v_scale[key]), as the register A operand of a
//   wgmma against the exact bf16 V tile: the one rounding the plain version
//   does not make, within 2^-8 · sum_j p_j |v_j| / l of an output element.
//   It is what the TPU kernel's Precision.DEFAULT dots do (one bf16 pass,
//   P rounded to bf16); the plain version follows the f32 numerics of its
//   CPU (interpret) semantics.
//   Split key walk (bf16 q, S = splits > 1; ops/paged_prefill.py's
//   prefill_splits, which the plain version cuts too): block (..., split s)
//   walks only keys [s·K, (s+1)·K), K = pages_per_split · P a multiple of
//   the 64-key tile, from zero state and writes its unnormalised f32 acc,
//   m and l; prefill_merge_kernel then takes a row's splits in split order:
//   M = max m, w_s = exp(m_s − M) (a split with m = -inf saw nothing and is
//   skipped), o = Σ w_s·acc_s / Σ w_s·l_s in q's dtype (0 where that sum
//   is 0), lse = M + log(max(Σ w_s·l_s, 1e-38)) or -inf where it is 0. P is
//   then rounded to bf16 relative to each split's own running max m_s:
//   split s adds bf16(p_j^s · v_scale_j) · v_j with p_j^s = exp(x_j − m_s),
//   within 2^-8 · p_j^s |v_scale_j v_j| of the exact term (the rounding is
//   relative, whatever the scale: bf16 has f32's exponent range), and
//   w_s · p_j^s = exp(x_j − M) = p_j, the one walk's p under its final max.
//   So the merged output is within 2^-8 · Σ_j p_j |v_j| / l of the exact
//   one, l = Σ_s w_s·l_s = Σ_j p_j: one walk's bound, plus the merge's f32
//   rescale (a few ulps). l still sums the f32 p, so lse only sees the
//   summation order. With S = 1 nothing of this runs.
//   f32 q (CUDA cores, f32_tile.cuh): q times sm_scale in f32, true f32
//   FMAs for both products, P·V as (p · v_scale) · v in f32: the plain
//   version up to the f32 summation order and a few ulps of exp/tanh.
//
// INT4 form: a packed row holds D/2 bytes (byte j: element j low nibble,
// element j + D/2 high nibble; int4.cuh), and key t of a page takes the
// scales of its sub-tile, scales[h, page, t / (P / subs)]: the INT8 form
// is the case subs = 1. q_starts may be negative (the INT4 partial of a
// mixed-cache chunk that starts below the boundary): rows at negative
// positions see no key and give o = 0, lse = -inf; a tile whose rows are
// all negative loads nothing (kend <= 0).
//
// What bounds it on the H100: the serving path's heaviest launch, a
// 2048-row chunk at 4096 of context at Hq=32, d=128, has 3.36e8 visible
// (q, key) pairs: 4 · pairs · d = 1.7e11 bf16 operations, 0.174 ms at the
// tensor cores' 989 TFLOP/s, above its 3.4e8 exponentials (0.08 ms on the
// SFUs) and the tens of MB of pages and q it reads (0.014 ms). Between the
// products sits per-pair f32 work (scale, mask, max, exp, sum, bf16
// packing), and each key tile's int8 or int4 bytes must become bf16 before
// the tensor cores can read them.
//
// What this design does about it (bf16 q): a block is (sequence, kv head,
// q tile of 128 rows), whose rows hold all `group` q heads of the tile (32
// positions x 4 heads at Llama-3-8B's GQA), so each K/V tile is read and
// converted once for 128 rows. Its four warpgroups specialise
// (setmaxnreg: 56 registers a producer thread, 200 a consumer thread). Two
// producers take turns over the key tiles: cp.async stages a tile's raw
// int8 / nibble bytes through the block table, with each key's K and V
// scale, one tile ahead, and the producer converts the tile exactly into
// its own swizzled bf16 K and V stage by integer and bf16 arithmetic (no
// int-to-float conversion instructions, which run at a quarter of the FMA
// rate), conflict-free in shared memory. Two consumers (64 rows each; warp
// w owns rows 16w..16w+15) hold Q, staged once unscaled in wgmma's
// 128-byte-swizzled layout, and per tile run S = Q·Kᵀ as a wgmma m64n64
// from shared memory; the scores stay in its accumulator registers, where
// the row max and sum are quad shuffles and p = 2^(x·log2 e − m·log2 e) on
// the SFU (ex2.approx, within ~1e-6 relative of exp(x − m) at the scores'
// scale: far inside the tolerance's 1e-5 terms); P, packed to bf16 in
// registers, is the A operand of a wgmma whose B is the V stage read
// MN-major. A stage passes from its producer to the consumers and back
// through named barriers, so the conversion and the copies overlap the
// products and the softmax. A tile wholly visible to a warp's rows takes a
// mask-free per-element loop and softcap is a compile-time choice (a
// runtime branch in the unrolled loop is if-converted); a warp whose rows
// see nothing of a tile skips the per-element work; acc is rescaled only
// when a row's max moved. Tiles past the causal bound or wholly behind the
// window (sink tiles aside) are never loaded. The grid runs the heaviest q
// tiles (the end of the chunk) first. 164 KB of shared memory at d=128, one
// block of 16 warps an SM. Every block writes its own rows in a fixed
// reduction order: no atomics, the same bits every launch.
//   Small q tiles (speculative verify: 4 sequences of k + 1 = 5 rows at
//   Gemma-2's 16 q / 8 kv heads are 32 blocks for 132 SMs, each walking its
//   sequence's whole context one tile after another): the split key walk
//   above gives each of a sequence's splits a block of its own, the grid's
//   second index, and the merge runs in the same C entry. A split that
//   holds no tile its rows can see (past a short sequence's length, or
//   wholly behind the window) writes m = -inf, l = 0 and exits before it
//   loads Q. With S = 1 the launch, the walk and the epilogue are the
//   unsplit kernel's.
//   d=256 (Gemma-2, bf16 q): a consumer's 64 x 256 f32 accumulator
//   alone is 128 registers a thread, and each bf16 K/V stage is 64 KB. So
//   one consumer of 64 rows (setmaxnreg 240) and the same two producers,
//   each with one raw stage (it converts a tile before it issues the next
//   one's copies): 227 KB of shared memory. P·V runs as two m64n128
//   products, one a column half of V and O.
//
// f32 q: one block of 256 threads per (sequence, kv head, 64-row q tile);
// a 64-key tile is staged by cp.async, converted once to f32 beside its
// per-key scales, and each thread computes 4 rows x 4 keys of S and 4 rows
// x d/16 columns of O from float4 shared-memory reads (f32_tile.cuh's tile
// step, shared with flash_fwd.cu's f32 kernel at d=256). V is converted
// into K's f32 tile once the tile's scores are done, so at d=256 (Gemma-2
// served in f32) the two raw stages still fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "int4.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = TILE_ROWS;  // q rows of a block: group x q positions
constexpr int BK = TILE_KEYS;    // keys of a staged tile
constexpr int NT = TILE_THREADS; // threads of an f32 block

struct Params {
  const void* q;         // [B, Hq, C, D] f32 or bf16
  const int8_t* kp;      // [Hkv, num_pages, P, D]
  const int8_t* vp;
  const float* ks;       // [Hkv, num_pages, subs] (INT8: subs = 1)
  const float* vs;
  const int* lengths;    // [B] visible context
  const int* qstarts;    // [B] global position of q row 0
  const int* tables;     // [B, max_pages]
  void* o;               // [B, Hq, C, D], q's dtype
  float* lse;            // [B, Hq, C] or nullptr
  float* part;           // splits > 1: [splits, B, Hq, C, D] unnormalised sums
  float* ml;             //   and [2, splits, B, Hq, C] their m and l
  int B, Hq, Hkv, C, num_pages, P, max_pages, G, BQ, subs;
  int splits, split_keys;  // split s walks keys [s·split_keys, (s+1)·split_keys)
  float sm_scale, softcap, mask_value, mask_half;
  int has_softcap, window, sinks;  // window < 0: none
};

// A block's q tile in its sequence: row r holds q head kvh*G + r / BQ at
// chunk position q0 + r % BQ; of its keys, split `split`'s.
struct Rows {
  int qlo;              // global position of the tile's first row
  int kstart;           // the split's first key (a tile boundary)
  int kend;             // keys [kstart, kend) can be visible to the tile
  const int* table;     // the sequence's block-table row
  size_t head_pages;    // first page of this kv head
};

__device__ __forceinline__ Rows block_rows(const Params& p, int b, int kvh, int q0, int split) {
  Rows s;
  const int length = p.lengths[b];
  const int qstart = p.qstarts[b];
  s.qlo = qstart + q0;
  const int qhi = qstart + min(q0 + p.BQ, p.C) - 1;
  s.kstart = split * p.split_keys;
  s.kend = min(min(qhi + 1, length), p.max_pages * p.P);
  if (p.splits > 1) s.kend = min(s.kend, s.kstart + p.split_keys);
  s.table = p.tables + size_t(b) * p.max_pages;
  s.head_pages = size_t(p.num_pages) * kvh;
  return s;
}

// Whether the key tile at t0 can hold a key visible to the block's rows:
// past the causal bound it is never reached; behind the window only sink
// tiles run.
__device__ __forceinline__ bool tile_runs(const Params& p, const Rows& s, int t0) {
  if (p.window < 0) return true;
  const int last = min(t0 + BK, s.kend) - 1;
  return last > s.qlo - p.window || t0 < p.sinks;
}

__device__ __forceinline__ int next_run(const Params& p, const Rows& s, int t0) {
  while (t0 < s.kend && !tile_runs(p, s, t0)) t0 += BK;
  return t0;
}

// The masks of one (q position, key) pair (kend <= length).
__device__ __forceinline__ bool key_visible(const Params& p, int kpos, int qpos, int kend) {
  bool valid = kpos <= qpos && kpos < kend;
  if (p.window >= 0) valid &= kpos > qpos - p.window || kpos < p.sinks;
  return valid;
}

// Index of key kpos's K and V scales in [Hkv, num_pages, subs]; that of
// page 0 when !ok (a key past the context).
__device__ __forceinline__ size_t scale_index(const Params& p, const Rows& s, int kpos, bool ok) {
  const int slot = ok ? kpos % p.P : 0;
  return (s.head_pages + (ok ? s.table[kpos / p.P] : 0)) * p.subs + slot / (p.P / p.subs);
}

// ---------------------------------------------------------------------------
// f32 q: CUDA cores.

template <int D, bool INT4>
struct F32Smem {
  // At d=256 Q's, K's and V's f32 tiles and P would take 217 KB, and the
  // raw stages another 32-64 KB: so V lands in K's tile (KV_OFF) once the
  // scores are done (f32_tile_scores, then f32_tile_pv), 216.6 KB with INT8
  // stages; the same at every d. (The other way out, a tile of 32 q rows,
  // would read and convert every K/V tile twice as often.)
  static constexpr int ROW = F32Tile<D>::ROW;
  static constexpr int Q_OFF = 0;
  static constexpr int KV_OFF = ROWS * ROW;
  static constexpr int P_OFF = KV_OFF + BK * ROW;
  static constexpr int KS_OFF = P_OFF + ROWS * F32Tile<D>::PROW;
  static constexpr int VS_OFF = KS_OFF + BK;
  static constexpr int F32_BYTES = (VS_OFF + BK) * 4;
  static constexpr int RB = INT4 ? D / 2 : D;  // bytes of a stored K or V row
  static constexpr int STAGE = BK * RB;  // bytes of one staged K or V tile
  static constexpr int BYTES = F32_BYTES + 4 * STAGE;  // + 2 K and 2 V stages
  static constexpr int CPR = RB / 16;   // 16-byte chunks of a stored row
  static_assert(BYTES <= 232448, "shared memory of a block");
};

// One staged 16-byte chunk (chunk c of a stored row) to f32 in the tile's
// row `dst`: 16 int8 elements at 16c, or 16 packed bytes whose low nibbles
// are elements 16c.. and high nibbles elements D/2 + 16c..
template <int D, bool INT4>
__device__ __forceinline__ void chunk_to_f32(const int4 raw, int c, float* dst) {
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = packed_byte(words[w], i);
    if (INT4) {
      *reinterpret_cast<float4*>(dst + 16 * c + 4 * w) =
          make_float4(int4_lo(b[0]), int4_lo(b[1]), int4_lo(b[2]), int4_lo(b[3]));
      *reinterpret_cast<float4*>(dst + D / 2 + 16 * c + 4 * w) =
          make_float4(int4_hi(b[0]), int4_hi(b[1]), int4_hi(b[2]), int4_hi(b[3]));
    } else {
      *reinterpret_cast<float4*>(dst + 16 * c + 4 * w) = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
}

template <int D, bool INT4>
__global__ void __launch_bounds__(NT) paged_prefill_f32_kernel(const Params p) {
  using S = F32Smem<D, INT4>;
  using T = F32Tile<D>;

  extern __shared__ __align__(16) float sm[];
  float* qs = sm + S::Q_OFF;
  float* kvf = sm + S::KV_OFF;  // K's f32 tile, then V's
  float* ps = sm + S::P_OFF;
  float* kss = sm + S::KS_OFF;
  float* vss = sm + S::VS_OFF;
  int8_t* k8 = reinterpret_cast<int8_t*>(sm + S::F32_BYTES / 4);
  int8_t* v8 = k8 + 2 * S::STAGE;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * p.BQ;  // first q position (chunk-relative) of the tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Rows rows = block_rows(p, b, kvh, q0, 0);
  const int kend = rows.kend;

  auto issue = [&](int t0, int buf) {
    for (int e = tid; e < BK * S::CPR; e += NT) {
      const int r = e / S::CPR, c = e % S::CPR;
      const int kpos = t0 + r;
      const bool ok = kpos < kend;
      const int page = ok ? rows.table[kpos / p.P] : 0;
      const size_t src = ((rows.head_pages + page) * p.P + (ok ? kpos % p.P : 0)) * S::RB + 16 * c;
      cp_async16(k8 + buf * S::STAGE + r * S::RB + 16 * c, p.kp + src, ok);
      cp_async16(v8 + buf * S::STAGE + r * S::RB + 16 * c, p.vp + src, ok);
    }
    cp_async_commit();
  };
  int t0 = next_run(p, rows, 0);
  if (t0 < kend) issue(t0, 0);

  // Q rows in f32, times sm_scale; rows past the group or the chunk are 0.
  for (int e = tid; e < ROWS * (D / 4); e += NT) {
    const int r = e / (D / 4), c = e % (D / 4);
    const int gi = r / p.BQ, qi = q0 + r % p.BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi < p.G && qi < p.C) {
      const size_t idx = ((size_t(b) * p.Hq + kvh * p.G + gi) * p.C + qi) * D + 4 * c;
      x = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p.q) + idx);
    }
    *reinterpret_cast<float4*>(qs + r * S::ROW + 4 * c) =
        make_float4(x.x * p.sm_scale, x.y * p.sm_scale, x.z * p.sm_scale, x.w * p.sm_scale);
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    qpos[i] = rows.qlo + r % p.BQ;
  }
  float m[4], lpart[4], acc[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lpart[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc[i][c] = 0.f;
  }

  int buf = 0;
  while (t0 < kend) {
    cp_async_wait_all();
    __syncthreads();  // this stage landed; every thread is done with the last tile
    const int tn = next_run(p, rows, t0 + BK);
    if (tn < kend) issue(tn, buf ^ 1);
    // int8 / int4 -> K's f32 tile, and each key's scales (0 past the context).
    for (int e = tid; e < BK * S::CPR; e += NT) {
      const int r = e / S::CPR, c = e % S::CPR;
      const int4 raw = *reinterpret_cast<const int4*>(k8 + buf * S::STAGE + r * S::RB + 16 * c);
      chunk_to_f32<D, INT4>(raw, c, kvf + r * S::ROW);
    }
    if (tid < BK) {
      const int kpos = t0 + tid;
      const bool ok = kpos < kend;
      const size_t sidx = scale_index(p, rows, kpos, ok);
      kss[tid] = ok ? p.ks[sidx] : 0.f;
      vss[tid] = ok ? p.vs[sidx] : 0.f;
    }
    __syncthreads();

    auto score = [&](int i, int key, float s) {
      float x = s * kss[key];
      if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
      return key_visible(p, t0 + key, qpos[i], kend) ? x : p.mask_value;
    };
    f32_tile_scores<D>(qs, kvf, ps, m, lpart, acc, p.mask_half, score,
                       [&](int key, float pe) { return pe * vss[key]; });
    __syncthreads();  // P is complete and K's tile read: V takes its place
    for (int e = tid; e < BK * S::CPR; e += NT) {
      const int r = e / S::CPR, c = e % S::CPR;
      const int4 raw = *reinterpret_cast<const int4*>(v8 + buf * S::STAGE + r * S::RB + 16 * c);
      chunk_to_f32<D, INT4>(raw, c, kvf + r * S::ROW);
    }
    __syncthreads();
    f32_tile_pv<D>(ps, kvf, acc);
    buf ^= 1;
    t0 = tn;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum16(lpart[i]);
    const int r = ty * 4 + i;
    const int gi = r / p.BQ, qi = q0 + r % p.BQ;
    if (gi >= p.G || qi >= p.C) continue;
    const size_t row = (size_t(b) * p.Hq + kvh * p.G + gi) * p.C + qi;
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int nv = 0; nv < T::NV; ++nv) {
      const int col = tx * T::VW + 16 * T::VW * nv;
      typename T::Vec out;
      float* of = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int w = 0; w < T::VW; ++w) of[w] = acc[i][nv * T::VW + w] * l_inv;
      *reinterpret_cast<typename T::Vec*>(reinterpret_cast<float*>(p.o) + row * D + col) = out;
    }
    if (p.lse != nullptr && tx == 0) {
      p.lse[row] = l == 0.f ? -INFINITY : m[i] + logf(fmaxf(l, 1e-38f));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores (wgmma), two producer and two consumer warpgroups.

constexpr int PRODUCERS = 2;                  // producer warpgroups, one bf16 K/V stage each
constexpr float LOG2E = 1.4426950408889634f;

// The bf16 block's shape: consumer warpgroups of 64 q rows, raw stages a
// producer, a consumer thread's registers.
template <int D>
struct Bf16Block {
  static constexpr int CONSUMERS = D == 256 ? 1 : 2;
  static constexpr int RAWS = D == 256 ? 1 : 2;
  static constexpr int CONSUMER_REGS = D == 256 ? 240 : 200;
  static constexpr int BROWS = 64 * CONSUMERS;                  // q rows of a bf16 block
  static constexpr int NTB = 128 * (PRODUCERS + CONSUMERS);     // threads of a bf16 block
  static constexpr int HANDOFF = 128 * (1 + CONSUMERS);         // a producer and the consumers
  static_assert(PRODUCERS * 128 * 56 + CONSUMERS * 128 * CONSUMER_REGS <= 65536,
                "register budget");
};
// Named barriers (0 is __syncthreads): stage s holds a tile (FULL + s),
// stage s is free again (EMPTY + s), producer p's own (PRODUCER + p),
// consumer c's Q tile is in place (QREADY + c).
constexpr int FULL = 1, EMPTY = FULL + PRODUCERS, PRODUCER = EMPTY + PRODUCERS,
              QREADY = PRODUCER + PRODUCERS;

template <int D, bool INT4>
struct Bf16Smem {
  using T = Bf16Tile<D>;
  using K = Bf16Block<D>;
  static constexpr int RB = INT4 ? D / 2 : D;  // bytes of a stored K or V row
  static constexpr int CR = RB / 16;           // its 16-byte chunks
  static constexpr int STAGE = BK * RB;        // bytes of one raw K or V tile
  static constexpr int PER = (BK * CR + 127) / 128;  // raw chunks of a tile a producer thread
  // The producer's copy loop unrolled by 2 where a thread issues 8 chunks
  // (int8 at d=256): unrolled whole, its addresses spilled at 56 registers
  // a producer thread, and the d=256 chunk ran 1.12x slower (PERF.md).
  static constexpr int COPY_UNROLL = PER > 4 ? 2 : PER;
  // Each consumer's Q tile, then per producer's stage a K and a V tile
  // (swizzled bf16, 1024-byte aligned); per producer RAWS raw stages of K
  // and V bytes and their keys' K and V scales; per stage the keys' K and
  // V scales; 1 KB to align.
  static constexpr int KV_OFF = K::CONSUMERS * T::TILE * 2;
  static constexpr int RAW_OFF = KV_OFF + PRODUCERS * 2 * T::TILE * 2;
  static constexpr int RAW_SCALE_OFF = RAW_OFF + PRODUCERS * 2 * K::RAWS * STAGE;
  static constexpr int SCALE_OFF = RAW_SCALE_OFF + PRODUCERS * K::RAWS * 2 * BK * 4;
  static constexpr int BYTES = SCALE_OFF + PRODUCERS * 2 * BK * 4 + 1024;
  static_assert(BYTES <= 232448, "shared memory of a block");
};

// 16-byte chunk c of raw row r sits at chunk c ^ f(r) of its row, f(r) =
// (r / (8 / CR)) % CR (CR > 8: r % 8): 8 consecutive rows of one chunk
// index fall in 8 distinct 16-byte bank groups.
template <int CR>
__device__ __forceinline__ int raw_at(int r, int c) {
  if constexpr (CR > 8) return r * CR * 16 + 16 * (c ^ (r % 8));
  return r * CR * 16 + 16 * (c ^ ((r / (8 / CR)) % CR));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Four int8 (one 32-bit word) as four bf16 (two pairs, byte 0 in the low
// half), exactly (|x| <= 128 is a bf16): each byte, biased to unsigned u,
// is the low byte of the f32 2^23 + u; less 2^23 + 128 that is x in f32,
// whose high half is its bf16.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// The eight nibbles of four packed bytes as bf16 pairs, exactly: {low
// nibbles of bytes 0-1, of bytes 2-3, high nibbles of bytes 0-1, of bytes
// 2-3}. Nibble h (the value (h ^ 8) - 8) as h ^ 8 in the mantissa of 128.0
// is 128 + (h ^ 8); less 136 that is the value.
__device__ __forceinline__ uint4 int4x8_to_bf16(uint32_t w) {
  const uint32_t b01 = __byte_perm(w, 0u, 0x4140), b23 = __byte_perm(w, 0u, 0x4342);
  const __nv_bfloat162 bias = __float2bfloat162_rn(136.f);
  auto cvt = [&](uint32_t x) {
    const uint32_t y = (x & 0x000F000Fu) ^ 0x43084308u;
    return bf162_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y), bias));
  };
  return make_uint4(cvt(b01), cvt(b23), cvt(b01 >> 4), cvt(b23 >> 4));
}

// A raw stage's K (at rk) and V (one STAGE on) rows as the swizzled bf16
// tiles kt and vt, by the producer's 128 threads (this one `tid`): raw
// chunk c of an int8 row is bf16 chunks 2c and 2c + 1; of a nibble-packed
// row, the low nibbles are chunks 2c, 2c + 1 and the high nibbles chunks
// D/16 + 2c, D/16 + 2c + 1. Each step of 8 threads takes 8 rows of one
// chunk index: conflict-free reads and writes of shared memory.
template <int D, bool INT4>
__device__ __forceinline__ void convert_stage(const int8_t* rk, __nv_bfloat16* kt,
                                              __nv_bfloat16* vt, int tid) {
  using S = Bf16Smem<D, INT4>;
#pragma unroll
  for (int k = 0; k < S::PER; ++k) {
    const int e = tid + 128 * k, r = e % BK, c = e / BK;
    if (e >= BK * S::CR) break;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const uint4 w = *reinterpret_cast<const uint4*>(rk + x * S::STAGE + raw_at<S::CR>(r, c));
      __nv_bfloat16* dst = x ? vt : kt;
      if constexpr (INT4) {
        const uint4 a = int4x8_to_bf16(w.x), b = int4x8_to_bf16(w.y);
        const uint4 c2 = int4x8_to_bf16(w.z), d = int4x8_to_bf16(w.w);
        *reinterpret_cast<uint4*>(dst + sw(r, 2 * c)) = make_uint4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<uint4*>(dst + sw(r, 2 * c + 1)) = make_uint4(c2.x, c2.y, d.x, d.y);
        *reinterpret_cast<uint4*>(dst + sw(r, D / 16 + 2 * c)) = make_uint4(a.z, a.w, b.z, b.w);
        *reinterpret_cast<uint4*>(dst + sw(r, D / 16 + 2 * c + 1)) =
            make_uint4(c2.z, c2.w, d.z, d.w);
      } else {
        const uint2 a = int8x4_to_bf16(w.x), b = int8x4_to_bf16(w.y);
        const uint2 c2 = int8x4_to_bf16(w.z), d = int8x4_to_bf16(w.w);
        *reinterpret_cast<uint4*>(dst + sw(r, 2 * c)) = make_uint4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<uint4*>(dst + sw(r, 2 * c + 1)) = make_uint4(c2.x, c2.y, d.x, d.y);
      }
    }
  }
}

// One block per (sequence, kv head, q tile of 128 rows). Warpgroups 0 and
// 1, the producers, take turns over the key tiles (producer p the p-th,
// (p+2)-th, ... of the walk): cp.async of its next tile's raw rows and
// scales, then this tile's exact conversion into its bf16 stage p. The
// consumers (warpgroups 2 and 3, rows 0-63 and 64-127; warp w of each owns
// 16 rows) run S = Q·Kᵀ, the online softmax and acc += P·V on each tile in
// the walk's order and hand its stage back. Stages pass between them
// through named barriers.
template <int D, bool INT4>
__global__ void __launch_bounds__(Bf16Block<D>::NTB, 1) paged_prefill_bf16_kernel(const Params p) {
  using T = Bf16Tile<D>;
  using S = Bf16Smem<D, INT4>;
  using K = Bf16Block<D>;
  constexpr int HANDOFF = K::HANDOFF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + S::KV_OFF);  // stage s: K, V
  float* kv_scales = reinterpret_cast<float*>(smem + S::SCALE_OFF);  // stage s: K, V scales

  const int tid = threadIdx.x, wg = tid >> 7, gtid = tid & 127;
  // Heaviest first: the chunk's last q tile sees the most keys, so the q
  // tile is the grid's slow index, counted from the end.
  const int heads = p.Hkv * p.B;
  const int ntiles = (p.C + p.BQ - 1) / p.BQ;
  const int q0 = (ntiles - 1 - int(blockIdx.x / heads)) * p.BQ;
  const int kvh = blockIdx.x % p.Hkv, b = (blockIdx.x % heads) / p.Hkv;
  const Rows rows = block_rows(p, b, kvh, q0, blockIdx.y);
  // The walk's tile after the one after t0: a producer's next tile.
  auto skip_one = [&](int t0) {
    const int t1 = next_run(p, rows, t0 + BK);
    return t1 < rows.kend ? next_run(p, rows, t1 + BK) : t1;
  };

  if (wg < PRODUCERS) {
    // Producer wg: the walk's tiles wg, wg + 2, ..., each into stage wg.
    setmaxnreg_dec<56>();
    int8_t* raw = reinterpret_cast<int8_t*>(smem + S::RAW_OFF) + wg * 2 * K::RAWS * S::STAGE;
    float* raw_scales = reinterpret_cast<float*>(smem + S::RAW_SCALE_OFF) + wg * K::RAWS * 2 * BK;
    __nv_bfloat16* kt = kv + 2 * wg * T::TILE;
    // The raw K and V rows of the key tile at t0 (raw stage buf: K at
    // 2·buf·STAGE, V next), and each key's K and V scale (0 past the
    // context).
    auto issue = [&](int t0, int buf) {
      int8_t* rk = raw + 2 * buf * S::STAGE;
#pragma unroll (S::COPY_UNROLL)
      for (int k = 0; k < S::PER; ++k) {
        const int e = gtid + 128 * k, r = e / S::CR, c = e % S::CR;
        if (e >= BK * S::CR) break;
        const int kpos = t0 + r;
        const bool ok = kpos < rows.kend;
        const int page = ok ? rows.table[kpos / p.P] : 0;
        const size_t src = ((rows.head_pages + page) * p.P + (ok ? kpos % p.P : 0)) * S::RB + 16 * c;
        cp_async16(rk + raw_at<S::CR>(r, c), p.kp + src, ok);
        cp_async16(rk + S::STAGE + raw_at<S::CR>(r, c), p.vp + src, ok);
      }
      if (gtid < BK) {
        const int kpos = t0 + gtid;
        const bool ok = kpos < rows.kend;
        const size_t sidx = scale_index(p, rows, kpos, ok);
        float* sk = raw_scales + 2 * buf * BK;
        cp_async4(sk + gtid, p.ks + sidx, ok);
        cp_async4(sk + BK + gtid, p.vs + sidx, ok);
      }
      cp_async_commit();
    };
    int t0 = next_run(p, rows, rows.kstart);
    if (wg == 1 && t0 < rows.kend) t0 = next_run(p, rows, t0 + BK);
    if (t0 < rows.kend) issue(t0, 0);
    for (int i = 0; t0 < rows.kend; ++i) {
      const int buf = K::RAWS == 2 ? i & 1 : 0;
      cp_async_wait_all();
      bar_sync(PRODUCER + wg, 128);  // raw stage buf landed; the other one is converted
      const int tn = skip_one(t0);
      if constexpr (K::RAWS == 2) {
        if (tn < rows.kend) issue(tn, buf ^ 1);
      }
      if (i > 0) bar_sync(EMPTY + wg, HANDOFF);  // the consumers are done with stage wg
      convert_stage<D, INT4>(raw + 2 * buf * S::STAGE, kt, kt + T::TILE, gtid);
      kv_scales[2 * wg * BK + gtid] = raw_scales[2 * buf * BK + gtid];
      fence_async_shared();
      bar_arrive(FULL + wg, HANDOFF);  // stage wg holds this tile
      if constexpr (K::RAWS == 1) {
        if (tn < rows.kend) {
          bar_sync(PRODUCER + wg, 128);  // every thread has read the raw stage
          issue(tn, 0);
        }
      }
      t0 = tn;
    }
    return;
  }

  // Consumers.
  setmaxnreg_inc<K::CONSUMER_REGS>();
  const int cw = wg - PRODUCERS, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (p.splits > 1 && next_run(p, rows, rows.kstart) >= rows.kend) {
    // An empty split: m = -inf and l = 0; the merge never reads its sums.
    // (Split scratch row: split · plane + the row; l's plane follows the
    // splits' m.)
    const size_t plane = size_t(p.B) * p.Hq * p.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * cw + 16 * warp + g + 8 * h;
      const int gi = r / p.BQ, qi = q0 + r % p.BQ;
      if (t != 0 || gi >= p.G || qi >= p.C) continue;
      const size_t slot = blockIdx.y * plane + (size_t(b) * p.Hq + kvh * p.G + gi) * p.C + qi;
      p.ml[slot] = -INFINITY;
      p.ml[p.splits * plane + slot] = 0.f;
    }
    return;
  }
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem) + cw * T::TILE;
  // This consumer's 64 Q rows (block rows 64cw..), unscaled bf16; rows past
  // the group or the chunk are 0.
  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q);
  for (int e = gtid; e < 64 * T::CPR; e += 128) {
    const int r = e / T::CPR, c = e % T::CPR;
    const int br = 64 * cw + r;
    const int gi = br / p.BQ, qi = q0 + br % p.BQ;
    const bool ok = gi < p.G && qi < p.C;
    const size_t src = ok ? ((size_t(b) * p.Hq + kvh * p.G + gi) * p.C + qi) * D + 8 * c : 0;
    cp_async16(qs + sw(r, c), qg + src, ok);
  }
  cp_async_commit();
  stage_landed();
  bar_sync(QREADY + cw, 128);

  // This thread's rows g and g + 8 of its warp's 16, their positions, and
  // the warp's range of positions over its rows that exist.
  int qpos[2], wq_lo = INT_MAX, wq_hi = INT_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * cw + 16 * warp + g + 8 * h;
    qpos[h] = rows.qlo + r % p.BQ;
    if (r / p.BQ < p.G && q0 + r % p.BQ < p.C) {
      wq_lo = min(wq_lo, qpos[h]);
      wq_hi = max(wq_hi, qpos[h]);
    }
  }
  wq_lo = __reduce_min_sync(0xffffffffu, wq_lo);
  wq_hi = __reduce_max_sync(0xffffffffu, wq_hi);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float acc[T::ND][4];
  zero(acc);

  // The scores s[n][e] (row g + 8(e >> 1), key 8n + 2t + (e & 1) of the
  // tile) become the f32 p in place, p = 2^(x·log2 e − m·log2 e) on the
  // SFU; the running max, l and acc follow (acc only when a row's max
  // moved).
  auto softmax_tile = [&](auto unmasked_tag, auto cap_tag, float (&s)[8][4], const float* sk,
                          int t0) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr bool CAP = decltype(cap_tag)::value;
    float kc[8][2];  // sm_scale · k_scale of this thread's keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * n + 2 * t);
      kc[n][0] = p.sm_scale * k2.x;
      kc[n][1] = p.sm_scale * k2.y;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[n][2 * h + j] * kc[n][j];
          if (CAP) x = p.softcap * tanhf(x / p.softcap);
          if (!UNMASKED && !key_visible(p, t0 + 8 * n + 2 * t + j, qpos[h], rows.kend)) {
            x = p.mask_value;
          }
          s[n][2 * h + j] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_next = fmaxf(m[h], mt);
      alpha[h] = expf(m[h] - m_next);
      const bool live = UNMASKED || m_next > p.mask_half;
      m[h] = m_next;
      const float m2 = m_next * LOG2E;
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pe = live ? ex2(fmaf(s[n][2 * h + j], LOG2E, -m2)) : 0.f;
          ls += pe;
          s[n][2 * h + j] = pe;
        }
      l[h] = alpha[h] * l[h] + ls;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < T::ND; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
    }
  };

  int t0 = next_run(p, rows, rows.kstart);
  for (int i = 0; t0 < rows.kend; ++i) {
    const int s = i % PRODUCERS;
    const int tn = next_run(p, rows, t0 + BK);
    const __nv_bfloat16* kt = kv + 2 * s * T::TILE;
    const __nv_bfloat16* vt = kt + T::TILE;
    const float* sk = kv_scales + 2 * s * BK;
    bar_sync(FULL + s, HANDOFF);  // stage s holds the tile at t0

    // S = Q·Kᵀ for this consumer's 64 rows.
    float sc[8][4];
    zero(sc);
    wgmma_fence();
    fence_operands(sc);
#pragma unroll
    for (int kc = 0; kc < T::KC; ++kc)
      wgmma_m64n64(sc, tile_desc(qs, 0, kc), tile_desc(kt, 0, kc), kc);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(sc);

    const int t_last = min(t0 + BK, rows.kend) - 1;
    const bool warp_runs = wq_lo <= wq_hi && t0 <= wq_hi &&
                           (p.window < 0 || t_last > wq_lo - p.window || t0 < p.sinks);
    if (warp_runs) {
      const bool unmasked = t0 + BK <= rows.kend && t0 + BK - 1 <= wq_lo &&
                            (p.window < 0 || t0 > wq_hi - p.window);
      with_tags(unmasked, p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
        softmax_tile(unmasked_tag, cap_tag, sc, sk, t0);
      });
    } else {
      zero(sc);
    }

    // acc += P·V: each key's V scale folded into p, rounded to bf16 once,
    // as the register A fragments (k16 step kk: keys 16kk..16kk+15).
    {
      float vc[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 v2 = *reinterpret_cast<const float2*>(sk + BK + 8 * n + 2 * t);
        vc[n][0] = v2.x;
        vc[n][1] = v2.y;
      }
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 2 * kk + hh;
            a[kk][2 * hh + r] = bf162_bits(
                __floats2bfloat162_rn(sc[n][2 * r] * vc[n][0], sc[n][2 * r + 1] * vc[n][1]));
          }
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(vt, 16 * kk));
      wgmma_commit();
      wgmma_wait0();
      fence_operands(acc);
    }
    // Producer s converts the tile after next into stage s.
    if (skip_one(t0) < rows.kend) bar_arrive(EMPTY + s, HANDOFF);
    t0 = tn;
  }

  float lrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * cw + 16 * warp + g + 8 * h;
    const int gi = r / p.BQ, qi = q0 + r % p.BQ;
    if (gi >= p.G || qi >= p.C) continue;
    const size_t row = (size_t(b) * p.Hq + kvh * p.G + gi) * p.C + qi;
    const float l_inv = lrow[h] == 0.f ? 1.f : 1.f / lrow[h];
    if (p.splits > 1) {
      // This split's unnormalised sums, m and l, for the merge.
      const size_t plane = size_t(p.B) * p.Hq * p.C;
      const size_t slot = blockIdx.y * plane + row;
      float* pr = p.part + slot * D;
#pragma unroll
      for (int c = 0; c < T::ND; ++c)
        *reinterpret_cast<float2*>(pr + 8 * c + 2 * t) = make_float2(acc[c][2 * h], acc[c][2 * h + 1]);
      if (t == 0) {
        p.ml[slot] = m[h];
        p.ml[p.splits * plane + slot] = lrow[h];
      }
      continue;
    }
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(p.o) + row * D;
#pragma unroll
    for (int c = 0; c < T::ND; ++c)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[c][2 * h] * l_inv, acc[c][2 * h + 1] * l_inv);
    if (p.lse != nullptr && t == 0) {
      p.lse[row] = lrow[h] == 0.f ? -INFINITY : m[h] + logf(fmaxf(lrow[h], 1e-38f));
    }
  }
}

// One block per row (sequence, q head, q position), a thread per column:
// the row's splits merged by lse in split order (bf16 q). A split with m =
// -inf saw nothing: it is skipped before exp (-inf - -inf is NaN) and its
// sums are never read.
template <int D>
__global__ void __launch_bounds__(D) prefill_merge_kernel(const Params p) {
  const int d = threadIdx.x;
  const size_t plane = size_t(p.B) * p.Hq * p.C;
  const size_t row = blockIdx.x;
  const float* m = p.ml + row;
  const float* l = m + size_t(p.splits) * plane;
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, m[s * plane]);
  float lsum = 0.f, acc = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float ms = m[s * plane];
    if (ms == -INFINITY) continue;
    const float w = expf(ms - mx);
    lsum += w * l[s * plane];
    acc += w * p.part[(s * plane + row) * D + d];
  }
  reinterpret_cast<__nv_bfloat16*>(p.o)[row * D + d] =
      __float2bfloat16_rn(acc * (lsum == 0.f ? 1.f : 1.f / lsum));
  if (d == 0 && p.lse != nullptr) {
    p.lse[row] = lsum == 0.f ? -INFINITY : mx + logf(fmaxf(lsum, 1e-38f));
  }
}

// ---------------------------------------------------------------------------

template <int D, bool INT4>
cudaError_t launch_bf16(Params p, cudaStream_t stream) {
  constexpr int smem = Bf16Smem<D, INT4>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_bf16_kernel<D, INT4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.BQ = Bf16Block<D>::BROWS / p.G;
  const unsigned blocks = unsigned((p.C + p.BQ - 1) / p.BQ) * p.Hkv * p.B;
  paged_prefill_bf16_kernel<D, INT4>
      <<<dim3(blocks, p.splits), Bf16Block<D>::NTB, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  prefill_merge_kernel<D><<<unsigned(p.B * p.Hq * p.C), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool INT4>
cudaError_t launch(Params p, bool q_bf16, cudaStream_t stream) {
  if (q_bf16) return launch_bf16<D, INT4>(p, stream);
  constexpr int smem = F32Smem<D, INT4>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_f32_kernel<D, INT4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.BQ = ROWS / p.G;
  dim3 grid((p.C + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  paged_prefill_f32_kernel<D, INT4><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool INT4>
int dispatch(const Params& p, int D, int q_bf16, void* stream) {
  if (p.G < 1 || p.G > ROWS || p.subs < 1 || p.P % p.subs || p.splits < 1 ||
      (p.splits > 1 && (!q_bf16 || p.part == nullptr || p.ml == nullptr ||
                        p.split_keys < BK || p.split_keys % BK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.B == 0 || p.C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32, INT4>(p, q_bf16 != 0, s); break;
    case 64: err = launch<64, INT4>(p, q_bf16 != 0, s); break;
    case 128: err = launch<128, INT4>(p, q_bf16 != 0, s); break;
    case 256: err = launch<256, INT4>(p, q_bf16 != 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* lengths, const void* qstarts, const void* tables,
                   void* o, void* lse, void* part, void* ml, int B, int Hq, int Hkv, int C,
                   int num_pages, int P, int max_pages, int subs, int splits,
                   int pages_per_split, float sm_scale, int has_softcap, float softcap,
                   int window, int sinks, float mask_value, float mask_half) {
  Params p;
  p.q = q;
  p.kp = static_cast<const int8_t*>(kp);
  p.vp = static_cast<const int8_t*>(vp);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.lengths = static_cast<const int*>(lengths);
  p.qstarts = static_cast<const int*>(qstarts);
  p.tables = static_cast<const int*>(tables);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.part = static_cast<float*>(part);
  p.ml = static_cast<float*>(ml);
  p.splits = splits;
  p.split_keys = pages_per_split * P;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.C = C;
  p.num_pages = num_pages;
  p.P = P;
  p.max_pages = max_pages;
  p.G = Hq / Hkv;
  p.BQ = 1;  // set by the launch: the block's rows over the group
  p.subs = subs;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.mask_value = mask_value;
  p.mask_half = mask_half;
  p.has_softcap = has_softcap;
  p.window = window;
  p.sinks = sinks;
  return p;
}

}  // namespace

// part [splits, B, Hq, C, D] and ml [2, splits, B, Hq, C] f32 scratch (NULL
// when splits == 1; splits > 1 takes bf16 q); split s walks logical pages
// [s * pages_per_split, (s + 1) * pages_per_split), a whole number of
// 64-key tiles.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp, const void* ks,
                             const void* vs, const void* lengths, const void* qstarts,
                             const void* tables, void* o, void* lse, void* part, void* ml, int B,
                             int Hq, int Hkv, int C, int num_pages, int P, int max_pages, int D,
                             int splits, int pages_per_split, float sm_scale, int has_softcap,
                             float softcap, int window, int sinks, float mask_value,
                             float mask_half, int q_bf16, void* stream) {
  const Params p = make_params(q, kp, vp, ks, vs, lengths, qstarts, tables, o, lse, part, ml, B,
                               Hq, Hkv, C, num_pages, P, max_pages, 1, splits, pages_per_split,
                               sm_scale, has_softcap, softcap, window, sinks, mask_value,
                               mask_half);
  return dispatch<false>(p, D, q_bf16, stream);
}

// INT4 pages [Hkv, num_pages, P, D/2], scales [Hkv, num_pages, subs].
extern "C" int paged_prefill_int4(const void* q, const void* kp, const void* vp, const void* ks,
                                  const void* vs, const void* lengths, const void* qstarts,
                                  const void* tables, void* o, void* lse, void* part, void* ml,
                                  int B, int Hq, int Hkv, int C, int num_pages, int P,
                                  int max_pages, int D, int subs, int splits,
                                  int pages_per_split, float sm_scale, int has_softcap,
                                  float softcap, int window, int sinks, float mask_value,
                                  float mask_half, int q_bf16, void* stream) {
  const Params p = make_params(q, kp, vp, ks, vs, lengths, qstarts, tables, o, lse, part, ml, B,
                               Hq, Hkv, C, num_pages, P, max_pages, subs, splits,
                               pages_per_split, sm_scale, has_softcap, softcap, window, sinks,
                               mask_value, mask_half);
  return dispatch<true>(p, D, q_bf16, stream);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
