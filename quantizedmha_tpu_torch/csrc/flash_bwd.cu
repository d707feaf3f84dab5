// FlashAttention-2 backward in bf16 or f32 for Hopper (sm_90a): two kernels,
// kv-stationary dK/dV and q-stationary dQ.
//
// Replaces the Pallas TPU kernels quantizedmha_tpu/ops/flash_attention.py:507
// _bwd_dkv_kernel (flash_bwd_dkv) and :600 _bwd_dq_kernel (flash_bwd_dq), the
// backward of the float flash forward (flash_fwd.cu) in every training step.
//
// Numerics contract (what _flash_bwd_plain in ops/flash_attention.py
// computes, up to the f32 summation order and a few ulps of exp/tanh):
//   s = (Q·Kᵀ)·sm_scale (Q unscaled, as the TPU backward does), softcap s =
//   cap·tanh(s/cap), p = valid ? exp(s − lse) : 0 in f32 (a fully masked row
//   has lse = −inf and no valid pair, so p is exactly 0, never exp(+inf)·0),
//   ds = p·(dp − di)·sm_scale from the f32 p, times 1 − tanh² under softcap,
//   where dp = dO·Vᵀ and di = rowsum(dO·O) (the wrapper's f32 prepass) −
//   dlse (folded here). dV = PᵀdO and dK = dSᵀQ summed over the GQA group,
//   dQ = dS·K, each accumulated in f32 and cast once to the inputs' dtype.
//   Masks at global positions (offs [B, 2]): causal kpos <= qpos, window
//   qpos − kpos < window OR kpos < sinks, and the q and kv edges.
//   bf16 inputs: the TPU backward runs its dots at Precision.DEFAULT, one
//   bf16 pass, so S and dP are sums of exact products of the bf16 inputs and
//   P and dS enter dV, dK and dQ rounded to bf16 (round to nearest even).
//   Here all five products run on the tensor cores (wgmma, bf16 operands,
//   f32 accumulation) with P and dS rounded the same way.
//   f32 inputs: Precision.HIGHEST, every product a true f32 FMA on the CUDA
//   cores (never TF32), P and dS in f32.
//
// What bounds them on the H100: at the training shape (B=1, H=32, Hkv=8,
// S=2048, d=128, bf16, causal) dK/dV does four products of 2·d flop a
// visible (q, key) pair (S, dP, dV, dK) and dQ three (S, dP, dQ): 6.9e10 and
// 5.2e10 flop, 0.069 and 0.052 ms at the 989 TFLOP/s bf16 peak; the 6.7e7
// exponentials a kernel (0.016 ms on the SFUs) and the ~50 MB of operands
// (0.015 ms) are below that, so the bound is the tensor cores. Between the
// products sits per-pair f32 work (exp, masks, the ds chain, bf16 packing)
// that the tensor cores wait on, and the causal mask makes the work of a
// block uneven: the dK/dV block of key tile 0 walks every q tile of its
// group, the last one a single tile per head.
//
// What this design does about it (bf16): one warpgroup (4 warps) computes
// each 64 x 64 score tile with wgmma, both operands read by the tensor
// cores straight from shared memory (Q·Kᵀ and dO·Vᵀ in dQ; the transposed
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in dK/dV, so that keys are the rows); warp w
// owns the accumulator rows 16w..16w+15, whose fragments are those of
// mma.sync, so P and dS stay in registers: p and ds in f32 in place,
// packed to bf16 as the register A operand of the second products' wgmma
// (PᵀdO, dSᵀQ; dS·K), whose B (dO, Q; K) the tensor cores read transposed
// (MN-major) from the same tiles. Tiles stay bf16 in wgmma's 128-byte-
// swizzled layout; the streamed ones (Q, dO and their lse/di/dlse rows in
// dK/dV; K and V in dQ) are double-buffered with cp.async, so the next
// tile's copy overlaps this tile's math. Per-pair choices (a fully valid
// warp tile, softcap) are compile-time: a runtime branch inside the
// unrolled per-pair loop is if-converted, and tanh ran for every pair.
// Load balance: the grid puts the tile index in its slow dimension,
// heaviest first (key tile 0 in dK/dV, the last q tile in dQ). dK/dV has
// only 256 blocks at the training shape and the heaviest does 32x the
// work of the lightest, so one block is two warpgroups that take turns
// over the (q head, q tile) steps of its key tile, each with its own
// stages and named barrier (164 KB, one block of 8 warps an SM): the
// heaviest tile gets a whole SM and its walk halves. Each group sums dK and
// dV over its steps in registers; at the end group 1 hands its sums to
// group 0 through shared memory, added in that fixed order: no atomics,
// and the same bits every launch. dQ (1024 blocks, evenly loaded under the
// heaviest-first order): one warpgroup, 97 KB, two blocks an SM.
// Registers at d=128: a dK/dV thread holds 2·16·d/32 = 128 f32 of
// accumulators, so it computes Sᵀ and dPᵀ 32 q rows at a time (32 more);
// a dQ thread 64 of dQ and 64 of S and dP. ptxas -v: no spills.
// Tiles wholly above the diagonal or behind the window are skipped exactly
// (sink tiles stay visible); a warp whose 16 rows see nothing in a tile
// skips its per-pair work and adds zeros. Each wgmma sequence is waited on
// before its results are read: the score products do not yet overlap the
// per-pair work (warp specialisation and TMA are later work).
//
// f32 (flash_bwd_dkv_f32_kernel, flash_bwd_dq_f32_kernel, every head dim;
// Gemma-2 trained in f32 at d=256). What bounds them: at Gemma-2-9B's
// training shape (below) dK/dV does 1.1e12 flop and dQ 8.3e11 (8.2e11 and
// 6.2e11 under the 4096 window) as true f32 FMAs on the CUDA cores, 16.4 /
// 12.3 ms and 12.4 / 9.3 ms at 67 TFLOP/s; the bytes (~0.5 GB) are far
// below. 256 threads, each owning 4 x 4 of a 64 x 64 score tile and 4 rows
// x d/16 columns of a 64-row accumulator; P and dS go through shared
// memory. The layout is set by d=256: [64][260] f32 tiles are 66,560 bytes
// each, so dQ's Q, dO, K, V and dS would take 284,160 bytes and dK/dV's K,
// V, Q, dO, Pᵀ and dSᵀ 301,568, over the 232,448 a block may have. So each
// kernel keeps one tile that takes turns (land(): cp.async, waited on and
// barriered), 217,600 bytes at d=256 (119,296 at 128), one block of 8
// warps an SM: dQ (Q, dO resident) lands V, keeps dP = dO·Vᵀ in registers,
// then lands K in the same tile for S, dS and dQ += dS·K (two landings a
// key tile); dK/dV (K, V resident) lands Q for Sᵀ, dO for dPᵀ (both kept in
// registers), writes Pᵀ for dV += Pᵀ·dO, then dSᵀ over Pᵀ and Q again for
// dK += dSᵀ·Q (three landings a step: Pᵀ and dSᵀ side by side would need
// 235,008 bytes). The same layout runs every head dim: the sums run in the
// same order as with K, V (dQ) or Q, dO (dK/dV) resident side by side. A
// dK/dV thread holds 2·4·d/16 f32 of accumulators (128 at d=256) beside 32
// of Sᵀ and dPᵀ and 32 of float4 operands, inside the 255 registers of a
// 256-thread block (the bf16 kernels' split into two warp groups by column
// halves was not needed: ptxas -v on the H100, sm_90a, at d=256 254
// registers for dK/dV and 248-250 for dQ, 0 bytes of spill). At the
// training shape dK/dV runs at 2.1x the CUDA cores' bound and dQ at 2.1x
// (34.98 / 26.39 ms, NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's
// kernels phase). Not chosen: 32-key dK/dV blocks with Q and dO resident
// (twice the blocks re-reading each Q/dO tile). The landings are not
// overlapped with the products (the tile is in use until the next lands),
// the softcap branch is a template argument, tiles wholly above the
// diagonal or behind the window are never landed, and the grid runs the
// heaviest tiles first (key tile 0 in dK/dV, the last q tile in dQ). No
// atomics: dK and dV sum the group's q heads in order in registers.
//
// d=256 bf16 (Gemma-2's bf16 training path). What bounds
// it: at the Gemma-2-9B training shape (B=1, H=16, Hkv=8, S=8192, causal,
// softcap 50) dK/dV does 1.1e12 flop and dQ 8.3e11 over the visible pairs,
// 1.11 and 0.83 ms at 989 TFLOP/s (0.83 and 0.63 ms under the 4096 window);
// the diagonal and window-edge tiles are computed whole, 0.8% more pairs.
// The 5.4e8 exponentials and ~0.27 GB of operands and outputs are far
// below that: the tensor cores. The d<=128 design does not carry over: a dK/dV thread of
// one warp group would hold 2·16·256/32 = 256 f32 of accumulators (a
// thread has 255 registers), and a group's own Q/dO stages take 64 KB
// each. So both kernels run two warp groups on every step, each owning a
// column half of the accumulators (dK and dV 128 registers a thread, dQ
// 64), and split the score products by rows instead of recomputing them:
// group j computes Sᵀ and dPᵀ of the 64 keys against q rows 32j..32j+31
// (dQ: S and dP of the 64 q rows against keys 32j..32j+31), writes P and dS
// rounded to bf16 into a [64][64] swizzled tile in shared memory, and
// after a block barrier each group runs the second products over all 64
// rows for its half, m64n128k16 with A and B read from shared memory (B's
// descriptor 16 KB on, column block 2, for the second half). Not chosen:
// one group computing the scores and handing Pᵀ to a dV-only group (3 of
// the 4 products and all per-pair work in one group); both groups
// recomputing Sᵀ and dPᵀ for a d split (50% more products); dK/dV in
// shared memory (128 KB of f32 beside K, V and the stages does not fit).
// Shared memory: dK/dV K, V, two shared stages of Q/dO, Pᵀ, dSᵀ and the
// stats, 215,552 bytes; dQ Q, dO, two stages of K/V and dS, 205,824: one
// block of 8 warps an SM. ptxas -v on the H100 (sm_90a):
// flash_bwd_dkv_d256_kernel 223-224 registers, flash_bwd_dq_d256_kernel 158,
// 0 bytes of spill each, no serialized wgmma (C7514). As at d<=128 each
// wgmma sequence is waited on before its results are read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BR = 64;    // rows of a tile: q rows or keys
constexpr int NT = 256;   // threads of an f32 block
constexpr int NTB = 128;  // threads of a bf16 dQ block: 4 warps of 16 q rows

struct Params {
  const void* q;     // [B, H, Sq, D]
  const void* k;     // [B, Hkv, Skv, D]
  const void* v;     // [B, Hkv, Skv, D]
  const void* dout;  // [B, H, Sq, D]
  const float* lse;  // [B, H, Sq]
  const float* di;   // [B, H, Sq] rowsum(dO·O) in f32
  const float* dlse; // [B, H, Sq] or nullptr
  const int* offs;   // [B, 2] global (q_off, kv_off)
  void* dq;          // [B, H, Sq, D], q's dtype
  void* dk;          // [B, Hkv, Skv, D]
  void* dv;          // [B, Hkv, Skv, D]
  int B, H, Hkv, Sq, Skv;
  float sm_scale, softcap;
  int has_softcap, causal, window, sinks;  // window < 0: none
};

// Block-level skip at global positions, as flash_fwd.cu: false when every
// pair of the two ranges is above the causal diagonal or behind the window.
__device__ __forceinline__ bool range_should_run(const Params& p, int first_q, int last_q,
                                                 int first_kv, int last_kv) {
  if (!p.causal) return true;
  bool run = last_q >= first_kv;
  if (p.window >= 0) {
    bool in_window = (first_q - last_kv) < p.window;
    if (p.sinks) in_window |= first_kv < p.sinks;
    run &= in_window;
  }
  return run;
}

// True when every pair of local q rows [q_lo, q_hi] and local keys [k_lo,
// k_hi] is valid: inside both edges, on or below the diagonal, in the window.
__device__ __forceinline__ bool range_unmasked(const Params& p, int q_lo, int q_hi, int k_lo,
                                               int k_hi, int q_off, int kv_off) {
  if (q_hi >= p.Sq || k_hi >= p.Skv) return false;
  if (!p.causal) return true;
  bool ok = k_hi + kv_off <= q_lo + q_off;
  if (p.window >= 0) ok &= (q_hi + q_off) - (k_lo + kv_off) < p.window;
  return ok;
}

// _mk_mask of the TPU backward: edges, causal, window and sinks.
__device__ __forceinline__ bool pair_valid(const Params& p, int qloc, int kloc, int q_off,
                                           int kv_off) {
  bool valid = qloc < p.Sq && kloc < p.Skv;
  if (p.causal) {
    const int qpos = qloc + q_off, kpos = kloc + kv_off;
    valid &= kpos <= qpos;
    if (p.window >= 0) {
      bool in_win = (qpos - kpos) < p.window;
      if (p.sinks) in_win |= kpos < p.sinks;
      valid &= in_win;
    }
  }
  return valid;
}

// (p, ds) of one pair from its raw dot Q·K (dot) and dO·V (dp). CAP (1 or
// 0: softcap on or off) is a compile-time choice: a runtime branch inside an
// unrolled per-pair loop is if-converted, so tanh would run for every pair.
template <int CAP>
__device__ __forceinline__ float2 score_grad(const Params& p, bool valid, float dot, float dp,
                                             float lse, float di) {
  constexpr bool capped = CAP == 1;
  float s = dot * p.sm_scale;
  float th = 0.f;
  if (capped) {
    th = tanhf(s / p.softcap);
    s = p.softcap * th;
  }
  const float pe = valid ? expf(s - lse) : 0.f;
  float ds = pe * (dp - di) * p.sm_scale;
  if (capped) ds *= 1.f - th * th;
  return make_float2(pe, ds);
}

// di − dlse of q row `at` (the lse cotangent folds into di).
__device__ __forceinline__ float row_di(const Params& p, size_t at) {
  float d = p.di[at];
  if (p.dlse != nullptr) d = d - p.dlse[at];
  return d;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.

template <int N>
struct VecF;
template <>
struct VecF<2> {
  using T = float2;
};
template <>
struct VecF<4> {
  using T = float4;
};

template <int D>
struct Tile {
  static constexpr int ROW = D + 4;        // floats per padded q/K/V/dO row
  static constexpr int PROW = BR + 4;      // floats per P or dS row
  static constexpr int SZ = BR * ROW;
  static constexpr int CPT = D / 16;       // accumulator columns a thread
  static constexpr int VW = CPT < 4 ? CPT : 4;
  static constexpr int NV = CPT / VW;
  using Vec = typename VecF<VW>::T;
};

// s[i][j] = a[4ty + i] · b[tx + 16j] over D, true f32 FMAs.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b, float (&s)[4][4]) {
  constexpr int ROW = Tile<D>::ROW;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * ROW + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ROW + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum_k w[4ty + i][k] · m[k][col c], w: [64][PROW], m: [64][ROW].
template <int D>
__device__ __forceinline__ void acc_tile(const float* w, const float* m, float (&acc)[4][D / 16]) {
  using T = Tile<D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int k = 0; k < BR; k += 4) {
    float4 wr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wr[i] = *reinterpret_cast<const float4*>(w + (ty * 4 + i) * T::PROW + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wk[i] = kk == 0 ? wr[i].x : kk == 1 ? wr[i].y : kk == 2 ? wr[i].z : wr[i].w;
#pragma unroll
      for (int nv = 0; nv < T::NV; ++nv) {
        const typename T::Vec mv =
            *reinterpret_cast<const typename T::Vec*>(m + (k + kk) * T::ROW + tx * T::VW + 16 * T::VW * nv);
        const float* mf = reinterpret_cast<const float*>(&mv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int x = 0; x < T::VW; ++x)
            acc[i][nv * T::VW + x] = fmaf(wk[i], mf[x], acc[i][nv * T::VW + x]);
      }
    }
  }
}

// Rows r0 + 4ty + i (< n) of a [n][D] output from the accumulator.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int r0, int n, const float (&acc)[4][D / 16]) {
  using TL = Tile<D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const int col = tx * TL::VW + 16 * TL::VW * (c / TL::VW) + c % TL::VW;
      dst[size_t(row) * D + col] = acc[i][c];
    }
  }
}

// lse and di − dlse of q rows r0.. of one (batch, head) into shared memory
// (rows past Sq: 0, their pairs are masked).
__device__ __forceinline__ void load_row_stats(const Params& p, size_t bh, int r0, float* lse_s,
                                               float* di_s) {
  const int r = threadIdx.x;
  if (r < BR) {
    const int row = r0 + r;
    float l = 0.f, d = 0.f;
    if (row < p.Sq) {
      const size_t at = bh * p.Sq + row;
      l = p.lse[at];
      d = row_di(p, at);
    }
    lse_s[r] = l;
    di_s[r] = d;
  }
}

// ---------------------------------------------------------------------------
// Shared memory of both f32 kernels: three [64][ROW] f32 tiles, a [64][68]
// P/dS tile and the rows' stats (217,600 bytes at d=256, 119,296 at 128);
// the tile that takes turns is filled by land(), whose copies are waited
// on and barriered before it returns.
template <int D>
struct F32Smem {
  using T = Tile<D>;
  static constexpr int BYTES = (3 * T::SZ + BR * T::PROW + 2 * BR) * 4;
  static_assert(BYTES <= 232448, "shared memory of a block");
};

// Rows r0.. of a row-major [n][D] f32 matrix into a [64][ROW] tile by
// cp.async (rows past n zero-filled), then every thread's copies waited on
// and the block barriered: the tile is whole when this returns.
template <int D>
__device__ __forceinline__ void land(float* dst, const float* src, int r0, int n) {
  constexpr int ROW = Tile<D>::ROW, CPR = D / 4;
  for (int e = threadIdx.x; e < BR * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * ROW + 4 * c, src + size_t(ok ? r0 + r : 0) * D + 4 * c, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// dQ: one block per (batch, q head, 64-row q tile), heaviest q tile first;
// Q, dO and the rows' stats resident. Per visible key tile, V lands in the
// one K/V tile and dP = dO·Vᵀ goes to registers; then K lands in the same
// tile, S = Q·Kᵀ, dS is written and dQ += dS·K.
template <int D, int CAP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_f32_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + T::SZ;
  float* kvt = dos + T::SZ;  // V of the key tile, then its K
  float* dss = kvt + T::SZ;
  float* lse_s = dss + BR * T::PROW;
  float* di_s = lse_s + BR;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t bh = size_t(b) * p.H + h;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const float* kg = reinterpret_cast<const float*>(p.k) + kvbase;
  const float* vg = reinterpret_cast<const float*>(p.v) + kvbase;
  const int first_q = q_off + q0, last_q = q_off + min(q0 + BR, p.Sq) - 1;
  auto next_run = [&](int t0) {
    while (t0 < p.Skv &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BR, p.Skv) - 1))
      t0 += BR;
    return t0;
  };

  load_row_stats(p, bh, q0, lse_s, di_s);
  land<D>(qs, reinterpret_cast<const float*>(p.q) + bh * p.Sq * D, q0, p.Sq);
  land<D>(dos, reinterpret_cast<const float*>(p.dout) + bh * p.Sq * D, q0, p.Sq);
  float acc[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc[i][c] = 0.f;

  for (int t0 = next_run(0); t0 < p.Skv; t0 = next_run(t0 + BR)) {
    land<D>(kvt, vg, t0, p.Skv);
    float s[4][4], dp[4][4];
    dot_tile<D>(dos, kvt, dp);  // dP = dO·Vᵀ
    __syncthreads();            // every thread is done with V
    land<D>(kvt, kg, t0, p.Skv);
    dot_tile<D>(qs, kvt, s);    // S = Q·Kᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const bool valid = pair_valid(p, q0 + r, t0 + key, q_off, kv_off);
        const float ds = score_grad<CAP>(p, valid, s[i][j], dp[i][j], lse_s[r], di_s[r]).y;
        dss[r * T::PROW + key] = ds;
      }
    }
    __syncthreads();            // the dS tile is complete
    acc_tile<D>(dss, kvt, acc); // dQ += dS·K
    __syncthreads();            // every thread is done with K and dS
  }
  store_rows<D>(reinterpret_cast<float*>(p.dq) + bh * p.Sq * D, q0, p.Sq, acc);
}

// dK/dV: one block per (batch, kv head, 64-key tile), key tile 0 (the
// heaviest under the causal mask) first; K and V resident. Per visible (q
// head, q tile) of the GQA group, in order: Q lands and Sᵀ = K·Qᵀ goes to
// registers; dO lands in Q's tile and dPᵀ = V·dOᵀ goes to registers; p and
// ds in place, Pᵀ written and dV += Pᵀ·dO; dSᵀ written over Pᵀ, Q lands
// again and dK += dSᵀ·Q.
template <int D, int CAP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_f32_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + T::SZ;
  float* qd = vs + T::SZ;  // Q of the step, then its dO, then its Q again
  float* pds = qd + T::SZ; // Pᵀ of the step, then its dSᵀ [key][q row]
  float* lse_s = pds + BR * T::PROW;
  float* di_s = lse_s + BR;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.y * BR;
  const int kvh = blockIdx.x % p.Hkv, b = blockIdx.x / p.Hkv;
  const int group = p.H / p.Hkv;
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const int first_kv = kv_off + k0, last_kv = kv_off + min(k0 + BR, p.Skv) - 1;
  auto next_q = [&](int q0) {
    while (q0 < p.Sq &&
           !range_should_run(p, q_off + q0, q_off + min(q0 + BR, p.Sq) - 1, first_kv, last_kv))
      q0 += BR;
    return q0;
  };

  land<D>(ks, reinterpret_cast<const float*>(p.k) + kvbase, k0, p.Skv);
  land<D>(vs, reinterpret_cast<const float*>(p.v) + kvbase, k0, p.Skv);
  float acc_k[4][T::CPT], acc_v[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int hd = 0; hd < group; ++hd) {  // the group's q heads, in order
    const size_t bh = size_t(b) * p.H + size_t(kvh) * group + hd;
    const float* qg = reinterpret_cast<const float*>(p.q) + bh * p.Sq * D;
    const float* dog = reinterpret_cast<const float*>(p.dout) + bh * p.Sq * D;
    for (int q0 = next_q(0); q0 < p.Sq; q0 = next_q(q0 + BR)) {
      __syncthreads();  // every thread is done with the last step's Q, dSᵀ and stats
      load_row_stats(p, bh, q0, lse_s, di_s);
      land<D>(qd, qg, q0, p.Sq);
      // Transposed tiles: st[i][j] pairs key 4ty + i with q row tx + 16j.
      float st[4][4], dpt[4][4];
      dot_tile<D>(ks, qd, st);   // Sᵀ = K·Qᵀ
      __syncthreads();           // every thread is done with Q
      land<D>(qd, dog, q0, p.Sq);
      dot_tile<D>(vs, qd, dpt);  // dPᵀ = V·dOᵀ
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool valid = pair_valid(p, q0 + r, k0 + key, q_off, kv_off);
          const float2 pd = score_grad<CAP>(p, valid, st[i][j], dpt[i][j], lse_s[r], di_s[r]);
          pds[key * T::PROW + r] = pd.x;  // Pᵀ
          dpt[i][j] = pd.y;               // dSᵀ, kept for after dV
        }
      }
      __syncthreads();                // Pᵀ is complete
      acc_tile<D>(pds, qd, acc_v);    // dV += Pᵀ·dO
      __syncthreads();                // every thread is done with Pᵀ and dO
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pds[(ty * 4 + i) * T::PROW + tx + 16 * j] = dpt[i][j];
      land<D>(qd, qg, q0, p.Sq);      // Q again; its barrier also completes dSᵀ
      acc_tile<D>(pds, qd, acc_k);    // dK += dSᵀ·Q
    }
  }
  store_rows<D>(reinterpret_cast<float*>(p.dk) + kvbase, k0, p.Skv, acc_k);
  store_rows<D>(reinterpret_cast<float*>(p.dv) + kvbase, k0, p.Skv, acc_v);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, on mma_bf16.cuh's swizzled shared-memory tiles.

// cp.async of rows r0.. of a row-major [n][D] bf16 matrix into a tile by
// THREADS threads (this one is `tid`); rows past n are zero-filled.
template <int D, int THREADS>
__device__ __forceinline__ void issue_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int n, int tid) {
  using T = Bf16Tile<D>;
  for (int e = tid; e < BR * T::CPR; e += THREADS) {
    const int r = e / T::CPR, c = e % T::CPR;
    const bool ok = r0 + r < n;
    cp_async16(dst + sw(r, c), src + size_t(ok ? r0 + r : 0) * D + 8 * c, ok);
  }
}

// Barrier of one 128-thread warp group (named barrier 1 + group).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// The A fragment of k16 step kk of a product whose left operand is a warp's
// 16-row score tile x (x[n][e]: row g + 8(e >> 1), column 8n + 2t + (e & 1)),
// each value rounded to bf16.
template <int NN>
__device__ __forceinline__ void pack_a(const float (&x)[NN][4], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 pb = __floats2bfloat162_rn(x[2 * kk + hh][2 * r], x[2 * kk + hh][2 * r + 1]);
      a[2 * hh + r] = *reinterpret_cast<const uint32_t*>(&pb);
    }
}

// Rows r0 + g + 8r (< n) of a [n][D] bf16 output from a warp's accumulator.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, int r0, int n,
                                          const float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + size_t(row) * D + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

constexpr int NTKV = 256;  // threads of a bf16 dK/dV block: two warp groups of 4 warps

template <int D>
struct DkvBf16Smem {
  using T = Bf16Tile<D>;
  // K and V, then per warp group two stages of (Q, dO): ten tiles; then per
  // group and stage the q rows' lse, di and dlse; 1 KB to align.
  static constexpr int TILES = 2 + 2 * 2 * 2;
  static constexpr int STATS_OFF = TILES * T::TILE * 2;
  static constexpr int BYTES = STATS_OFF + 2 * 2 * 3 * BR * 4 + 1024;
  // After the walk, group 1's dK and dV accumulators (f32) over the stages.
  static_assert(2 * (D / 8) * 4 * 128 * 4 <= 8 * T::TILE * 2, "reduction fits the stages");
};

// dK/dV: one block per (batch, kv head, 64-key tile), two warp groups that
// take turns over the (q head, q tile) steps of the GQA group, each with
// its own double-buffered Q/dO stages; warp w of either group owns keys
// 16w..16w+15. At the end group 1 hands its sums to group 0 through shared
// memory, which adds them in a fixed order and writes dK and dV.
template <int D>
__global__ void __launch_bounds__(NTKV, 1) flash_bwd_dkv_bf16_kernel(const Params p) {
  using T = Bf16Tile<D>;
  using S = DkvBf16Smem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + T::TILE;

  const int tid = threadIdx.x, grp = tid >> 7, gtid = tid & 127;
  const int warp = gtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // This group's stages: Q of stage s at qstage + 2s·TILE, dO one tile on.
  __nv_bfloat16* qstage = vs + T::TILE + grp * 4 * T::TILE;
  float* stats = reinterpret_cast<float*>(smem + S::STATS_OFF) + grp * 2 * 3 * BR;
  // Heaviest first: under a causal mask key tile 0 sees every q row, so the
  // key tile is the grid's slow dimension.
  const int k0 = blockIdx.y * BR;
  const int kvh = blockIdx.x % p.Hkv, b = blockIdx.x / p.Hkv;
  const int group = p.H / p.Hkv;
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const size_t bh0 = size_t(b) * p.H + size_t(kvh) * group;  // the GQA group's first q head
  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + bh0 * p.Sq * D;
  const __nv_bfloat16* dog = reinterpret_cast<const __nv_bfloat16*>(p.dout) + bh0 * p.Sq * D;

  // Stage buf of this group for (q head hd of the GQA group, q tile q0): Q
  // and dO rows, and each row's lse, di and dlse (0 without dlse, past Sq).
  auto issue = [&](int hd, int q0, int buf) {
    const size_t off = size_t(hd) * p.Sq * D;
    issue_rows<D, 128>(qstage + 2 * buf * T::TILE, qg + off, q0, p.Sq, gtid);
    issue_rows<D, 128>(qstage + (2 * buf + 1) * T::TILE, dog + off, q0, p.Sq, gtid);
    if (gtid < BR) {
      float* st = stats + buf * 3 * BR;
      const bool ok = q0 + gtid < p.Sq;
      const size_t at = (bh0 + hd) * p.Sq + (ok ? q0 + gtid : 0);
      cp_async4(st + gtid, p.lse + at, ok);
      cp_async4(st + BR + gtid, p.di + at, ok);
      cp_async4(st + 2 * BR + gtid, p.dlse != nullptr ? p.dlse + at : p.lse + at,
                ok && p.dlse != nullptr);
    }
    cp_async_commit();
  };
  const int first_kv = kv_off + k0, last_kv = kv_off + min(k0 + BR, p.Skv) - 1;
  auto next_q = [&](int q0) {
    while (q0 < p.Sq &&
           !range_should_run(p, q_off + q0, q_off + min(q0 + BR, p.Sq) - 1, first_kv, last_kv))
      q0 += BR;
    return q0;
  };
  // The steps run q tiles within heads: the one after (hd, q0).
  const int q_first = next_q(0);
  auto advance = [&](int& hd, int& q0) {
    q0 = next_q(q0 + BR);
    if (q0 >= p.Sq) {
      ++hd;
      q0 = q_first;
    }
  };

  issue_rows<D, NTKV>(ks, reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase, k0, p.Skv, tid);
  issue_rows<D, NTKV>(vs, reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase, k0, p.Skv, tid);
  // Group 0 takes steps 0, 2, 4, ..., group 1 steps 1, 3, 5, ...
  int hd = q_first < p.Sq ? 0 : group, q0 = q_first;
  if (grp == 1 && hd < group) advance(hd, q0);
  if (hd < group) {
    issue(hd, q0, 0);
  } else {
    cp_async_commit();
  }
  stage_landed();
  __syncthreads();  // K and V, copied by every thread, are in shared memory

  float acc_k[T::ND][4], acc_v[T::ND][4];
  zero(acc_k);
  zero(acc_v);

  // This warp's 16 keys.
  const int wk_lo = k0 + 16 * warp, wk_hi = min(wk_lo + 16, p.Skv) - 1;
  const int key_r[2] = {wk_lo + g, wk_lo + g + 8};

  // Sᵀ and dPᵀ of this warp's keys and q rows 32h..32h+31 of the tile
  // become Pᵀ and dSᵀ in place: st[n][e] pairs key g + 8(e >> 1) of the
  // warp with q row 32h + 8n + 2t + (e & 1).
  auto grads = [&](auto unmasked_tag, auto cap_tag, int h, float (&st)[4][4], float (&dpt)[4][4],
                   int q0, const float* st_s) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr int CAP = decltype(cap_tag)::value ? 1 : 0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 32 * h + 8 * n + 2 * t + (e & 1);
        const float dr = st_s[BR + r] - st_s[2 * BR + r];
        const bool valid = UNMASKED || pair_valid(p, q0 + r, key_r[e >> 1], q_off, kv_off);
        const float2 pd = score_grad<CAP>(p, valid, st[n][e], dpt[n][e], st_s[r], dr);
        st[n][e] = pd.x;
        dpt[n][e] = pd.y;
      }
  };

  int buf = 0;
  while (hd < group) {
    stage_landed();
    group_sync(grp);  // this stage is in shared memory; the group is done with the other
    int hd_next = hd, q_next = q0;
    advance(hd_next, q_next);
    if (hd_next < group) advance(hd_next, q_next);
    const bool more = hd_next < group;
    if (more) issue(hd_next, q_next, buf ^ 1);
    const __nv_bfloat16* qt = qstage + 2 * buf * T::TILE;
    const __nv_bfloat16* dot = qt + T::TILE;
    const float* st_s = stats + buf * 3 * BR;
    const int q_hi = min(q0 + BR, p.Sq) - 1;
    const bool warp_runs =
        wk_lo < p.Skv &&
        range_should_run(p, q_off + q0, q_off + q_hi, kv_off + wk_lo, kv_off + wk_hi);
    const bool unmasked = range_unmasked(p, q0, q0 + BR - 1, wk_lo, wk_lo + 15, q_off, kv_off);
    // 32 q rows at a time, so that Sᵀ and dPᵀ take 32 registers, not 64.
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the group's 64 keys (wgmma).
      wgmma_fence();
      fence_operands(st);
      fence_operands(dpt);
#pragma unroll
      for (int kc = 0; kc < T::KC; ++kc)
        wgmma_m64n32(st, tile_desc(ks, 0, kc), tile_desc(qt, 32 * h, kc), kc);
#pragma unroll
      for (int kc = 0; kc < T::KC; ++kc)
        wgmma_m64n32(dpt, tile_desc(vs, 0, kc), tile_desc(dot, 32 * h, kc), kc);
      wgmma_commit();
      wgmma_wait0();
      fence_operands(st);
      fence_operands(dpt);
      if (warp_runs) {
        with_tags(unmasked, p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
          grads(unmasked_tag, cap_tag, h, st, dpt, q0, st_s);
        });
      } else {
        zero(st);
        zero(dpt);
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over these 32 q rows: P and dS in bf16.
      {
        uint32_t ap[2][4], ad[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          pack_a(st, kk, ap[kk]);
          pack_a(dpt, kk, ad[kk]);
        }
        wgmma_fence();
        fence_operands(acc_v);
        fence_operands(acc_k);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wgmma_rs<D>(acc_v, ap[kk], tile_desc_mn(dot, 32 * h + 16 * kk));
          wgmma_rs<D>(acc_k, ad[kk], tile_desc_mn(qt, 32 * h + 16 * kk));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_operands(acc_v);
        fence_operands(acc_k);
      }
    }
    buf ^= 1;
    hd = hd_next;
    q0 = q_next;
  }
  cp_async_wait_all();
  __syncthreads();  // both groups are done with their stages

  // Group 1's sums through shared memory (over the stages), added to group
  // 0's in that order: the same bits every launch.
  float* red = reinterpret_cast<float*>(vs + T::TILE);
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < T::ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(n * 4 + e) * 128 + gtid] = acc_k[n][e];
        red[((T::ND + n) * 4 + e) * 128 + gtid] = acc_v[n][e];
      }
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int n = 0; n < T::ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_k[n][e] += red[(n * 4 + e) * 128 + gtid];
        acc_v[n][e] += red[((T::ND + n) * 4 + e) * 128 + gtid];
      }
    __nv_bfloat16* dkg = reinterpret_cast<__nv_bfloat16*>(p.dk) + kvbase;
    __nv_bfloat16* dvg = reinterpret_cast<__nv_bfloat16*>(p.dv) + kvbase;
    store_acc<D>(dkg, wk_lo, p.Skv, acc_k);
    store_acc<D>(dvg, wk_lo, p.Skv, acc_v);
  }
}

template <int D>
constexpr int dq_bf16_smem() {
  return 6 * Bf16Tile<D>::TILE * 2 + 1024;  // Q, dO, two stages of K and V; 1 KB to align
}

// dQ: one block per (batch, q head, 64-row q tile), one warp group whose
// warp w owns q rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(NTB, 2) flash_bwd_dq_bf16_kernel(const Params p) {
  using T = Bf16Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(align_1k(smem_raw));
  __nv_bfloat16* dos = qs + T::TILE;
  __nv_bfloat16* kbuf = dos + T::TILE;
  __nv_bfloat16* vbuf = kbuf + 2 * T::TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Heaviest first: under a causal mask the last q tile sees every key.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t bh = size_t(b) * p.H + h;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase;

  auto issue = [&](int t0, int buf) {
    issue_rows<D, NTB>(kbuf + buf * T::TILE, kg, t0, p.Skv, tid);
    issue_rows<D, NTB>(vbuf + buf * T::TILE, vg, t0, p.Skv, tid);
    cp_async_commit();
  };
  const int first_q = q_off + q0, last_q = q_off + min(q0 + BR, p.Sq) - 1;
  auto next_run = [&](int t0) {
    while (t0 < p.Skv &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BR, p.Skv) - 1))
      t0 += BR;
    return t0;
  };

  issue_rows<D, NTB>(qs, reinterpret_cast<const __nv_bfloat16*>(p.q) + bh * p.Sq * D, q0, p.Sq,
                     tid);
  issue_rows<D, NTB>(dos, reinterpret_cast<const __nv_bfloat16*>(p.dout) + bh * p.Sq * D, q0,
                     p.Sq, tid);
  int t0 = next_run(0);
  if (t0 < p.Skv) {
    issue(t0, 0);
  } else {
    cp_async_commit();
  }

  // This warp's 16 q rows: rows g and g + 8 are this thread's.
  const int wq_lo = q0 + 16 * warp, wq_hi = min(wq_lo + 16, p.Sq) - 1;
  const int qrow[2] = {wq_lo + g, wq_lo + g + 8};
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = bh * p.Sq + qrow[r];
    lse_r[r] = qrow[r] < p.Sq ? p.lse[at] : 0.f;
    di_r[r] = qrow[r] < p.Sq ? row_di(p, at) : 0.f;
  }

  float acc[T::ND][4];
  zero(acc);

  // S of this warp's q rows becomes dS in place (from dP): s[n][e] pairs q
  // row g + 8(e >> 1) of the warp with key t0 + 8n + 2t + (e & 1).
  auto grads = [&](auto unmasked_tag, auto cap_tag, float (&s)[8][4], float (&dp)[8][4],
                   int t0) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr int CAP = decltype(cap_tag)::value ? 1 : 0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kloc = t0 + 8 * n + 2 * t + (e & 1);
        const bool valid = UNMASKED || pair_valid(p, qrow[r], kloc, q_off, kv_off);
        s[n][e] = score_grad<CAP>(p, valid, s[n][e], dp[n][e], lse_r[r], di_r[r]).y;
      }
  };

  int buf = 0;
  while (t0 < p.Skv) {
    stage_landed();
    __syncthreads();  // this tile is in shared memory; every warp is done with the other
    const int tn = next_run(t0 + BR);
    if (tn < p.Skv) issue(tn, buf ^ 1);
    const __nv_bfloat16* kt = kbuf + buf * T::TILE;
    const __nv_bfloat16* vt = vbuf + buf * T::TILE;
    // S = Q·Kᵀ and dP = dO·Vᵀ for the block's 64 q rows (wgmma).
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    wgmma_fence();
    fence_operands(s);
    fence_operands(dp);
#pragma unroll
    for (int kc = 0; kc < T::KC; ++kc)
      wgmma_m64n64(s, tile_desc(qs, 0, kc), tile_desc(kt, 0, kc), kc);
#pragma unroll
    for (int kc = 0; kc < T::KC; ++kc)
      wgmma_m64n64(dp, tile_desc(dos, 0, kc), tile_desc(vt, 0, kc), kc);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);
    fence_operands(dp);
    const int k_hi = min(t0 + BR, p.Skv) - 1;
    const bool warp_runs =
        wq_lo < p.Sq &&
        range_should_run(p, q_off + wq_lo, q_off + wq_hi, kv_off + t0, kv_off + k_hi);
    if (warp_runs) {
      with_tags(range_unmasked(p, wq_lo, wq_lo + 15, t0, t0 + BR - 1, q_off, kv_off),
                p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
                  grads(unmasked_tag, cap_tag, s, dp, t0);
                });
    } else {
      zero(s);
    }
    // dQ += dS·K: dS in bf16.
    {
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, a[kk]);
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(kt, 16 * kk));
      wgmma_commit();
      wgmma_wait0();
      fence_operands(acc);
    }
    buf ^= 1;
    t0 = tn;
  }
  cp_async_wait_all();
  store_acc<D>(reinterpret_cast<__nv_bfloat16*>(p.dq) + bh * p.Sq * D, wq_lo, p.Sq, acc);
}

// ---------------------------------------------------------------------------
// bf16 at d=256: two warp groups on one step, each owning a column half.

constexpr int D2 = 256;
using T2 = Bf16Tile<D2>;  // a [64][256] tile: four 64-column blocks, 32 KB
constexpr int HTILE = 64 * 64;  // a [64][64] bf16 score tile (Pᵀ, dSᵀ or dS), 8 KB
// Descriptor start of column block 2 (columns 128-255) from block 0 of a
// tile: 16 KB on, in the descriptor's 16-byte units.
constexpr uint32_t HALF_DESC = 2 * SW_ROWS * 64 * 2 >> 4;

// Rows r0 + g + 8r (< n) of a [n][256] bf16 output, columns col0.. (the
// group's half) from a warp's m64n128 accumulator.
__device__ __forceinline__ void store_half(__nv_bfloat16* dst, int r0, int n, int col0,
                                           const float (&acc)[16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + size_t(row) * D2 + col0 + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

// A warp's 16 x 32 f32 score fragment x (x[n][e]: row g + 8(e >> 1) of the
// warp's rows row0.., column col0 + 8n + 2t + (e & 1)) rounded to bf16 into
// a [64][64] swizzled score tile, the K-major A operand of the second
// products.
__device__ __forceinline__ void put_scores(__nv_bfloat16* tile, int row0, int col0,
                                           const float (&x)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(tile + sw(row0 + g + 8 * r, (col0 >> 3) + n) + 2 * t) =
          __floats2bfloat162_rn(x[n][2 * r], x[n][2 * r + 1]);
}

struct DkvD256Smem {
  // K, V, two stages of (Q, dO): six tiles; Pᵀ and dSᵀ; per stage the q
  // rows' lse, di and dlse; 1 KB to align.
  static constexpr int PT_OFF = 6 * T2::TILE * 2;
  static constexpr int STATS_OFF = PT_OFF + 2 * HTILE * 2;
  static constexpr int BYTES = STATS_OFF + 2 * 3 * BR * 4 + 1024;
};

// dK/dV at d=256: one block per (batch, kv head, 64-key tile), two warp
// groups on every (q head, q tile) step of the GQA group, sharing its
// double-buffered Q/dO stages. Group j computes Sᵀ and dPᵀ of the 64 keys
// against q rows 32j..32j+31 of the tile (warp w: keys 16w..16w+15), turns
// them into Pᵀ and dSᵀ and writes them in bf16 to shared memory; after a
// barrier each group adds Pᵀ·dO and dSᵀ·Q over all 64 q rows into its
// column half 128j..128j+127 of dV and dK.
__global__ void __launch_bounds__(NTKV, 1) flash_bwd_dkv_d256_kernel(const Params p) {
  using S = DkvD256Smem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + T2::TILE;
  __nv_bfloat16* stage = vs + T2::TILE;  // Q of stage s at stage + 2s·TILE, dO one tile on
  __nv_bfloat16* pts = reinterpret_cast<__nv_bfloat16*>(smem + S::PT_OFF);  // Pᵀ [key][q row]
  __nv_bfloat16* dsts = pts + HTILE;                                         // dSᵀ
  float* stats = reinterpret_cast<float*>(smem + S::STATS_OFF);

  const int tid = threadIdx.x, grp = tid >> 7, gtid = tid & 127;
  const int warp = gtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * BR;
  const int kvh = blockIdx.x % p.Hkv, b = blockIdx.x / p.Hkv;
  const int group = p.H / p.Hkv;
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D2;
  const size_t bh0 = size_t(b) * p.H + size_t(kvh) * group;
  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) + bh0 * p.Sq * D2;
  const __nv_bfloat16* dog = reinterpret_cast<const __nv_bfloat16*>(p.dout) + bh0 * p.Sq * D2;

  auto issue = [&](int hd, int q0, int buf) {
    const size_t off = size_t(hd) * p.Sq * D2;
    issue_rows<D2, NTKV>(stage + 2 * buf * T2::TILE, qg + off, q0, p.Sq, tid);
    issue_rows<D2, NTKV>(stage + (2 * buf + 1) * T2::TILE, dog + off, q0, p.Sq, tid);
    if (tid < BR) {
      float* st = stats + buf * 3 * BR;
      const bool ok = q0 + tid < p.Sq;
      const size_t at = (bh0 + hd) * p.Sq + (ok ? q0 + tid : 0);
      cp_async4(st + tid, p.lse + at, ok);
      cp_async4(st + BR + tid, p.di + at, ok);
      cp_async4(st + 2 * BR + tid, p.dlse != nullptr ? p.dlse + at : p.lse + at,
                ok && p.dlse != nullptr);
    }
    cp_async_commit();
  };
  const int first_kv = kv_off + k0, last_kv = kv_off + min(k0 + BR, p.Skv) - 1;
  auto next_q = [&](int q0) {
    while (q0 < p.Sq &&
           !range_should_run(p, q_off + q0, q_off + min(q0 + BR, p.Sq) - 1, first_kv, last_kv))
      q0 += BR;
    return q0;
  };
  const int q_first = next_q(0);

  issue_rows<D2, NTKV>(ks, reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase, k0, p.Skv, tid);
  issue_rows<D2, NTKV>(vs, reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase, k0, p.Skv, tid);
  int hd = q_first < p.Sq ? 0 : group, q0 = q_first;
  if (hd < group) {
    issue(hd, q0, 0);
  } else {
    cp_async_commit();
  }

  float acc_k[16][4], acc_v[16][4];
  zero(acc_k);
  zero(acc_v);

  const int wk_lo = k0 + 16 * warp, wk_hi = min(wk_lo + 16, p.Skv) - 1;
  const int key_r[2] = {wk_lo + g, wk_lo + g + 8};
  const int r0 = 32 * grp;  // this group's q rows of the tile

  // st[n][e] pairs key g + 8(e >> 1) of the warp with q row r0 + 8n + 2t +
  // (e & 1) of the tile; Sᵀ and dPᵀ become Pᵀ and dSᵀ in place.
  auto grads = [&](auto unmasked_tag, auto cap_tag, float (&st)[4][4], float (&dpt)[4][4],
                   int q0, const float* st_s) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr int CAP = decltype(cap_tag)::value ? 1 : 0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * n + 2 * t + (e & 1);
        const bool valid = UNMASKED || pair_valid(p, q0 + r, key_r[e >> 1], q_off, kv_off);
        const float2 pd = score_grad<CAP>(p, valid, st[n][e], dpt[n][e], st_s[r],
                                          st_s[BR + r] - st_s[2 * BR + r]);  // di − dlse
        st[n][e] = pd.x;
        dpt[n][e] = pd.y;
      }
  };

  int buf = 0;
  while (hd < group) {
    stage_landed();
    __syncthreads();  // this stage landed; both groups are done with the other, Pᵀ and dSᵀ
    int hd_next = hd, q_next = q0;
    q_next = next_q(q_next + BR);
    if (q_next >= p.Sq) {
      ++hd_next;
      q_next = q_first;
    }
    if (hd_next < group) issue(hd_next, q_next, buf ^ 1);
    const __nv_bfloat16* qt = stage + 2 * buf * T2::TILE;
    const __nv_bfloat16* dot = qt + T2::TILE;
    const float* st_s = stats + buf * 3 * BR;
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ of the 64 keys and this group's 32 q rows.
    wgmma_fence();
    fence_operands(st);
    fence_operands(dpt);
#pragma unroll
    for (int kc = 0; kc < T2::KC; ++kc)
      wgmma_m64n32(st, tile_desc(ks, 0, kc), tile_desc(qt, r0, kc), kc);
#pragma unroll
    for (int kc = 0; kc < T2::KC; ++kc)
      wgmma_m64n32(dpt, tile_desc(vs, 0, kc), tile_desc(dot, r0, kc), kc);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(st);
    fence_operands(dpt);
    const int gq_lo = q0 + r0;
    const bool warp_runs =
        wk_lo < p.Skv && gq_lo < p.Sq &&
        range_should_run(p, q_off + gq_lo, q_off + min(gq_lo + 32, p.Sq) - 1, kv_off + wk_lo,
                         kv_off + wk_hi);
    if (warp_runs) {
      with_tags(range_unmasked(p, gq_lo, gq_lo + 31, wk_lo, wk_lo + 15, q_off, kv_off),
                p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
                  grads(unmasked_tag, cap_tag, st, dpt, q0, st_s);
                });
    } else {
      zero(st);
      zero(dpt);
    }
    // Pᵀ and dSᵀ of this group's q rows to both groups (bf16).
    put_scores(pts, 16 * warp, r0, st);
    put_scores(dsts, 16 * warp, r0, dpt);
    fence_async_shared();
    __syncthreads();  // Pᵀ and dSᵀ are complete
    // dV[:, half] += Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·Q[:, half] over
    // the tile's 64 q rows, A and B read from shared memory.
    const uint32_t half = grp * HALF_DESC;
    wgmma_fence();
    fence_operands(acc_v);
    fence_operands(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_m64n128(acc_v, tile_desc(pts, 0, kk), tile_desc_mn(dot, 16 * kk) + half, 1);
      wgmma_ss_m64n128(acc_k, tile_desc(dsts, 0, kk), tile_desc_mn(qt, 16 * kk) + half, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_operands(acc_v);
    fence_operands(acc_k);
    buf ^= 1;
    hd = hd_next;
    q0 = q_next;
  }
  cp_async_wait_all();
  store_half(reinterpret_cast<__nv_bfloat16*>(p.dk) + kvbase, wk_lo, p.Skv, 128 * grp, acc_k);
  store_half(reinterpret_cast<__nv_bfloat16*>(p.dv) + kvbase, wk_lo, p.Skv, 128 * grp, acc_v);
}

// Q, dO, two stages of K and V: six tiles; dS; 1 KB to align.
constexpr int DQ_D256_SMEM = 6 * T2::TILE * 2 + HTILE * 2 + 1024;

// dQ at d=256: one block per (batch, q head, 64-row q tile), two warp
// groups on every key tile. Group j computes S and dP of the 64 q rows
// (warp w: rows 16w..16w+15) against keys 32j..32j+31 of the tile, turns
// them into dS and writes it in bf16 to shared memory; after a barrier each
// group adds dS·K over all 64 keys into its column half of dQ.
__global__ void __launch_bounds__(NTKV, 1) flash_bwd_dq_d256_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(align_1k(smem_raw));
  __nv_bfloat16* dos = qs + T2::TILE;
  __nv_bfloat16* kbuf = dos + T2::TILE;
  __nv_bfloat16* vbuf = kbuf + 2 * T2::TILE;
  __nv_bfloat16* dss = vbuf + 2 * T2::TILE;  // dS [q row][key]

  const int tid = threadIdx.x, grp = tid >> 7, gtid = tid & 127;
  const int warp = gtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t bh = size_t(b) * p.H + h;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D2;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase;

  auto issue = [&](int t0, int buf) {
    issue_rows<D2, NTKV>(kbuf + buf * T2::TILE, kg, t0, p.Skv, tid);
    issue_rows<D2, NTKV>(vbuf + buf * T2::TILE, vg, t0, p.Skv, tid);
    cp_async_commit();
  };
  const int first_q = q_off + q0, last_q = q_off + min(q0 + BR, p.Sq) - 1;
  auto next_run = [&](int t0) {
    while (t0 < p.Skv &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BR, p.Skv) - 1))
      t0 += BR;
    return t0;
  };

  issue_rows<D2, NTKV>(qs, reinterpret_cast<const __nv_bfloat16*>(p.q) + bh * p.Sq * D2, q0,
                       p.Sq, tid);
  issue_rows<D2, NTKV>(dos, reinterpret_cast<const __nv_bfloat16*>(p.dout) + bh * p.Sq * D2, q0,
                       p.Sq, tid);
  int t0 = next_run(0);
  if (t0 < p.Skv) {
    issue(t0, 0);
  } else {
    cp_async_commit();
  }

  const int wq_lo = q0 + 16 * warp, wq_hi = min(wq_lo + 16, p.Sq) - 1;
  const int qrow[2] = {wq_lo + g, wq_lo + g + 8};
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = bh * p.Sq + qrow[r];
    lse_r[r] = qrow[r] < p.Sq ? p.lse[at] : 0.f;
    di_r[r] = qrow[r] < p.Sq ? row_di(p, at) : 0.f;
  }
  const int c0 = 32 * grp;  // this group's keys of the tile

  float acc[16][4];
  zero(acc);

  // s[n][e] pairs q row g + 8(e >> 1) of the warp with key t0 + c0 + 8n +
  // 2t + (e & 1); S becomes dS in place.
  auto grads = [&](auto unmasked_tag, auto cap_tag, float (&s)[4][4], float (&dp)[4][4],
                   int t0) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr int CAP = decltype(cap_tag)::value ? 1 : 0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kloc = t0 + c0 + 8 * n + 2 * t + (e & 1);
        const bool valid = UNMASKED || pair_valid(p, qrow[r], kloc, q_off, kv_off);
        s[n][e] = score_grad<CAP>(p, valid, s[n][e], dp[n][e], lse_r[r], di_r[r]).y;
      }
  };

  int buf = 0;
  while (t0 < p.Skv) {
    stage_landed();
    __syncthreads();  // this tile landed; both groups are done with the other and dS
    const int tn = next_run(t0 + BR);
    if (tn < p.Skv) issue(tn, buf ^ 1);
    const __nv_bfloat16* kt = kbuf + buf * T2::TILE;
    const __nv_bfloat16* vt = vbuf + buf * T2::TILE;
    // S = Q·Kᵀ and dP = dO·Vᵀ of the 64 q rows and this group's 32 keys.
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    wgmma_fence();
    fence_operands(s);
    fence_operands(dp);
#pragma unroll
    for (int kc = 0; kc < T2::KC; ++kc)
      wgmma_m64n32(s, tile_desc(qs, 0, kc), tile_desc(kt, c0, kc), kc);
#pragma unroll
    for (int kc = 0; kc < T2::KC; ++kc)
      wgmma_m64n32(dp, tile_desc(dos, 0, kc), tile_desc(vt, c0, kc), kc);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);
    fence_operands(dp);
    const int gk_lo = t0 + c0;
    const bool warp_runs =
        wq_lo < p.Sq && gk_lo < p.Skv &&
        range_should_run(p, q_off + wq_lo, q_off + wq_hi, kv_off + gk_lo,
                         kv_off + min(gk_lo + 32, p.Skv) - 1);
    if (warp_runs) {
      with_tags(range_unmasked(p, wq_lo, wq_lo + 15, gk_lo, gk_lo + 31, q_off, kv_off),
                p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
                  grads(unmasked_tag, cap_tag, s, dp, t0);
                });
    } else {
      zero(s);
    }
    put_scores(dss, 16 * warp, c0, s);
    fence_async_shared();
    __syncthreads();  // dS is complete
    // dQ[:, half] += dS·K[:, half] over the tile's 64 keys.
    const uint32_t half = grp * HALF_DESC;
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n128(acc, tile_desc(dss, 0, kk), tile_desc_mn(kt, 16 * kk) + half, 1);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(acc);
    buf ^= 1;
    t0 = tn;
  }
  cp_async_wait_all();
  store_half(reinterpret_cast<__nv_bfloat16*>(p.dq) + bh * p.Sq * D2, wq_lo, p.Sq, 128 * grp,
             acc);
}

// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_bf16(const Params& p, bool dkv, cudaStream_t stream) {
  cudaError_t err;
  if (dkv) {
    constexpr int smem = DkvBf16Smem<D>::BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(p.Hkv * p.B, (p.Skv + BR - 1) / BR);
    flash_bwd_dkv_bf16_kernel<D><<<grid, NTKV, smem, stream>>>(p);
  } else {
    constexpr int smem = dq_bf16_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(p.H * p.B, (p.Sq + BR - 1) / BR);
    flash_bwd_dq_bf16_kernel<D><<<grid, NTB, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

cudaError_t launch_bf16_d256(const Params& p, bool dkv, cudaStream_t stream) {
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_d256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DkvD256Smem::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(p.Hkv * p.B, (p.Skv + BR - 1) / BR);
    flash_bwd_dkv_d256_kernel<<<grid, NTKV, DkvD256Smem::BYTES, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_d256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_D256_SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(p.H * p.B, (p.Sq + BR - 1) / BR);
    flash_bwd_dq_d256_kernel<<<grid, NTKV, DQ_D256_SMEM, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D, int CAP>
cudaError_t launch_f32_cap(const Params& p, bool dkv, cudaStream_t stream) {
  constexpr int smem = F32Smem<D>::BYTES;
  const auto kernel = dkv ? flash_bwd_dkv_f32_kernel<D, CAP> : flash_bwd_dq_f32_kernel<D, CAP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = dkv ? dim3(p.Hkv * p.B, (p.Skv + BR - 1) / BR)
                        : dim3(p.H * p.B, (p.Sq + BR - 1) / BR);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, bool dkv, cudaStream_t stream) {
  return p.has_softcap ? launch_f32_cap<D, 1>(p, dkv, stream)
                       : launch_f32_cap<D, 0>(p, dkv, stream);
}

cudaError_t launch_d(const Params& p, int D, bool bf16, bool dkv, cudaStream_t s) {
  switch (D) {
    case 32: return bf16 ? launch_bf16<32>(p, dkv, s) : launch_f32<32>(p, dkv, s);
    case 64: return bf16 ? launch_bf16<64>(p, dkv, s) : launch_f32<64>(p, dkv, s);
    case 128: return bf16 ? launch_bf16<128>(p, dkv, s) : launch_f32<128>(p, dkv, s);
    case 256: return bf16 ? launch_bf16_d256(p, dkv, s) : launch_f32<256>(p, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* di, const void* dlse, const void* offs, void* dq, void* dk, void* dv, int B,
        int H, int Hkv, int Sq, int Skv, int D, float sm_scale, int has_softcap, float softcap,
        int causal, int window, int sinks, int bf16, void* stream, bool dkv) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dlse = static_cast<const float*>(dlse);
  p.offs = static_cast<const int*>(offs);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.has_softcap = has_softcap;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  if (B == 0 || H == 0 || (dkv ? Skv : Sq) == 0) return 0;
  const cudaError_t err = launch_d(p, D, bf16 != 0, dkv, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, const void* dlse, const void* offs,
                             void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv, int D,
                             float sm_scale, int has_softcap, float softcap, int causal,
                             int window, int sinks, int bf16, void* stream) {
  return run(q, k, v, dout, lse, di, dlse, offs, nullptr, dk, dv, B, H, Hkv, Sq, Skv, D, sm_scale,
             has_softcap, softcap, causal, window, sinks, bf16, stream, true);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, const void* dlse, const void* offs,
                            void* dq, int B, int H, int Hkv, int Sq, int Skv, int D,
                            float sm_scale, int has_softcap, float softcap, int causal, int window,
                            int sinks, int bf16, void* stream) {
  return run(q, k, v, dout, lse, di, dlse, offs, dq, nullptr, nullptr, B, H, Hkv, Sq, Skv, D,
             sm_scale, has_softcap, softcap, causal, window, sinks, bf16, stream, false);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
