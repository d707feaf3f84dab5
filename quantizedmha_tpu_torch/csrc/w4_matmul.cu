// Fused INT4 dequant-matmul (w4a16) for Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas kernels:
//   * quantizedmha_tpu/ops/w4_matmul.py:62 _w4_kernel (body _w4_body :91)
//   * quantizedmha_tpu/ops/w4_matmul.py:46 _w4_kernel_stacked (the same
//     body over a layer-stacked weight); here the caller passes the layer's
//     view of the stack, which is contiguous, so one kernel serves both.
//
// Function: out[R, n] = x[R, 2*k2] @ W, W[2*k2, n] held as packed[k2, n]
// int8, two signed nibbles a byte (low nibble stored +8, high nibble two's
// complement), and scale[gn, n] f32, one per (group of `group` input rows,
// output column). Packing "pairs": byte (i, c) holds input rows 2i (lo) and
// 2i+1 (hi), both in scale group 2i/group. Packing "halves": rows i (lo,
// group i/group) and k2+i (hi, group gn/2 + i/group).
// Numerics, as ops/w4_matmul.py:_w4_matmul_plain repeats them: w = q*s in
// f32, rounded to nearest even into bf16 for bf16 x (kept for f32 x); an f32
// sum of x*w over the whole contraction; one final cast to x's dtype.
//
// What bounds it on the H100: bytes, in principle. At decode (R <= 64) the
// packed weight and its scales are read once: the four fused matmuls of a
// Llama-3-8B layer are ~116 MB, 0.0349 ms at 3.35 TB/s. Their products are
// 2*R flops a weight, 0.023 ms at R = 64 on the bf16 tensor cores. The
// exact dequant (w = bf16(q*s) with the product in f32) is a LOP3, an FADD,
// an FMUL and half a cvt a weight on the CUDA cores; with the loop around
// it ~4.8 instructions a weight, ~36 us a layer at full issue, above the
// bytes bound: in practice the dequant's instruction issue holds the
// kernel at R <= 32, and at R = 64 the x tiles' reads from L2 (as many
// bytes as the weight's) and the products join it.
//
// Design, bf16 x (the serving path): the tensor cores compute
// outᵀ = Wᵀ·xᵀ, so that their work scales with R. A block owns 256 output
// columns (wgmma's M side, four m64 tiles) and all R <= 64 rows of x
// (wgmma's N side: R rounded up to 8, 16, 32 or 64; rows past R are zero),
// so the packed weight is read exactly once; R > 64 takes 64-row tiles
// across the grid. Warpgroup 0, the producer, keeps a ring of stages (64
// packed rows each: the packed tile, the two planes' x tiles and the
// stage's scale rows) filled by cp.async and hands each over and back
// through named barriers. The two consumer warpgroups own 128 columns each:
// per k16 step a thread reads 4 bytes of each of its 4 packed rows (its 4
// consecutive columns, padded rows: conflict-free), makes the exact nibble
// values by the f32 magic-number trick (one LOP3 and one FADD a weight),
// multiplies by the f32 scale and rounds pairs to bf16 (cvt.rn.bf16x2):
// the m64n?k16 A fragments of both planes, in registers. Each plane is two
// register-A wgmmas against its own x tile, K-major in the 128-byte swizzle
// (the low plane's columns of x, the high plane's; "pairs" de-interleaves
// them as it stages). A step's fragments are made once its last step's
// wgmmas are done; the SM's other consumer warps (two blocks an SM up to
// 32 rows) fill the wait. Inside a block the column order is permuted (a
// thread's A rows g and g + 8 of both m64 tiles are 4 neighbouring
// columns); the epilogue writes each back to its own place. The
// contraction is split across blocks (gridDim.y) to fill the card; the
// blocks' f32 partials go to a workspace that a second kernel adds in
// split order, so two launches give the same bits.
//
// f32 x, and bf16 x whose scale groups are shorter than one k16 step of
// packed rows (or whose x is not 16-byte aligned): the first version, on
// the CUDA cores. A block is 8 warps over 256 output columns; each lane
// owns 8 consecutive columns and reads a packed row's 8 bytes as one vector.
// Up to 8 rows of x are held as 64 f32 accumulators a thread; larger R
// takes row tiles across the grid (gridDim.z), and the weight is then read
// ceil(R/8) times. x's lo and hi columns for a 64-row sub-chunk of the
// contraction are staged in shared memory as f32. The contraction is split
// across blocks and across the 8 warps of a block; the warps' partial sums
// are added in warp order through shared memory, the blocks' in split order
// by the same second kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int COLS = 8;            // output columns a lane owns
constexpr int TILE_N = 32 * COLS;  // output columns a block owns
constexpr int RPW = 8;             // packed rows a warp takes per sub-chunk
constexpr int SUB = NWARPS * RPW;  // packed rows per sub-chunk

struct Params {
  const void* x;          // [R, 2*k2] f32 or bf16
  const int8_t* packed;   // [k2, n]
  const float* scale;     // [gn, n]
  void* out;              // [R, n], x's dtype
  float* ws;              // [splits, R, n] when splits > 1
  int R, k2, n, group, halves, chunk, splits;
  int vec;                // packed rows and scale rows taken 16 bytes at a time
  int slots;              // scale rows a stage holds a plane (bf16 x, tensor cores)
  uint32_t nibble_mask;   // 0xF, a run-time value (see NibbleMasks)
};

template <bool XBF16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if (XBF16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
  return reinterpret_cast<const float*>(x)[i];
}

template <bool XBF16>
__device__ __forceinline__ void store_out(void* out, size_t i, float v) {
  if (XBF16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

// The dequantized weight in x's dtype, widened back to f32.
template <bool XBF16>
__device__ __forceinline__ float dequant(int q, float s) {
  const float w = static_cast<float>(q) * s;
  return XBF16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

// Eight packed bytes of one row at columns c0..c0+7 (zero past n).
template <bool VEC>
__device__ __forceinline__ uint2 load_packed(const Params& p, int row, int c0) {
  const int8_t* src = p.packed + size_t(row) * p.n + c0;
  if (VEC) {
    if (c0 < p.n) return __ldg(reinterpret_cast<const uint2*>(src));
    return make_uint2(0u, 0u);
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    if (c0 + j < p.n) w[j / 4] |= uint32_t(uint8_t(__ldg(src + j))) << (8 * (j % 4));
  }
  return make_uint2(w[0], w[1]);
}

// Eight scales of group row g at columns c0..c0+7 (zero past n).
template <bool VEC>
__device__ __forceinline__ void load_scales(const Params& p, int g, int c0, float* s) {
  const float* src = p.scale + size_t(g) * p.n + c0;
  if (VEC) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (c0 < p.n) {
      a = __ldg(reinterpret_cast<const float4*>(src));
      b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    }
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) s[j] = c0 + j < p.n ? __ldg(src + j) : 0.f;
}

// One block an SM: at 8 rows the 64 accumulators, 8 packed vectors and 16
// scales of a thread need ~250 registers; capping them at 128 (two blocks
// an SM) spilled ~1 KB a thread and ran slower.
template <int RT, bool XBF16, bool VEC>
__global__ void __launch_bounds__(NT) w4_matmul_kernel(const Params p) {
  __shared__ float xs[2][RT][SUB];          // x's lo / hi columns of a sub-chunk
  __shared__ float red[NWARPS][TILE_N];     // the warps' partial sums of one row
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TILE_N;
  const int c0 = n0 + lane * COLS;
  const int k0 = blockIdx.y * p.chunk;
  const int k1 = min(k0 + p.chunk, p.k2);
  const int r0 = blockIdx.z * RT;
  const int in_dim = 2 * p.k2;
  const int hi_goff = p.halves ? in_dim / p.group / 2 : 0;  // hi plane's scale rows
  const int rows_per_group = p.halves ? p.group : p.group / 2;

  float acc[RT][COLS];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;
  float slo[COLS], shi[COLS];
  int cur_g = -1;

  for (int s0 = k0; s0 < k1; s0 += SUB) {
    __syncthreads();  // the previous sub-chunk's readers are done
    for (int e = tid; e < 2 * RT * SUB; e += NT) {
      const int plane = e / (RT * SUB);
      const int r = (e / SUB) % RT;
      const int i = e % SUB;
      const int row = s0 + i;
      float v = 0.f;
      if (r0 + r < p.R && row < k1) {
        const int col = p.halves ? row + plane * p.k2 : 2 * row + plane;
        v = load_x<XBF16>(p.x, size_t(r0 + r) * in_dim + col);
      }
      xs[plane][r][i] = v;
    }
    __syncthreads();

    const int w0 = s0 + warp * RPW;  // this warp's first packed row
    uint2 pv[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) pv[i] = w0 + i < k1 ? load_packed<VEC>(p, w0 + i, c0) : make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = w0 + i;
      if (row >= k1) break;  // the same for the whole warp
      const int g = row / rows_per_group;
      if (g != cur_g) {
        load_scales<VEC>(p, g, c0, slo);
        load_scales<VEC>(p, g + hi_goff, c0, shi);
        cur_g = g;
      }
      float xl[RT], xh[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        xl[r] = xs[0][r][warp * RPW + i];
        xh[r] = xs[1][r][warp * RPW + i];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int b = static_cast<int>(static_cast<int8_t>(((j < 4 ? pv[i].x : pv[i].y) >> (8 * (j % 4))) & 0xff));
        const float wl = dequant<XBF16>((b & 15) - 8, slo[j]);
        const float wh = dequant<XBF16>(b >> 4, shi[j]);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[r][j] = fmaf(xl[r], wl, acc[r][j]);
          acc[r][j] = fmaf(xh[r], wh, acc[r][j]);
        }
      }
    }
  }

  // The warps' partials of each row, added in warp order; thread t then
  // owns column n0 + t.
  const int col = n0 + tid;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COLS; ++j) red[warp][lane * COLS + j] = acc[r][j];
    __syncthreads();
    float v = red[0][tid];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) v += red[w][tid];
    if (r0 + r < p.R && col < p.n) {
      const size_t oi = size_t(r0 + r) * p.n + col;
      if (p.splits == 1) {
        store_out<XBF16>(p.out, oi, v);
      } else {
        p.ws[size_t(blockIdx.y) * p.R * p.n + oi] = v;
      }
    }
  }
}

// out = sum over the splits of the workspace, in split order.
template <bool XBF16>
__global__ void __launch_bounds__(NT) w4_reduce_kernel(const float* ws, void* out, int total,
                                                       int splits) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= total) return;
  float v = ws[e];
  for (int s = 1; s < splits; ++s) v += ws[size_t(s) * total + e];
  store_out<XBF16>(out, e, v);
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores (wgmma), a producer and two consumer warpgroups.

constexpr int TC_COLS = 256;             // output columns a block owns (wgmma's M side)
constexpr int TC_ROWS = 64;              // rows of x a block holds at most (wgmma's N side)
constexpr int KS = 64;                   // packed rows a stage holds: 4 k16 steps
constexpr int PROW = TC_COLS + 16;       // bytes of a packed row in shared memory (padded)
constexpr int PACKED_BYTES = KS * PROW;  // 17 KB: the x tiles after it stay 1024-aligned

template <int N>
struct TcRing {
  // Two blocks an SM fill each other's waits; at N = 64 the accumulators
  // need a consumer's registers of one block an SM.
  static constexpr int BLOCKS = N == 64 ? 1 : 2;
  static constexpr int STAGES = N == 64 ? 5 : 4;
  // A consumer holds stage n until its wgmmas are done, which it learns
  // after it has waited for stage n + 1: the producer keeps STAGES - 2
  // stages in flight beyond the ones it has handed over.
  static constexpr int LAG = STAGES - 2;
  static constexpr int NTB = 384;  // threads; all meet at a handoff
  static constexpr int PRODUCER_REGS = N == 64 ? 40 : 32, CONSUMER_REGS = N == 64 ? 232 : 104;
  static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * (65536 / (NTB * BLOCKS) / 8 * 8),
                "register budget");
  static constexpr int X_BYTES = 2 * N * 128;  // the two planes' x tiles, [N][64] bf16 each
  // Named barriers (0 is __syncthreads): stage s is full (FULL + s), stage
  // s is free again (EMPTY + s).
  static constexpr int FULL = 1, EMPTY = FULL + STAGES;
  static_assert(EMPTY + STAGES <= 16, "16 named barriers");
};

// Bytes of one stage: the packed tile, the x tiles, `slots` scale rows of
// 256 columns for each plane.
template <int N>
__host__ __device__ __forceinline__ int stage_bytes(int slots) {
  return PACKED_BYTES + TcRing<N>::X_BYTES + 2 * slots * TC_COLS * 4;
}

// The masks 0xF << 4i in registers. LOP3 takes one immediate operand: with
// the mask and the magic number both immediates a nibble costs two; the
// masks come from a kernel parameter, so the compiler keeps them in
// registers and a nibble costs one LOP3.
struct NibbleMasks {
  uint32_t m[5];
  __device__ __forceinline__ explicit NibbleMasks(uint32_t f) {
#pragma unroll
    for (int i = 0; i < 5; ++i) m[i] = f << (4 * i);
  }
};

// The signed value of one nibble of a packed word, exactly, as an f32: the
// nibble at bit O, masked into the mantissa of 2^(23-O) (where bit O weighs
// 1), is 2^(23-O) + n; less 2^(23-O) + 8 that is n - 8. The low plane is
// stored +8, so that is its value; the high plane is two's complement, so
// its top bit is flipped first (n ^ 8, less 8). Byte B of a word (one
// column) has its low nibble at bit 8B and its high one at 8B + 4; the
// nibbles past bit 19 come from w12 = w >> 12 (bits 20-31 at 8-19).
template <bool HI, int B>
__device__ __forceinline__ float nibble(uint32_t w, uint32_t w12, const NibbleMasks& mk) {
  constexpr bool SHIFTED = HI ? B >= 2 : B == 3;
  constexpr int O = HI ? (B == 0 ? 4 : B == 1 ? 12 : B == 2 ? 8 : 16)
                       : (B == 0 ? 0 : B == 1 ? 8 : B == 2 ? 16 : 12);
  constexpr uint32_t MAGIC = (uint32_t(150 - O) << 23) | (HI ? 8u << O : 0u);
  const uint32_t bits = ((SHIFTED ? w12 : w) & mk.m[O / 4]) ^ MAGIC;
  return __uint_as_float(bits) - float((1 << (23 - O)) + 8);
}

// bf16(q * s) of byte B's nibble in two packed words (k and k + 1), the
// lower k in the low half.
template <bool HI, int B>
__device__ __forceinline__ uint32_t weight_pair(uint32_t wa, uint32_t wa12, uint32_t wb,
                                                uint32_t wb12, float s, const NibbleMasks& mk) {
  const float lo = __fmul_rn(nibble<HI, B>(wa, wa12, mk), s), hi = __fmul_rn(nibble<HI, B>(wb, wb12, mk), s);
  const __nv_bfloat162 w = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// One plane's A fragments of a k16 step for the thread's two m64 tiles:
// w0..w3 its 4 bytes (columns) of packed rows 2t, 2t+1, 2t+8, 2t+9, s the
// plane's scales of those columns. Register e of tile j holds A row
// g + 8(e & 1) -- byte 2j + (e & 1) -- at k pair 2t (e < 2) or 2t + 8,
// the lower k in the low half: w = bf16(q * s).
template <bool HI>
__device__ __forceinline__ void dequant_plane(uint32_t (&a)[2][4], uint32_t w0, uint32_t w1,
                                              uint32_t w2, uint32_t w3, float4 s,
                                              const NibbleMasks& mk) {
  const uint32_t v0 = w0 >> 12, v1 = w1 >> 12, v2 = w2 >> 12, v3 = w3 >> 12;
  a[0][0] = weight_pair<HI, 0>(w0, v0, w1, v1, s.x, mk);
  a[0][1] = weight_pair<HI, 1>(w0, v0, w1, v1, s.y, mk);
  a[0][2] = weight_pair<HI, 0>(w2, v2, w3, v3, s.x, mk);
  a[0][3] = weight_pair<HI, 1>(w2, v2, w3, v3, s.y, mk);
  a[1][0] = weight_pair<HI, 2>(w0, v0, w1, v1, s.z, mk);
  a[1][1] = weight_pair<HI, 3>(w0, v0, w1, v1, s.w, mk);
  a[1][2] = weight_pair<HI, 2>(w2, v2, w3, v3, s.z, mk);
  a[1][3] = weight_pair<HI, 3>(w2, v2, w3, v3, s.w, mk);
}

// acc[64 x N] += A · B with B the N rows of an x tile, K-major.
template <int N>
__device__ __forceinline__ void wgmma_x(float (&acc)[N / 8][4], const uint32_t (&a)[4],
                                        uint64_t b) {
  if constexpr (N == 8) {
    wgmma_rs_m64n8<0>(acc, a, b, 1);
  } else if constexpr (N == 16) {
    wgmma_rs_m64n16<0>(acc, a, b, 1);
  } else if constexpr (N == 32) {
    wgmma_rs_m64n32<0>(acc, a, b, 1);
  } else {
    wgmma_rs_m64n64<0>(acc, a, b, 1);
  }
}

// Sixteen packed bytes of one row from column col on, byte by byte (zero
// past n): widths that are not a multiple of 16.
__device__ __forceinline__ uint4 packed_bytes(const Params& p, int row, int col) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int8_t* src = p.packed + size_t(row) * p.n;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (col + j < p.n) w[j / 4] |= uint32_t(uint8_t(__ldg(src + col + j))) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One block per (256 output columns, split of the contraction, 64 rows of
// x). Warpgroup 0, the producer, copies the split's stages into the ring;
// warpgroups 1 and 2, the consumers, own columns 128(wg-1).. of the block
// and run the dequant and the products on each stage, then hand it back.
template <int N>
__global__ void __launch_bounds__(TcRing<N>::NTB, TcRing<N>::BLOCKS)
    w4_matmul_wgmma_kernel(const Params p) {
  using R = TcRing<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  const int bytes = stage_bytes<N>(p.slots);
  auto packed_tile = [&](int s) { return smem + s * bytes; };
  auto x_tile = [&](int s, int plane) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * bytes + PACKED_BYTES) + plane * N * 64;
  };
  auto scale_row = [&](int s, int plane, int slot) {
    return reinterpret_cast<float*>(smem + s * bytes + PACKED_BYTES + R::X_BYTES) +
           (plane * p.slots + slot) * TC_COLS;
  };

  const int tid = threadIdx.x, wg = tid >> 7, gtid = tid & 127;
  const int n0 = blockIdx.x * TC_COLS;
  const int k0 = blockIdx.y * p.chunk;
  const int k1 = min(k0 + p.chunk, p.k2);
  const int r0 = blockIdx.z * TC_ROWS;
  const int stages = (k1 - k0 + KS - 1) / KS;
  const int in_dim = 2 * p.k2;
  const int rpg = p.halves ? p.group : p.group / 2;  // packed rows a scale group
  const int hi_goff = p.halves ? in_dim / p.group / 2 : 0;  // hi plane's scale rows

  if (wg == 0) {
    // Producer: stage n of the split into ring slot n % STAGES once the
    // consumers handed it back; handed over LAG stages later, when its
    // copies have landed.
    setmaxnreg_dec<R::PRODUCER_REGS>();
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(p.x);
    auto issue = [&](int n, int s) {
      const int kb = k0 + n * KS;  // the stage's first packed row
      unsigned char* pt = packed_tile(s);
#pragma unroll 1
      for (int e = gtid; e < KS * TC_COLS / 16; e += 128) {
        const int r = e / (TC_COLS / 16), c = e % (TC_COLS / 16);
        const int row = kb + r, col = n0 + 16 * c;
        const bool ok = row < k1 && col < p.n;
        unsigned char* dst = pt + r * PROW + 16 * c;
        if (p.vec) {
          cp_async16(dst, p.packed + (ok ? size_t(row) * p.n + col : 0), ok);
        } else {
          *reinterpret_cast<uint4*>(dst) = ok ? packed_bytes(p, row, col) : make_uint4(0, 0, 0, 0);
        }
      }
      // The scale rows of the stage's groups, slot j holding group g0 + j
      // (zero past the split's last one).
      const int g0 = kb / rpg, used = (min(kb + KS, k1) - 1) / rpg - g0 + 1;
#pragma unroll 1
      for (int e = gtid; e < 2 * p.slots * TC_COLS / 4; e += 128) {
        const int plane = e / (p.slots * TC_COLS / 4), slot = (e / (TC_COLS / 4)) % p.slots;
        const int col = n0 + 4 * (e % (TC_COLS / 4));
        const bool ok = slot < used && col < p.n;
        const size_t src = ok ? size_t(g0 + slot + plane * hi_goff) * p.n + col : 0;
        float* dst = scale_row(s, plane, slot) + col - n0;
        if (p.vec) {
          cp_async16(dst, p.scale + src, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) dst[j] = ok && col + j < p.n ? __ldg(p.scale + src + j) : 0.f;
        }
      }
      // x rows r0.. at the stage's packed rows, each plane's columns as a
      // swizzled K-major tile; zero past R and past the split.
#pragma unroll 1
      for (int e = gtid; e < N * 8; e += 128) {
        const int r = e / 8, c = e % 8;
        const int kk = kb + 8 * c;
        const bool ok = r0 + r < p.R && kk < k1;
        const __nv_bfloat16* xr = x + (ok ? size_t(r0 + r) * in_dim : 0);
        __nv_bfloat16* lo = x_tile(s, 0) + sw(r, c);
        __nv_bfloat16* hi = x_tile(s, 1) + sw(r, c);
        if (p.halves) {
          cp_async16(lo, xr + (ok ? kk : 0), ok);
          cp_async16(hi, xr + (ok ? p.k2 + kk : 0), ok);
        } else {
          // pairs: x columns 2kk.. interleave the planes; split them.
          uint4 a = make_uint4(0, 0, 0, 0), b = a;
          if (ok) {
            a = __ldg(reinterpret_cast<const uint4*>(xr + 2 * kk));
            b = __ldg(reinterpret_cast<const uint4*>(xr + 2 * kk + 8));
          }
          *reinterpret_cast<uint4*>(lo) =
              make_uint4(__byte_perm(a.x, a.y, 0x5410), __byte_perm(a.z, a.w, 0x5410),
                         __byte_perm(b.x, b.y, 0x5410), __byte_perm(b.z, b.w, 0x5410));
          *reinterpret_cast<uint4*>(hi) =
              make_uint4(__byte_perm(a.x, a.y, 0x7632), __byte_perm(a.z, a.w, 0x7632),
                         __byte_perm(b.x, b.y, 0x7632), __byte_perm(b.z, b.w, 0x7632));
        }
      }
      cp_async_commit();
    };
    for (int n = 0; n < stages; ++n) {
      const int s = n % R::STAGES;
      if (n >= R::STAGES) bar_sync(R::EMPTY + s, R::NTB);  // the consumers are done with it
      issue(n, s);
      if (n >= R::LAG) {
        cp_async_wait<R::LAG>();
        fence_async_shared();
        bar_arrive(R::FULL + (n - R::LAG) % R::STAGES, R::NTB);  // stage n - LAG landed
      }
    }
    stage_landed();
    for (int j = max(stages - R::LAG, 0); j < stages; ++j) bar_arrive(R::FULL + j % R::STAGES, R::NTB);
    // The consumers hand back every stage: wait for the last ones.
    for (int j = max(stages - R::STAGES, 0); j < stages; ++j) bar_sync(R::EMPTY + j % R::STAGES, R::NTB);
    return;
  }

  // Consumers.
  setmaxnreg_inc<R::CONSUMER_REGS>();
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // The thread's columns of the block: colw..colw + 3, A rows g and g + 8
  // of m64 tiles 0 and 1 (byte 2j + h of a packed word is A row g + 8h of
  // tile j).
  const int colw = (wg - 1) * 128 + warp * 32 + 4 * g;
  float acc[2][N / 8][4];
  zero(acc[0]);
  zero(acc[1]);
  // A fragments of a k16 step (both planes, both m64 tiles). One set: the
  // wgmmas of a step are done before the next step's are made (a second
  // set, so that they overlap, ran 5% slower: the SM's other consumer
  // warps fill the wait).
  uint32_t a[2][2][4];
  const int rpg16 = rpg / 16;  // k16 steps a scale group
  const NibbleMasks mk(p.nibble_mask);
  for (int n = 0; n < stages; ++n) {
    const int s = n % R::STAGES;
    const int kb = k0 + n * KS;
    // The scale slot of each k16 step (the group of its packed rows, less
    // the stage's first group), two bits a step.
    uint32_t slots = 0;
    {
      int m = (kb / 16) % rpg16, j = 0;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        slots |= uint32_t(j) << (2 * kc);
        if (++m == rpg16) m = 0, ++j;
      }
    }
    bar_sync(R::FULL + s, R::NTB);  // stage n is in its slot
    const unsigned char* pt = packed_tile(s) + 2 * t * PROW + colw;
    const float* sc = scale_row(s, 0, 0) + colw;
    // The x tiles' descriptors at k16 step 0; step kc is 32 bytes on.
    const uint64_t xd0 = tile_desc(x_tile(s, 0), 0, 0), xd1 = tile_desc(x_tile(s, 1), 0, 0);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const unsigned char* pk = pt + 16 * kc * PROW;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(pk);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(pk + PROW);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(pk + 8 * PROW);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(pk + 9 * PROW);
      const float* sk = sc + ((slots >> (2 * kc)) & 3) * TC_COLS;
      const float4 slo = *reinterpret_cast<const float4*>(sk);
      const float4 shi = *reinterpret_cast<const float4*>(sk + p.slots * TC_COLS);
      wgmma_wait<0>();  // the last step's wgmmas are done: its fragments may go
      // ... and with them, at step 0, stage n - 1's.
      if (kc == 0 && n > 0) bar_arrive(R::EMPTY + (n - 1) % R::STAGES, R::NTB);
      fence_operands(a[0]);
      fence_operands(a[1]);
      dequant_plane<false>(a[0], w0, w1, w2, w3, slo, mk);
      dequant_plane<true>(a[1], w0, w1, w2, w3, shi, mk);
      wgmma_fence();
      wgmma_x<N>(acc[0], a[0][0], xd0 + 2 * kc);
      wgmma_x<N>(acc[1], a[0][1], xd0 + 2 * kc);
      wgmma_x<N>(acc[0], a[1][0], xd1 + 2 * kc);
      wgmma_x<N>(acc[1], a[1][1], xd1 + 2 * kc);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  if (stages > 0) bar_arrive(R::EMPTY + (stages - 1) % R::STAGES, R::NTB);
  fence_operands(acc[0]);
  fence_operands(acc[1]);

  // Epilogue: acc[j][i][e] is x row 8i + 2t + (e & 1) of the tile at block
  // column colw + 2j + (e >> 1); a thread writes 4 neighbouring columns a row.
  const int col = n0 + colw;
  const bool vec4 = col + 3 < p.n && p.n % 4 == 0;
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * i + 2 * t + u;
      if (r >= p.R) continue;
      const float v[4] = {acc[0][i][u], acc[0][i][2 + u], acc[1][i][u], acc[1][i][2 + u]};
      const size_t oi = size_t(r) * p.n + col;
      if (p.splits > 1) {
        float* dst = p.ws + size_t(blockIdx.y) * p.R * p.n + oi;
        if (vec4) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (col + b < p.n) dst[b] = v[b];
        }
      } else {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(p.out) + oi;
        if (vec4) {
          const __nv_bfloat162 a01 = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 a23 = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&a01),
                                                      *reinterpret_cast<const uint32_t*>(&a23));
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (col + b < p.n) dst[b] = __float2bfloat16_rn(v[b]);
        }
      }
    }
}

cudaError_t reduce_splits(const Params& p, bool xbf16, cudaStream_t stream) {
  if (p.splits == 1) return cudaSuccess;
  const int total = p.R * p.n;
  const int blocks = (total + NT - 1) / NT;
  if (xbf16) {
    w4_reduce_kernel<true><<<blocks, NT, 0, stream>>>(p.ws, p.out, total, p.splits);
  } else {
    w4_reduce_kernel<false><<<blocks, NT, 0, stream>>>(p.ws, p.out, total, p.splits);
  }
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  const int smem = TcRing<N>::STAGES * stage_bytes<N>(p.slots) + 1024;
  // The kernel's shared-memory limit, raised once per device and size (a
  // host call on every launch costs the decode loop's host time).
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(w4_matmul_wgmma_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = smem;
  }
  dim3 grid((p.n + TC_COLS - 1) / TC_COLS, p.splits, (p.R + TC_ROWS - 1) / TC_ROWS);
  w4_matmul_wgmma_kernel<N><<<grid, TcRing<N>::NTB, smem, stream>>>(p);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : reduce_splits(p, true, stream);
}

cudaError_t dispatch_tc(const Params& p, cudaStream_t s) {
  const int r = p.R < TC_ROWS ? p.R : TC_ROWS;
  if (r <= 8) return launch_tc<8>(p, s);
  if (r <= 16) return launch_tc<16>(p, s);
  if (r <= 32) return launch_tc<32>(p, s);
  return launch_tc<64>(p, s);
}

// ---------------------------------------------------------------------------
// The CUDA-core kernel's launch.

template <int RT, bool XBF16>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  dim3 grid((p.n + TILE_N - 1) / TILE_N, p.splits, (p.R + RT - 1) / RT);
  if (vec) {
    w4_matmul_kernel<RT, XBF16, true><<<grid, NT, 0, stream>>>(p);
  } else {
    w4_matmul_kernel<RT, XBF16, false><<<grid, NT, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : reduce_splits(p, XBF16, stream);
}

template <bool XBF16>
cudaError_t dispatch(const Params& p, bool vec, cudaStream_t s) {
  const int r = p.R < 8 ? p.R : 8;
  if (r == 1) return launch<1, XBF16>(p, vec, s);
  if (r == 2) return launch<2, XBF16>(p, vec, s);
  if (r <= 4) return launch<4, XBF16>(p, vec, s);
  return launch<8, XBF16>(p, vec, s);
}

}  // namespace

extern "C" int w4_matmul(const void* x, const void* packed, const void* scale, void* out,
                         void* ws, int R, int k2, int n, int group, int halves, int x_bf16,
                         int chunk, int splits, void* stream) {
  const int in_dim = 2 * k2;
  bool bad = R <= 0 || k2 <= 0 || n <= 0 || group <= 0 || group % 2 || in_dim % group ||
             (halves && k2 % group) || chunk <= 0 || chunk % 8 ||
             splits != (k2 + chunk - 1) / chunk || splits > 65535 ||
             (splits > 1 && ws == nullptr) || (R + 7) / 8 > 65535;
  // bf16 x takes the tensor cores when a k16 step of packed rows lies in
  // one scale group and x's rows are 16-byte aligned (ops/w4_matmul.py:
  // _tensor_core_route); their chunk is a whole number of stages.
  const int rpg = halves ? group : group / 2;
  const bool tc = x_bf16 && rpg % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bad = bad || (tc && chunk % KS);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.packed = static_cast<const int8_t*>(packed);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.R = R;
  p.k2 = k2;
  p.n = n;
  p.group = group;
  p.halves = halves;
  p.chunk = chunk;
  p.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    // 16-byte packed and scale copies need n % 16 == 0 and aligned bases;
    // other widths are staged byte by byte.
    p.vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(scale) % 16 == 0;
    p.nibble_mask = 0xFu;
    // The most scale groups a stage (64 packed rows from a multiple of 64) meets.
    p.slots = 1;
    for (int kb = 0; kb < KS * rpg; kb += KS) {
      const int groups = (kb + KS - 1) / rpg - kb / rpg + 1;
      p.slots = groups > p.slots ? groups : p.slots;
    }
    return static_cast<int>(dispatch_tc(p, s));
  }
  // 8-byte packed rows and 16-byte scale vectors need n % 8 == 0 and
  // aligned bases; other widths take byte-wise loads.
  const bool vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  p.vec = vec;
  p.slots = 0;
  const cudaError_t err = x_bf16 ? dispatch<true>(p, vec, s) : dispatch<false>(p, vec, s);
  return static_cast<int>(err);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
