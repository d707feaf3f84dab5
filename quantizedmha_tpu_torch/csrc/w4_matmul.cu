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
// What bounds it on the H100: bytes. At decode (R <= 64) the packed weight
// is read once (4096 x 28672 / 2 = 58.7 MB for w_gateup, 17.5 us at 3.35
// TB/s) and the arithmetic is 2*R flops a weight. This first version does
// the dequant and the products on the CUDA cores in f32 (about 10 integer
// and float ops a byte to unpack and round, 16 FMAs a byte at 8 rows), so
// instruction throughput holds it well above the bytes bound; wgmma on
// dequantized tiles is later work.
//
// Design: a block is 8 warps over 256 output columns; each lane owns 8
// consecutive columns and reads a packed row's 8 bytes as one vector
// (neighbouring lanes on neighbouring addresses: coalesced, each byte read
// once per row tile). Up to 8 rows of x are held as 64 f32 accumulators a
// thread; larger R takes row tiles across the grid (gridDim.z), and the
// weight is then read ceil(R/8) times. x's lo and hi columns for a 64-row
// sub-chunk of the contraction are staged in shared memory as f32. The
// contraction is split across blocks (gridDim.y) so that a 4096-column
// product fills the 132 SMs, and across the 8 warps of a block. The warps'
// partial sums are added in warp order through shared memory; the blocks'
// partials go to an f32 workspace that a second kernel adds in split order.
// Every sum has a fixed order, so two launches give bitwise-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int RT, bool XBF16>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  dim3 grid((p.n + TILE_N - 1) / TILE_N, p.splits, (p.R + RT - 1) / RT);
  if (vec) {
    w4_matmul_kernel<RT, XBF16, true><<<grid, NT, 0, stream>>>(p);
  } else {
    w4_matmul_kernel<RT, XBF16, false><<<grid, NT, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int total = p.R * p.n;
  w4_reduce_kernel<XBF16><<<(total + NT - 1) / NT, NT, 0, stream>>>(p.ws, p.out, total, p.splits);
  return cudaGetLastError();
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
  const bool bad = R <= 0 || k2 <= 0 || n <= 0 || group <= 0 || group % 2 || in_dim % group ||
                   (halves && k2 % group) || chunk <= 0 || chunk % 8 ||
                   splits != (k2 + chunk - 1) / chunk || splits > 65535 ||
                   (splits > 1 && ws == nullptr) || (R + 7) / 8 > 65535;
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
  // 8-byte packed rows and 16-byte scale vectors need n % 8 == 0 and
  // aligned bases; other widths take byte-wise loads.
  const bool vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16 ? dispatch<true>(p, vec, s) : dispatch<false>(p, vec, s);
  return static_cast<int>(err);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
