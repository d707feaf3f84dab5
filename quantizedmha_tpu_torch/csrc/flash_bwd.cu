// FlashAttention-2 backward in bf16 or f32 for Hopper (sm_90a): two kernels,
// kv-stationary dK/dV and q-stationary dQ.
//
// Replaces the Pallas TPU kernels quantizedmha_tpu/ops/flash_attention.py:507
// _bwd_dkv_kernel (flash_bwd_dkv) and :600 _bwd_dq_kernel (flash_bwd_dq), the
// backward of the float flash forward (flash_fwd.cu) in every training step.
//
// Numerics contract (what _flash_bwd_plain in ops/flash_attention.py
// computes, up to the f32 summation order and a few ulps of exp/tanh):
//   every product in f32 on the CUDA cores, TF32 never; bf16 inputs are
//   widened to f32 once in shared memory, so S = Q·Kᵀ and dP = dO·Vᵀ are
//   sums of exact products, as a bf16 mma.sync with f32 accumulation would
//   give. s = (Q·Kᵀ)·sm_scale (Q unscaled, as the TPU backward does), softcap
//   s = cap·tanh(s/cap), p = valid ? exp(s − lse) : 0 (a fully masked row
//   has lse = −inf and no valid pair, so p is exactly 0, never exp(+inf)·0),
//   ds = p·(dp − di)·sm_scale, times 1 − tanh² under softcap, where di =
//   rowsum(dO·O) (the wrapper's f32 prepass) − dlse (folded here). dV = PᵀdO
//   and dK = dSᵀQ summed over the GQA group, dQ = dS·K, all in f32, cast
//   once to the inputs' dtypes. Masks at global positions (offs [B, 2]):
//   causal kpos <= qpos, window qpos − kpos < window OR kpos < sinks, and the
//   q and kv edges (no padding).
//
// What bounds them on the H100: at the training shape (B=1, H=32, Hkv=8,
// S=2048, d=128, causal) the two kernels do seven products of 2·S²·d a head
// (four in dK/dV: S, dP, dV, dK; three in dQ: S, dP, dQ), 1.2e11 flop a
// layer with the causal half skipped: 1.8 ms at the CUDA cores' 67 TFLOP/s,
// 0.12 ms at the bf16 tensor-core peak. This first version keeps all seven
// on the CUDA cores, so it is bound by f32 operations.
//
// What this design does about it: 256 threads a block, each owning 4 rows x
// 4 columns of a 64 x 64 score tile and 4 rows x D/16 columns of a 64-row
// accumulator, float4 shared-memory reads (the layout of f32_tile.cuh's
// forward step). dK/dV: one block per (batch, kv head, 64-key tile) holds
// K and V and walks every q tile of every q head of its group, so the
// group's sum stays in registers and no atomics are needed (a kv tile has
// one owner). dQ: one block per (batch, q head, 64-row q tile) walks the kv
// tiles it can see. Tiles wholly above the diagonal or behind the window
// are skipped exactly (sink tiles stay visible). P and dS go through shared
// memory to the second products. Tensor cores (P and dS rounded to bf16),
// cp.async double buffering and wgmma are the later redesign's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BR = 64;   // rows of a tile: q rows or keys
constexpr int NT = 256;  // threads a block

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

// (p, ds) of one pair from its raw dot Q·K (dot) and dO·V (dp).
__device__ __forceinline__ float2 score_grad(const Params& p, bool valid, float dot, float dp,
                                             float lse, float di) {
  float s = dot * p.sm_scale;
  float th = 0.f;
  if (p.has_softcap) {
    th = tanhf(s / p.softcap);
    s = p.softcap * th;
  }
  const float pe = valid ? expf(s - lse) : 0.f;
  float ds = pe * (dp - di) * p.sm_scale;
  if (p.has_softcap) ds *= 1.f - th * th;
  return make_float2(pe, ds);
}

// A [64][D] tile of rows r0.. of a row-major [n][D] matrix into f32 shared
// memory ([64][ROW]); rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n) {
  constexpr int ROW = Tile<D>::ROW;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int CPR = D / 4;
    for (int e = threadIdx.x; e < BR * CPR; e += NT) {
      const int r = e / CPR, c = e % CPR;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n) x = *reinterpret_cast<const float4*>(src + size_t(r0 + r) * D + 4 * c);
      *reinterpret_cast<float4*>(dst + r * ROW + 4 * c) = x;
    }
  } else {
    constexpr int CPR = D / 8;
    for (int e = threadIdx.x; e < BR * CPR; e += NT) {
      const int r = e / CPR, c = e % CPR;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) raw = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D + 8 * c);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float* d = dst + r * ROW + 8 * c;
      *reinterpret_cast<float4*>(d) = make_float4(__bfloat162float(x[0]), __bfloat162float(x[1]),
                                                  __bfloat162float(x[2]), __bfloat162float(x[3]));
      *reinterpret_cast<float4*>(d + 4) = make_float4(__bfloat162float(x[4]), __bfloat162float(x[5]),
                                                      __bfloat162float(x[6]), __bfloat162float(x[7]));
    }
  }
}

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
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int r0, int n, const float (&acc)[4][D / 16]) {
  using TL = Tile<D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const int col = tx * TL::VW + 16 * TL::VW * (c / TL::VW) + c % TL::VW;
      if constexpr (std::is_same<T, float>::value) {
        dst[size_t(row) * D + col] = acc[i][c];
      } else {
        dst[size_t(row) * D + col] = __float2bfloat16_rn(acc[i][c]);
      }
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
      d = p.di[at];
      if (p.dlse != nullptr) d = d - p.dlse[at];
    }
    lse_s[r] = l;
    di_s[r] = d;
  }
}

template <int D>
struct DqSmem {
  using T = Tile<D>;
  static constexpr int FLOATS = 4 * T::SZ + BR * T::PROW + 2 * BR;  // Q, dO, K, V, dS, lse, di
};

template <typename TIn, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + T::SZ;
  float* ks = dos + T::SZ;
  float* vs = ks + T::SZ;
  float* dss = vs + T::SZ;
  float* lse_s = dss + BR * T::PROW;
  float* di_s = lse_s + BR;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t bh = size_t(b) * p.H + h;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const TIn* kg = reinterpret_cast<const TIn*>(p.k) + kvbase;
  const TIn* vg = reinterpret_cast<const TIn*>(p.v) + kvbase;

  load_tile<TIn, D>(qs, reinterpret_cast<const TIn*>(p.q) + bh * p.Sq * D, q0, p.Sq);
  load_tile<TIn, D>(dos, reinterpret_cast<const TIn*>(p.dout) + bh * p.Sq * D, q0, p.Sq);
  load_row_stats(p, bh, q0, lse_s, di_s);

  float acc[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc[i][c] = 0.f;

  const int first_q = q_off + q0, last_q = q_off + min(q0 + BR, p.Sq) - 1;
  for (int t0 = 0; t0 < p.Skv; t0 += BR) {
    if (!range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BR, p.Skv) - 1))
      continue;
    __syncthreads();  // every thread is done with the last tile's K and dS
    load_tile<TIn, D>(ks, kg, t0, p.Skv);
    load_tile<TIn, D>(vs, vg, t0, p.Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(qs, ks, s);
    dot_tile<D>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const bool valid = pair_valid(p, q0 + r, t0 + key, q_off, kv_off);
        dss[r * T::PROW + key] = score_grad(p, valid, s[i][j], dp[i][j], lse_s[r], di_s[r]).y;
      }
    }
    __syncthreads();  // the dS tile is complete
    acc_tile<D>(dss, ks, acc);  // dQ += dS·K
  }
  store_rows<TIn, D>(reinterpret_cast<TIn*>(p.dq) + bh * p.Sq * D, q0, p.Sq, acc);
}

template <int D>
struct DkvSmem {
  using T = Tile<D>;
  static constexpr int FLOATS = 4 * T::SZ + 2 * BR * T::PROW + 2 * BR;  // K, V, Q, dO, Pᵀ, dSᵀ, lse, di
};

template <typename TIn, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + T::SZ;
  float* qs = vs + T::SZ;
  float* dos = qs + T::SZ;
  float* pts = dos + T::SZ;
  float* dsts = pts + BR * T::PROW;
  float* lse_s = dsts + BR * T::PROW;
  float* di_s = lse_s + BR;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;

  load_tile<TIn, D>(ks, reinterpret_cast<const TIn*>(p.k) + kvbase, k0, p.Skv);
  load_tile<TIn, D>(vs, reinterpret_cast<const TIn*>(p.v) + kvbase, k0, p.Skv);

  float acc_k[4][T::CPT], acc_v[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int first_kv = kv_off + k0, last_kv = kv_off + min(k0 + BR, p.Skv) - 1;
  for (int g = 0; g < group; ++g) {
    const size_t bh = size_t(b) * p.H + kvh * group + g;
    const TIn* qg = reinterpret_cast<const TIn*>(p.q) + bh * p.Sq * D;
    const TIn* dog = reinterpret_cast<const TIn*>(p.dout) + bh * p.Sq * D;
    for (int q0 = 0; q0 < p.Sq; q0 += BR) {
      if (!range_should_run(p, q_off + q0, q_off + min(q0 + BR, p.Sq) - 1, first_kv, last_kv))
        continue;
      __syncthreads();  // every thread is done with the last q tile, Pᵀ and dSᵀ
      load_tile<TIn, D>(qs, qg, q0, p.Sq);
      load_tile<TIn, D>(dos, dog, q0, p.Sq);
      load_row_stats(p, bh, q0, lse_s, di_s);
      __syncthreads();
      // Transposed tiles: st[i][j] pairs key 4ty + i with q row tx + 16j.
      float st[4][4], dpt[4][4];
      dot_tile<D>(ks, qs, st);
      dot_tile<D>(vs, dos, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool valid = pair_valid(p, q0 + r, k0 + key, q_off, kv_off);
          const float2 pd = score_grad(p, valid, st[i][j], dpt[i][j], lse_s[r], di_s[r]);
          pts[key * T::PROW + r] = pd.x;
          dsts[key * T::PROW + r] = pd.y;
        }
      }
      __syncthreads();  // Pᵀ and dSᵀ are complete
      acc_tile<D>(pts, dos, acc_v);   // dV += Pᵀ·dO
      acc_tile<D>(dsts, qs, acc_k);   // dK += dSᵀ·Q
    }
  }
  store_rows<TIn, D>(reinterpret_cast<TIn*>(p.dk) + kvbase, k0, p.Skv, acc_k);
  store_rows<TIn, D>(reinterpret_cast<TIn*>(p.dv) + kvbase, k0, p.Skv, acc_v);
}

template <typename TIn, int D>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  cudaError_t err;
  if (dkv) {
    constexpr int smem = DkvSmem<D>::FLOATS * 4;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<TIn, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.Skv + BR - 1) / BR, p.Hkv, p.B);
    flash_bwd_dkv_kernel<TIn, D><<<grid, NT, smem, stream>>>(p);
  } else {
    constexpr int smem = DqSmem<D>::FLOATS * 4;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<TIn, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.Sq + BR - 1) / BR, p.H, p.B);
    flash_bwd_dq_kernel<TIn, D><<<grid, NT, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_d(const Params& p, int D, bool dkv, cudaStream_t s) {
  switch (D) {
    case 32: return launch<TIn, 32>(p, dkv, s);
    case 64: return launch<TIn, 64>(p, dkv, s);
    case 128: return launch<TIn, 128>(p, dkv, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_d<__nv_bfloat16>(p, D, dkv, s) : launch_d<float>(p, D, dkv, s);
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
