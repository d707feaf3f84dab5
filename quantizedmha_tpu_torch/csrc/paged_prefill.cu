// Paged multi-token causal attention over the INT8 KV cache, or over the
// nibble-packed INT4 one, for Hopper (sm_90a): one kernel template, two
// page formats.
//
// Replaces the Pallas TPU kernels quantizedmha_tpu/ops/paged_prefill.py:63
// _prefill_kernel (entry paged_prefill) and :323 _prefill_kernel_int4
// (entry paged_prefill_int4): a prefill chunk's (or a prefix-cache
// suffix's) queries attend straight from the pages through the block
// table, with per-sequence q_starts and lengths.
//
// Numerics contract (what _paged_prefill_plain in ops/paged_prefill.py
// computes, up to the f32 summation order and a few ulps of exp/tanh): q in
// f32 times sm_scale; s = (q · k_int8) · k_scale[h, page] in f32; softcap,
// then the masks kpos <= qpos and kpos < length, and with a window kpos >
// qpos - window OR'd with kpos < sinks; the online softmax with p zeroed on
// rows whose running max is still the mask value and l summing the f32 p;
// P·V as (p · v_scale[h, page]) · v_int8 in f32; o = acc · (l == 0 ? 1 :
// 1/l) in q's dtype, lse = m + log(max(l, 1e-38)) or -inf when l == 0. On
// the TPU the JAX kernel's Precision.DEFAULT dots run as bf16 passes; the
// port follows the f32 numerics of its CPU (interpret) semantics. The plain
// version steps its softmax a page at a time and applies v_scale after the
// page's product, the kernel 64 keys at a time with v_scale folded into P:
// both are f32 rounding differences only.
//
// INT4 form: a packed row holds D/2 bytes (byte j: element j low nibble,
// element j + D/2 high nibble; int4.cuh), and key t of a page takes the
// scales of its sub-tile, scales[h, page, t / (P / subs)]: the INT8 form
// is the case subs = 1. q_starts may be negative (the INT4 partial of a
// mixed-cache chunk that starts below the boundary): rows at negative
// positions see no key and give o = 0, lse = -inf; a tile whose rows are
// all negative loads nothing (kend <= 0).
//
// What bounds it on the H100: the serving path's heaviest launch, the last
// 2048-row chunk of a ~7.9k-token prompt at Hq=32, d=128, is ~2.3e11 f32
// operations, 3.4 ms at the CUDA cores' 67 TFLOP/s; the pages it reads are
// tens of MB. So it is compute-bound on the CUDA cores.
//
// The INT4 form does the same operations from half the page bytes.
//
// What this design does about it: one block per (sequence, kv head, q tile)
// holds all `group` q heads of its tile as 64 rows (16 positions x 4 heads at
// Llama-3-8B's GQA), so each K/V page is read once per tile for the whole
// group; the block reads its own length, q start and block-table row. A
// 64-key tile of int8 K/V is staged in shared memory by cp.async (the next
// tile's copy overlaps this tile's math), converted once to f32 beside its
// per-key scales, and each of 256 threads computes 4 rows x 4 keys of S and
// 4 rows x d/16 columns of O from float4 shared-memory reads (the tile step
// of f32_tile.cuh, shared with flash_fwd.cu's f32 kernel). Tiles past the
// causal bound or wholly behind the window (sink tiles aside) are never
// loaded. A tensor-core version (bf16 q and p: int8 converts exactly to
// bf16) is later work; it would change the rounding and its tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "int4.cuh"

namespace {

constexpr int ROWS = TILE_ROWS;  // q rows per block: group x q positions
constexpr int BK = TILE_KEYS;    // keys per shared-memory tile
constexpr int NT = TILE_THREADS;

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
  int B, Hq, Hkv, C, num_pages, P, max_pages, G, BQ, subs;
  float sm_scale, softcap, mask_value, mask_half;
  int has_softcap, window, sinks;  // window < 0: none
};

template <int D, bool INT4>
struct Smem {
  static constexpr int ROW = F32Tile<D>::ROW;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = ROWS * ROW;
  static constexpr int V_OFF = K_OFF + BK * ROW;
  static constexpr int P_OFF = V_OFF + BK * ROW;
  static constexpr int KS_OFF = P_OFF + ROWS * F32Tile<D>::PROW;
  static constexpr int VS_OFF = KS_OFF + BK;
  static constexpr int F32_BYTES = (VS_OFF + BK) * 4;
  static constexpr int RB = INT4 ? D / 2 : D;  // bytes of a stored K or V row
  static constexpr int STAGE = BK * RB;  // bytes of one staged K or V tile
  static constexpr int BYTES = F32_BYTES + 4 * STAGE;  // + 2 K and 2 V stages
  static constexpr int CPR = RB / 16;   // 16-byte chunks of a stored row
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

template <int D, bool QBF16, bool INT4>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(const Params p) {
  using S = Smem<D, INT4>;
  using T = F32Tile<D>;

  extern __shared__ __align__(16) float sm[];
  float* qs = sm + S::Q_OFF;
  float* kf = sm + S::K_OFF;
  float* vf = sm + S::V_OFF;
  float* ps = sm + S::P_OFF;
  float* kss = sm + S::KS_OFF;
  float* vss = sm + S::VS_OFF;
  int8_t* k8 = reinterpret_cast<int8_t*>(sm + S::F32_BYTES / 4);
  int8_t* v8 = k8 + 2 * S::STAGE;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * p.BQ;  // first q position (chunk-relative) of the tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int length = p.lengths[b];
  const int qstart = p.qstarts[b];
  const int* table = p.tables + size_t(b) * p.max_pages;

  // Row r holds q head kvh*G + r / BQ at chunk position q0 + r % BQ.
  const int qlo = qstart + q0;
  const int qhi = qstart + min(q0 + p.BQ, p.C) - 1;
  const int kend = min(min(qhi + 1, length), p.max_pages * p.P);

  auto tile_runs = [&](int t0) {
    if (p.window < 0) return true;
    const int last = min(t0 + BK, kend) - 1;
    return last > qlo - p.window || t0 < p.sinks;
  };
  auto next_run = [&](int t0) {
    while (t0 < kend && !tile_runs(t0)) t0 += BK;
    return t0;
  };
  const size_t head_pages = size_t(kvh) * p.num_pages;
  auto issue = [&](int t0, int buf) {
    for (int e = tid; e < BK * S::CPR; e += NT) {
      const int r = e / S::CPR, c = e % S::CPR;
      const int kpos = t0 + r;
      const bool ok = kpos < kend;
      const int page = ok ? table[kpos / p.P] : 0;
      const size_t src = ((head_pages + page) * p.P + (ok ? kpos % p.P : 0)) * S::RB + 16 * c;
      cp_async16(k8 + buf * S::STAGE + r * S::RB + 16 * c, p.kp + src, ok);
      cp_async16(v8 + buf * S::STAGE + r * S::RB + 16 * c, p.vp + src, ok);
    }
    cp_async_commit();
  };
  int t0 = next_run(0);
  if (t0 < kend) issue(t0, 0);

  // Q rows in f32, times sm_scale; rows past the group or the chunk are 0.
  for (int e = tid; e < ROWS * (D / 4); e += NT) {
    const int r = e / (D / 4), c = e % (D / 4);
    const int gi = r / p.BQ, qi = q0 + r % p.BQ;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (gi < p.G && qi < p.C) {
      const size_t idx = ((size_t(b) * p.Hq + kvh * p.G + gi) * p.C + qi) * D + 4 * c;
      if (QBF16) {
        const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(p.q) + idx;
#pragma unroll
        for (int w = 0; w < 4; ++w) x[w] = __bfloat162float(qb[w]);
      } else {
        const float4 v4 = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p.q) + idx);
        x[0] = v4.x;
        x[1] = v4.y;
        x[2] = v4.z;
        x[3] = v4.w;
      }
    }
    *reinterpret_cast<float4*>(qs + r * S::ROW + 4 * c) =
        make_float4(x[0] * p.sm_scale, x[1] * p.sm_scale, x[2] * p.sm_scale, x[3] * p.sm_scale);
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    qpos[i] = qstart + q0 + r % p.BQ;
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
    const int tn = next_run(t0 + BK);
    if (tn < kend) issue(tn, buf ^ 1);
    // int8 / int4 -> f32 tiles, and each key's scales (0 past the context).
    for (int e = tid; e < BK * S::CPR; e += NT) {
      const int r = e / S::CPR, c = e % S::CPR;
      const size_t off = buf * S::STAGE + r * S::RB + 16 * c;
      chunk_to_f32<D, INT4>(*reinterpret_cast<const int4*>(k8 + off), c, kf + r * S::ROW);
      chunk_to_f32<D, INT4>(*reinterpret_cast<const int4*>(v8 + off), c, vf + r * S::ROW);
    }
    if (tid < BK) {
      const int kpos = t0 + tid;
      const bool ok = kpos < kend;
      const int slot = ok ? kpos % p.P : 0;
      const size_t sidx = (head_pages + (ok ? table[kpos / p.P] : 0)) * p.subs
                          + slot / (p.P / p.subs);
      kss[tid] = ok ? p.ks[sidx] : 0.f;
      vss[tid] = ok ? p.vs[sidx] : 0.f;
    }
    __syncthreads();

    auto score = [&](int i, int key, float s) {
      const int kpos = t0 + key;
      float x = s * kss[key];
      if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
      bool valid = kpos <= qpos[i] && kpos < kend;  // (kend <= length)
      if (p.window >= 0) valid &= kpos > qpos[i] - p.window || kpos < p.sinks;
      return valid ? x : p.mask_value;
    };
    f32_tile_step<D>(qs, kf, vf, ps, m, lpart, acc, p.mask_half, score,
                     [&](int key, float pe) { return pe * vss[key]; });
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
      if (QBF16) {
        __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(p.o) + row * D + col;
#pragma unroll
        for (int w = 0; w < T::VW; ++w) ob[w] = __float2bfloat16_rn(acc[i][nv * T::VW + w] * l_inv);
      } else {
        typename T::Vec out;
        float* of = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int w = 0; w < T::VW; ++w) of[w] = acc[i][nv * T::VW + w] * l_inv;
        *reinterpret_cast<typename T::Vec*>(reinterpret_cast<float*>(p.o) + row * D + col) = out;
      }
    }
    if (p.lse != nullptr && tx == 0) {
      p.lse[row] = l == 0.f ? -INFINITY : m[i] + logf(fmaxf(l, 1e-38f));
    }
  }
}

template <int D, bool QBF16, bool INT4>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Smem<D, INT4>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_kernel<D, QBF16, INT4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.C + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  paged_prefill_kernel<D, QBF16, INT4><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool INT4>
int dispatch(const Params& p, int D, int q_bf16, void* stream) {
  if (p.G < 1 || p.G > ROWS || p.subs < 1 || p.P % p.subs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.B == 0 || p.C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = q_bf16 ? launch<32, true, INT4>(p, s) : launch<32, false, INT4>(p, s); break;
    case 64: err = q_bf16 ? launch<64, true, INT4>(p, s) : launch<64, false, INT4>(p, s); break;
    case 128: err = q_bf16 ? launch<128, true, INT4>(p, s) : launch<128, false, INT4>(p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* lengths, const void* qstarts, const void* tables,
                   void* o, void* lse, int B, int Hq, int Hkv, int C, int num_pages, int P,
                   int max_pages, int subs, float sm_scale, int has_softcap, float softcap,
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
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.C = C;
  p.num_pages = num_pages;
  p.P = P;
  p.max_pages = max_pages;
  p.G = Hq / Hkv;
  p.BQ = p.G >= 1 && p.G <= ROWS ? ROWS / p.G : 1;
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

extern "C" int paged_prefill(const void* q, const void* kp, const void* vp, const void* ks,
                             const void* vs, const void* lengths, const void* qstarts,
                             const void* tables, void* o, void* lse, int B, int Hq, int Hkv,
                             int C, int num_pages, int P, int max_pages, int D, float sm_scale,
                             int has_softcap, float softcap, int window, int sinks,
                             float mask_value, float mask_half, int q_bf16, void* stream) {
  const Params p = make_params(q, kp, vp, ks, vs, lengths, qstarts, tables, o, lse, B, Hq, Hkv,
                               C, num_pages, P, max_pages, 1, sm_scale, has_softcap, softcap,
                               window, sinks, mask_value, mask_half);
  return dispatch<false>(p, D, q_bf16, stream);
}

// INT4 pages [Hkv, num_pages, P, D/2], scales [Hkv, num_pages, subs].
extern "C" int paged_prefill_int4(const void* q, const void* kp, const void* vp, const void* ks,
                                  const void* vs, const void* lengths, const void* qstarts,
                                  const void* tables, void* o, void* lse, int B, int Hq,
                                  int Hkv, int C, int num_pages, int P, int max_pages, int D,
                                  int subs, float sm_scale, int has_softcap, float softcap,
                                  int window, int sinks, float mask_value, float mask_half,
                                  int q_bf16, void* stream) {
  const Params p = make_params(q, kp, vp, ks, vs, lengths, qstarts, tables, o, lse, B, Hq, Hkv,
                               C, num_pages, P, max_pages, subs, sm_scale, has_softcap, softcap,
                               window, sinks, mask_value, mask_half);
  return dispatch<true>(p, D, q_bf16, stream);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
