// FlashAttention-2 forward in bf16 or f32 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantizedmha_tpu/ops/flash_attention.py:124
// _fwd_kernel (the default attention of the Llama model and the "fa" /
// "fa_bf16" rungs of solve).
//
// Numerics contract (what _flash_fwd_plain in ops/flash_attention.py
// computes, up to the f32 summation order and a few ulps of exp/tanh):
//   Q is scaled in its own dtype (bf16: the wrapper passes the scale already
//   rounded to bf16, and each product is rounded back to bf16). S = Q·Kᵀ in
//   f32: bf16 x bf16 products are exact in f32 (mma.sync with an f32
//   accumulator); f32 products are true f32 FMAs on the CUDA cores, not TF32.
//   Softcap cap·tanh(s/cap) on the scaled scores, then masked scores take
//   the mask value: causal at global positions (kpos + kv_off <= qpos +
//   q_off), the window ((qpos+q_off) - (kpos+kv_off) < window, OR'd with
//   kpos + kv_off < sinks) and the kv edge (kpos < Skv). The online softmax
//   zeroes p on rows whose running max is still the mask value; l sums the
//   f32 p; P·V takes p in V's dtype. Epilogue o = acc · (l == 0 ? 1 : 1/l),
//   lse = m + log l (-inf when l == 0). The kernel steps its online softmax
//   64 keys at a time where the plain version steps block_kv (1024) keys:
//   the bf16 P is rounded against a different running max, a difference of
//   at most one bf16 rounding of each P (chip_smoke.py's tolerance).
//
// What bounds it on the H100: the serving prefill (bf16, S=2048, d=128,
// causal) is ~3.4e10 tensor-core flops, far below the tensor-core peak in
// time next to the ~1.1e8 exponentials on the SFUs and the per-score f32
// work around them; the f32 solve rung (N=8192, d=32) is 2.7e11 f32 FMA
// flops, 4.1 ms at the CUDA cores' 67 TFLOP/s.
//
// What this design does about it: one block per (batch, q head, 64-row q
// tile) walks the kv tiles of its sequence; K/V tiles are double-buffered in
// shared memory with cp.async, so the next tile's copy overlaps this tile's
// math; GQA reads kv head h / group, never a repeated copy. bf16: four warps
// of 16 rows, both products on the tensor cores (mma.sync m16n8k16), S kept
// in registers and fed to P·V as the A operand, V read through
// ldmatrix.trans. f32: 256 threads, each owning 4 rows x 4 keys of S and 4
// rows x D/16 columns of O, with float4 shared-memory reads (the tile step
// of f32_tile.cuh, which paged_prefill.cu shares). Tiles wholly
// above the diagonal or behind the window are skipped (exactly: their
// scores are all masked); a tile with no masked pair takes a path without
// per-score mask tests. wgmma/TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tile.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BKV = 64;  // kv positions per shared-memory tile
static_assert(BQ == TILE_ROWS && BKV == TILE_KEYS, "the f32 kernel steps f32_tile.cuh's tile");

struct Params {
  const void* q;    // [B, H, Sq, D]
  const void* k;    // [B, Hkv, Skv, D]
  const void* v;    // [B, Hkv, Skv, D]
  const int* offs;  // [B, 2] global (q_off, kv_off)
  void* o;          // [B, H, Sq, D], q's dtype
  float* lse;       // [B, H, Sq] or nullptr
  int B, H, Hkv, Sq, Skv;
  float sm_scale, softcap, mask_value, mask_half;
  int has_softcap, causal, window, sinks;  // window < 0: none
};

// Block-level skip at global positions: false when every pair of the two
// ranges is above the causal diagonal or behind the window.
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

// True when no pair of the ranges is masked (the kv edge included).
__device__ __forceinline__ bool range_unmasked(const Params& p, int first_q, int last_q,
                                               int first_kv, int last_kv, int last_kloc) {
  if (last_kloc >= p.Skv) return false;
  if (!p.causal) return true;
  bool ok = last_kv <= first_q;
  if (p.window >= 0) ok &= (last_q - first_kv) < p.window;
  return ok;
}

__device__ __forceinline__ bool pair_valid(const Params& p, int qpos, int kpos, int kloc) {
  bool valid = kloc < p.Skv;
  if (p.causal) {
    valid &= kpos <= qpos;
    if (p.window >= 0) {
      bool in_win = (qpos - kpos) < p.window;
      if (p.sinks) in_win |= kpos < p.sinks;
      valid &= in_win;
    }
  }
  return valid;
}

__device__ __forceinline__ float softcapped(const Params& p, float s) {
  return p.has_softcap ? p.softcap * tanhf(s / p.softcap) : s;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.

template <int D>
struct Bf16Smem {
  static constexpr int ROW = D + 8;    // bf16 per padded row: fragment loads hit 32 banks
  static constexpr int TILE = BKV * ROW;
  static constexpr int BYTES = (BQ * ROW + 4 * TILE) * 2;  // Q, 2 K, 2 V
  static constexpr int CPR = D / 8;    // 16-byte chunks a row
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(const Params p) {
  using S = Bf16Smem<D>;
  constexpr int KC = D / 16;  // k16 steps of Q·Kᵀ
  constexpr int NO = D / 8;   // n8 tiles of the output
  constexpr int RW = S::ROW / 2;  // 32-bit words a row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kbuf = qs + BQ * S::ROW;
  __nv_bfloat16* vbuf = kbuf + 2 * S::TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];
  const __nv_bfloat16* qg =
      reinterpret_cast<const __nv_bfloat16*>(p.q) + (size_t(b) * p.H + h) * p.Sq * D;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase;

  auto issue = [&](int t0, int buf) {
    for (int e = tid; e < BKV * S::CPR; e += 128) {
      const int r = e / S::CPR, c = e % S::CPR;
      const bool ok = t0 + r < p.Skv;
      const size_t src = size_t(ok ? t0 + r : 0) * D + 8 * c;
      cp_async16(kbuf + buf * S::TILE + r * S::ROW + 8 * c, kg + src, ok);
      cp_async16(vbuf + buf * S::TILE + r * S::ROW + 8 * c, vg + src, ok);
    }
    cp_async_commit();
  };
  const int q_last_row = min(q0 + BQ, p.Sq) - 1;
  const int first_q = q_off + q0, last_q = q_off + q_last_row;
  auto next_run = [&](int t0) {
    while (t0 < p.Skv &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BKV, p.Skv) - 1))
      t0 += BKV;
    return t0;
  };
  int t0 = next_run(0);
  if (t0 < p.Skv) issue(t0, 0);

  // Q tile, scaled in bf16 (each product rounded back to bf16).
  const float scale = p.sm_scale;
  for (int e = tid; e < BQ * S::CPR; e += 128) {
    const int r = e / S::CPR, c = e % S::CPR;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Sq) raw = *reinterpret_cast<const uint4*>(qg + size_t(q0 + r) * D + 8 * c);
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * scale);
    *reinterpret_cast<uint4*>(qs + r * S::ROW + 8 * c) = raw;
  }
  __syncthreads();
  // This thread's A fragments of Q: rows g and g+8 of the warp's 16.
  uint32_t qf[KC][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs);
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = q32[r0 * RW + kc * 8 + t];
      qf[kc][1] = q32[(r0 + 8) * RW + kc * 8 + t];
      qf[kc][2] = q32[r0 * RW + kc * 8 + 4 + t];
      qf[kc][3] = q32[(r0 + 8) * RW + kc * 8 + 4 + t];
    }
  }
  const int qpos_r[2] = {q_off + q0 + warp * 16 + g, q_off + q0 + warp * 16 + g + 8};
  const int wq_first = q_off + q0 + warp * 16, wq_last = wq_first + 15;

  float m[2] = {-INFINITY, -INFINITY}, lpart[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  auto tile = [&](auto unmasked_tag, int t0, const __nv_bfloat16* kt, const __nv_bfloat16* vt) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    float s[8][4];
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(kt);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t* kr = k32 + (8 * n + g) * RW + kc * 8 + t;
        mma_bf16(s[n], qf[kc], kr[0], kr[4]);
      }
    }
    // s[n][e]: row g + 8*(e>>1), key t0 + 8n + 2t + (e&1).
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = softcapped(p, s[n][e]);
        if (!UNMASKED) {
          const int kloc = t0 + 8 * n + 2 * t + (e & 1);
          if (!pair_valid(p, qpos_r[r], kv_off + kloc, kloc)) x = p.mask_value;
        }
        s[n][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    float alpha[2], m_next[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_next[r] = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = expf(m[r] - m_next[r]);
      live[r] = m_next[r] > p.mask_half;
      m[r] = m_next[r];
      lpart[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe = live[r] ? expf(s[n][e] - m_next[r]) : 0.f;
        lpart[r] += pe;
        s[n][e] = pe;
      }
    // P·V: k16 step kk takes S tiles 2kk, 2kk+1 as the A operand.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 pb = __floats2bfloat162_rn(s[2 * kk + hh][2 * r],
                                                          s[2 * kk + hh][2 * r + 1]);
          a[2 * hh + r] = *reinterpret_cast<const uint32_t*>(&pb);
        }
      const unsigned char* vrow =
          reinterpret_cast<const unsigned char*>(vt) + (16 * kk + (lane & 15)) * S::ROW * 2;
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, vrow + (n + (lane >> 4)) * 16);
        mma_bf16(acc[n], a, bfr[0], bfr[1]);
        mma_bf16(acc[n + 1], a, bfr[2], bfr[3]);
      }
    }
  };

  int buf = 0;
  while (t0 < p.Skv) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in shared memory; every warp is done with the other buffer
    const int tn = next_run(t0 + BKV);
    if (tn < p.Skv) issue(tn, buf ^ 1);
    const int tend = min(t0 + BKV, p.Skv);
    if (range_should_run(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1)) {
      const __nv_bfloat16* kt = kbuf + buf * S::TILE;
      const __nv_bfloat16* vt = vbuf + buf * S::TILE;
      if (range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + t0 + BKV - 1,
                         t0 + BKV - 1)) {
        tile(std::true_type{}, t0, kt, vt);
      } else {
        tile(std::false_type{}, t0, kt, vt);
      }
    }
    buf ^= 1;
    t0 = tn;
  }

  // Epilogue: o = acc · l_inv; lse = m + log l.
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) + (size_t(b) * p.H + h) * p.Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(lpart[r]);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.Sq) continue;
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(og + size_t(row) * D + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * l_inv, acc[n][2 * r + 1] * l_inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(size_t(b) * p.H + h) * p.Sq + row] = l > 0.f ? m[r] + logf(l) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores (the tile step of f32_tile.cuh).

template <int D>
struct F32Smem {
  static constexpr int ROW = F32Tile<D>::ROW;
  static constexpr int TILE = BKV * ROW;
  static constexpr int K_OFF = BQ * ROW;
  static constexpr int V_OFF = K_OFF + 2 * TILE;
  static constexpr int P_OFF = V_OFF + 2 * TILE;
  static constexpr int BYTES = (P_OFF + BQ * F32Tile<D>::PROW) * 4;
  static constexpr int CPR = D / 4;     // 16-byte chunks a row
};

template <int D>
__global__ void __launch_bounds__(TILE_THREADS) flash_fwd_f32_kernel(const Params p) {
  using S = F32Smem<D>;
  using T = F32Tile<D>;

  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* kbuf = fsm + S::K_OFF;
  float* vbuf = fsm + S::V_OFF;
  float* ps = fsm + S::P_OFF;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];
  const float* qg = reinterpret_cast<const float*>(p.q) + (size_t(b) * p.H + h) * p.Sq * D;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const float* kg = reinterpret_cast<const float*>(p.k) + kvbase;
  const float* vg = reinterpret_cast<const float*>(p.v) + kvbase;

  auto issue = [&](int t0, int buf) {
    for (int e = tid; e < BKV * S::CPR; e += TILE_THREADS) {
      const int r = e / S::CPR, c = e % S::CPR;
      const bool ok = t0 + r < p.Skv;
      const size_t src = size_t(ok ? t0 + r : 0) * D + 4 * c;
      cp_async16(kbuf + buf * S::TILE + r * S::ROW + 4 * c, kg + src, ok);
      cp_async16(vbuf + buf * S::TILE + r * S::ROW + 4 * c, vg + src, ok);
    }
    cp_async_commit();
  };
  const int q_last_row = min(q0 + BQ, p.Sq) - 1;
  const int first_q = q_off + q0, last_q = q_off + q_last_row;
  auto next_run = [&](int t0) {
    while (t0 < p.Skv &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BKV, p.Skv) - 1))
      t0 += BKV;
    return t0;
  };
  int t0 = next_run(0);
  if (t0 < p.Skv) issue(t0, 0);

  for (int e = tid; e < BQ * S::CPR; e += TILE_THREADS) {
    const int r = e / S::CPR, c = e % S::CPR;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) x = *reinterpret_cast<const float4*>(qg + size_t(q0 + r) * D + 4 * c);
    x.x *= p.sm_scale;
    x.y *= p.sm_scale;
    x.z *= p.sm_scale;
    x.w *= p.sm_scale;
    *reinterpret_cast<float4*>(qs + r * S::ROW + 4 * c) = x;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q_off + q0 + ty * 4 + i;
  float m[4], lpart[4], acc[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lpart[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc[i][c] = 0.f;
  }

  auto tile = [&](auto unmasked_tag, int t0, const float* kt, const float* vt) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    auto score = [&](int i, int key, float s) {
      float x = softcapped(p, s);
      if (!UNMASKED) {
        const int kloc = t0 + key;
        if (!pair_valid(p, qpos[i], kv_off + kloc, kloc)) x = p.mask_value;
      }
      return x;
    };
    f32_tile_step<D>(qs, kt, vt, ps, m, lpart, acc, p.mask_half, score,
                     [](int, float pe) { return pe; });
  };

  int buf = 0;
  while (t0 < p.Skv) {
    cp_async_wait_all();
    __syncthreads();  // this tile (and Q) in shared memory; the other buffers and P are free
    const int tn = next_run(t0 + BKV);
    if (tn < p.Skv) issue(tn, buf ^ 1);
    const float* kt = kbuf + buf * S::TILE;
    const float* vt = vbuf + buf * S::TILE;
    if (range_unmasked(p, first_q, last_q, kv_off + t0, kv_off + t0 + BKV - 1, t0 + BKV - 1)) {
      tile(std::true_type{}, t0, kt, vt);
    } else {
      tile(std::false_type{}, t0, kt, vt);
    }
    buf ^= 1;
    t0 = tn;
  }

  float* og = reinterpret_cast<float*>(p.o) + (size_t(b) * p.H + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum16(lpart[i]);
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int nv = 0; nv < T::NV; ++nv) {
      typename T::Vec out;
      float* of = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int w = 0; w < T::VW; ++w) of[w] = acc[i][nv * T::VW + w] * l_inv;
      *reinterpret_cast<typename T::Vec*>(og + size_t(row) * D + tx * T::VW + 16 * T::VW * nv) = out;
    }
    if (p.lse != nullptr && tx == 0) {
      p.lse[(size_t(b) * p.H + h) * p.Sq + row] = l > 0.f ? m[i] + logf(l) : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int bf16, cudaStream_t stream) {
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  cudaError_t err;
  if (bf16) {
    constexpr int smem = Bf16Smem<D>::BYTES;
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<D><<<grid, 128, smem, stream>>>(p);
  } else {
    constexpr int smem = F32Smem<D>::BYTES;
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<D><<<grid, TILE_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* offs, void* o,
                         void* lse, int B, int H, int Hkv, int Sq, int Skv, int D, float sm_scale,
                         int has_softcap, float softcap, int causal, int window, int sinks,
                         float mask_value, float mask_half, int bf16, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.offs = static_cast<const int*>(offs);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.mask_value = mask_value;
  p.mask_half = mask_half;
  p.has_softcap = has_softcap;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(p, bf16, s); break;
    case 64: err = launch<64>(p, bf16, s); break;
    case 128: err = launch<128>(p, bf16, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
