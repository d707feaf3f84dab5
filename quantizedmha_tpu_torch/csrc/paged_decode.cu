// Paged-KV decode attention (q_len = 1, GQA) for Hopper (sm_90a), over
// INT8 pages or nibble-packed INT4 pages: one kernel template, two page
// formats.
//
// Replaces the JAX package's three Pallas decode kernels:
//   * quantizedmha_tpu/ops/decode.py:527 _decode_kernel_hfold (num_kv_heads > 1)
//   * quantizedmha_tpu/ops/decode.py:53  _decode_kernel (the per-kv-head grid
//     form, used for MQA, num_kv_heads == 1)
//   * quantizedmha_tpu/ops/decode.py:897 _decode_kernel_int4 (INT4 pages,
//     entry paged_decode_int4)
// The first two compute the same function; the INT8 form serves both.
//
// Function: for each sequence b and kv head h, the q group (Hq / Hkv query
// heads) attends to the first lengths[b] positions of the sequence's pages,
// found through block_tables[b]. f32 throughout: q is scaled by sm_scale
// BEFORE the dot; the K scale of (h, page) multiplies the score after the
// dot and the V scale multiplies P·V (the pages_per_step == 1 form of the
// JAX kernel; its J > 1 form moves the V scale onto P, equal up to f32
// rounding). Positions >= length, and behind the sliding window (sink
// positions excepted), are masked; pages holding no visible position are
// skipped outright. An empty row (l == 0) gives o = 0, lse = -inf.
//
// INT4 form: a packed row holds D/2 bytes (byte j: element j in the low
// nibble, element j + D/2 in the high one; int4.cuh), and every key t of a
// page has the K and V scale of its sub-tile, scales[h, page, t / (P /
// subs)]. The K scale multiplies the score; the V scale is folded into P
// before P·V (the JAX kernel's p_s), while l sums the unscaled P. Rows
// with length 0 (the INT4 partial of every sequence still below the mixed
// cache's boundary) give o = 0 and lse = -inf, which the lse merge needs.
//
// What bounds it on the H100: bytes. Each (sequence, kv head) reads its
// int8 K and V pages once: at batch 8, 8 kv heads, d=128 and ~280 tokens
// of context that is ~4.6 MB per layer, ~1.4 us at 3.35 TB/s. At that size
// the launch and the serial page walk (a few pages per block, 64 blocks on
// 132 SMs) dominate, not the bandwidth.
//
// The INT4 form reads half the bytes of the INT8 one at the same context:
// at serve_mixed's batch 8 and 1.7k-7.7k of INT4 context, ~60 MB a layer,
// ~18 us at 3.35 TB/s.
//
// What this design does about it: one thread block per (sequence, kv head)
// holds the whole q group, so each page is read from memory once for all
// of the group's query heads (the head-fold of _decode_kernel_hfold), and
// only the pages a sequence actually needs are touched (the clamped index
// maps of the JAX kernel). A split-K over pages across blocks, to fill the
// card at small batch, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int4.cuh"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;

struct Params {
  const void* q;          // [B, Hq, D] f32 or bf16
  const int8_t* k_pages;  // [Hkv, num_pages, page_size, D]
  const int8_t* v_pages;
  const float* k_scales;  // [Hkv, num_pages], INT4: [Hkv, num_pages, subs]
  const float* v_scales;
  const int* lengths;     // [B] context length, pending token included
  const int* tables;      // [B, max_pages] physical page ids
  void* o;                // [B, Hq, D], q's dtype
  float* lse;             // [B, Hq] or nullptr
  int B, Hq, Hkv, num_pages, page_size, max_pages, subs;
  float sm_scale, softcap, mask_value;
  int has_softcap, window, sinks;  // window < 0: none
};

// Bytes of one stored K or V row, and padded 32-bit words of a K row in
// shared memory (no bank conflicts).
template <int D, bool INT4>
struct Row {
  static constexpr int BYTES = INT4 ? D / 2 : D;
  static constexpr int KW = BYTES / 4 + 1;
};

template <int D, bool INT4>
size_t smem_bytes(int group, int page_size) {
  using R = Row<D, INT4>;
  return size_t(group) * D * 4                  // q * sm_scale
         + size_t(page_size) * R::KW * 4         // K page, padded rows
         + size_t(page_size) * R::BYTES          // V page
         + size_t(group) * page_size * 4         // scores / P
         + size_t(group) * D * 4                 // accumulator
         + size_t(group) * 3 * 4                 // m, l, alpha
         + (INT4 ? size_t(page_size) * 2 * 4 : 0);  // per-key K and V scales
}

template <int D, bool QBF16, bool INT4>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const Params p) {
  using R = Row<D, INT4>;
  constexpr int KW = R::KW;
  constexpr int RB = R::BYTES;
  const int G = p.Hq / p.Hkv;
  const int P = p.page_size;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem);           // [G][D]
  int* kp = reinterpret_cast<int*>(qf + G * D);          // [P][KW]
  signed char* vp = reinterpret_cast<signed char*>(kp + P * KW);  // [P][RB]
  float* sc = reinterpret_cast<float*>(vp + P * RB);     // [G][P]
  float* acc = sc + G * P;                               // [G][D]
  float* mrow = acc + G * D;                             // [G]
  float* lrow = mrow + G;
  float* arow = lrow + G;
  float* kss = arow + G;                                 // INT4: [P] per-key scales
  float* vss = kss + P;

  for (int e = tid; e < G * D; e += NT) {
    const size_t qi = (size_t(b) * p.Hq + h * G) * D + e;
    const float x = QBF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.q)[qi])
                          : reinterpret_cast<const float*>(p.q)[qi];
    qf[e] = x * p.sm_scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    mrow[g] = -INFINITY;
    lrow[g] = 0.f;
  }

  const int length = p.lengths[b];
  const int n_pages = min((length + P - 1) / P, p.max_pages);
  for (int i = 0; i < n_pages; ++i) {
    const int base = i * P;
    if (p.window >= 0) {
      bool in_win = base + P > length - p.window;
      if (p.sinks) in_win |= base < p.sinks;
      if (!in_win) continue;
    }
    const int page = p.tables[b * p.max_pages + i];
    const size_t poff = (size_t(h) * p.num_pages + page) * P * RB;
    const size_t sbase = (size_t(h) * p.num_pages + page) * p.subs;
    const float ksc = p.k_scales[sbase];
    const float vsc = p.v_scales[sbase];
    __syncthreads();  // previous page's readers are done
    {
      const int* kg = reinterpret_cast<const int*>(p.k_pages + poff);
      const int4* vg = reinterpret_cast<const int4*>(p.v_pages + poff);
      for (int e = tid; e < P * (RB / 4); e += NT) kp[(e / (RB / 4)) * KW + e % (RB / 4)] = kg[e];
      for (int e = tid; e < P * RB / 16; e += NT) reinterpret_cast<int4*>(vp)[e] = vg[e];
      if (INT4) {
        const int sub_w = P / p.subs;
        for (int t = tid; t < P; t += NT) {
          const int sub = t / sub_w;
          kss[t] = p.k_scales[sbase + sub];
          vss[t] = p.v_scales[sbase + sub];
        }
      }
    }
    __syncthreads();

    // Scores: s = (q*sm_scale · k) * k_scale, then softcap and mask.
    for (int e = tid; e < G * P; e += NT) {
      const int g = e / P, t = e % P;
      const float* qg = qf + g * D;
      const int* kr = kp + t * KW;
      float dot = 0.f;
      if (INT4) {
#pragma unroll 8
        for (int w = 0; w < RB / 4; ++w) {
          const int kw = kr[w];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kb = packed_byte(kw, c);
            dot = fmaf(qg[4 * w + c], static_cast<float>(int4_lo(kb)), dot);
            dot = fmaf(qg[D / 2 + 4 * w + c], static_cast<float>(int4_hi(kb)), dot);
          }
        }
      } else {
#pragma unroll 8
        for (int w = 0; w < D / 4; ++w) {
          const int kw = kr[w];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dot = fmaf(qg[4 * w + c], static_cast<float>(packed_byte(kw, c)), dot);
        }
      }
      float s = dot * (INT4 ? kss[t] : ksc);
      if (p.has_softcap) s = p.softcap * tanhf(s / p.softcap);
      const int pos = base + t;
      bool valid = pos < length;
      if (p.window >= 0) {
        bool in_win = pos >= length - p.window;
        if (p.sinks) in_win |= pos < p.sinks;
        valid &= in_win;
      }
      sc[e] = valid ? s : p.mask_value;
    }
    __syncthreads();

    // Online softmax, one warp per query head of the group.
    for (int g = warp; g < G; g += NWARPS) {
      float* sg = sc + g * P;
      float mc = -INFINITY;
      for (int t = lane; t < P; t += 32) mc = fmaxf(mc, sg[t]);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_prev = mrow[g];
      const float m_next = fmaxf(m_prev, mc);
      float ls = 0.f;
      for (int t = lane; t < P; t += 32) {
        const float pe = expf(sg[t] - m_next);
        sg[t] = INT4 ? pe * vss[t] : pe;  // INT4: the key's V scale folded into P
        ls += pe;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        arow[g] = alpha;
        lrow[g] = alpha * lrow[g] + ls;
        mrow[g] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + (P · V) * v_scale (INT4: P already carries it)
    for (int e = tid; e < G * D; e += NT) {
      const int g = e / D, d = e % D;
      const float* pg = sc + g * P;
      float pv = 0.f;
      if (INT4) {
        const bool high = d >= D / 2;
        const int col = high ? d - D / 2 : d;
        for (int t = 0; t < P; ++t) {
          const int vb = vp[t * RB + col];
          pv = fmaf(pg[t], static_cast<float>(high ? int4_hi(vb) : int4_lo(vb)), pv);
        }
        acc[e] = acc[e] * arow[g] + pv;
      } else {
        for (int t = 0; t < P; ++t) pv = fmaf(pg[t], static_cast<float>(vp[t * D + d]), pv);
        acc[e] = acc[e] * arow[g] + pv * vsc;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < G * D; e += NT) {
    const int g = e / D;
    const float l = lrow[g];
    const float out = acc[e] * (l == 0.f ? 1.f : 1.f / l);
    const size_t oi = (size_t(b) * p.Hq + h * G) * D + e;
    if (QBF16) {
      reinterpret_cast<__nv_bfloat16*>(p.o)[oi] = __float2bfloat16_rn(out);
    } else {
      reinterpret_cast<float*>(p.o)[oi] = out;
    }
  }
  if (p.lse != nullptr) {
    for (int g = tid; g < G; g += NT) {
      const float l = lrow[g];
      p.lse[size_t(b) * p.Hq + h * G + g] =
          l == 0.f ? -INFINITY : mrow[g] + logf(fmaxf(l, 1e-38f));
    }
  }
}

template <int D, bool QBF16, bool INT4>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, INT4>(p.Hq / p.Hkv, p.page_size);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, QBF16, INT4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(p.Hkv, p.B);
  paged_decode_kernel<D, QBF16, INT4><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool INT4>
int dispatch(const Params& p, int D, int q_bf16, void* stream) {
  if (p.page_size % 16 || p.subs < 1 || p.page_size % p.subs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.B == 0) return 0;
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

Params make_params(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales, const void* lengths,
                   const void* tables, void* o, void* lse, int B, int Hq, int Hkv,
                   int num_pages, int page_size, int max_pages, int subs, float sm_scale,
                   int has_softcap, float softcap, int window, int sinks, float mask_value) {
  Params p;
  p.q = q;
  p.k_pages = static_cast<const int8_t*>(k_pages);
  p.v_pages = static_cast<const int8_t*>(v_pages);
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.tables = static_cast<const int*>(tables);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.num_pages = num_pages;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.subs = subs;
  p.sm_scale = sm_scale;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.window = window;
  p.sinks = sinks;
  p.mask_value = mask_value;
  return p;
}

}  // namespace

extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scales, const void* v_scales, const void* lengths,
                            const void* tables, void* o, void* lse, int B, int Hq, int Hkv,
                            int num_pages, int page_size, int max_pages, int D,
                            float sm_scale, int has_softcap, float softcap, int window,
                            int sinks, float mask_value, int q_bf16, void* stream) {
  const Params p = make_params(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, o, lse,
                               B, Hq, Hkv, num_pages, page_size, max_pages, 1, sm_scale,
                               has_softcap, softcap, window, sinks, mask_value);
  return dispatch<false>(p, D, q_bf16, stream);
}

// INT4 pages [Hkv, num_pages, page_size, D/2], scales [Hkv, num_pages, subs].
extern "C" int paged_decode_int4(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scales, const void* v_scales,
                                 const void* lengths, const void* tables, void* o, void* lse,
                                 int B, int Hq, int Hkv, int num_pages, int page_size,
                                 int max_pages, int D, int subs, float sm_scale,
                                 int has_softcap, float softcap, int window, int sinks,
                                 float mask_value, int q_bf16, void* stream) {
  const Params p = make_params(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, o, lse,
                               B, Hq, Hkv, num_pages, page_size, max_pages, subs, sm_scale,
                               has_softcap, softcap, window, sinks, mask_value);
  return dispatch<true>(p, D, q_bf16, stream);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
