// Paged INT8-KV decode attention (q_len = 1, GQA) for Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas decode kernels:
//   * quantizedmha_tpu/ops/decode.py:527 _decode_kernel_hfold (num_kv_heads > 1)
//   * quantizedmha_tpu/ops/decode.py:53  _decode_kernel (the per-kv-head grid
//     form, used for MQA, num_kv_heads == 1)
// Both compute the same function; one CUDA kernel serves both.
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
// What bounds it on the H100: bytes. Each (sequence, kv head) reads its
// int8 K and V pages once: at batch 8, 8 kv heads, d=128 and ~280 tokens
// of context that is ~4.6 MB per layer, ~1.4 us at 3.35 TB/s. At that size
// the launch and the serial page walk (a few pages per block, 64 blocks on
// 132 SMs) dominate, not the bandwidth.
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

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;

struct Params {
  const void* q;          // [B, Hq, D] f32 or bf16
  const int8_t* k_pages;  // [Hkv, num_pages, page_size, D]
  const int8_t* v_pages;
  const float* k_scales;  // [Hkv, num_pages]
  const float* v_scales;
  const int* lengths;     // [B] context length, pending token included
  const int* tables;      // [B, max_pages] physical page ids
  void* o;                // [B, Hq, D], q's dtype
  float* lse;             // [B, Hq] or nullptr
  int B, Hq, Hkv, num_pages, page_size, max_pages;
  float sm_scale, softcap, mask_value;
  int has_softcap, window, sinks;  // window < 0: none
};

template <int D>
size_t smem_bytes(int group, int page_size) {
  return size_t(group) * D * 4          // q * sm_scale
         + size_t(page_size) * (D / 4 + 1) * 4  // K page, padded rows
         + size_t(page_size) * D          // V page
         + size_t(group) * page_size * 4  // scores / P
         + size_t(group) * D * 4          // accumulator
         + size_t(group) * 3 * 4;         // m, l, alpha
}

template <int D, bool QBF16>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const Params p) {
  constexpr int KW = D / 4 + 1;  // padded words per K row (no bank conflicts)
  const int G = p.Hq / p.Hkv;
  const int P = p.page_size;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem);           // [G][D]
  int* kp = reinterpret_cast<int*>(qf + G * D);          // [P][KW]
  signed char* vp = reinterpret_cast<signed char*>(kp + P * KW);  // [P][D]
  float* sc = reinterpret_cast<float*>(vp + P * D);      // [G][P]
  float* acc = sc + G * P;                               // [G][D]
  float* mrow = acc + G * D;                             // [G]
  float* lrow = mrow + G;
  float* arow = lrow + G;

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
    const size_t poff = (size_t(h) * p.num_pages + page) * P * D;
    const float ksc = p.k_scales[size_t(h) * p.num_pages + page];
    const float vsc = p.v_scales[size_t(h) * p.num_pages + page];
    __syncthreads();  // previous page's readers are done
    {
      const int* kg = reinterpret_cast<const int*>(p.k_pages + poff);
      const int4* vg = reinterpret_cast<const int4*>(p.v_pages + poff);
      for (int e = tid; e < P * (D / 4); e += NT) kp[(e / (D / 4)) * KW + e % (D / 4)] = kg[e];
      for (int e = tid; e < P * D / 16; e += NT) reinterpret_cast<int4*>(vp)[e] = vg[e];
    }
    __syncthreads();

    // Scores: s = (q*sm_scale · k) * k_scale, then softcap and mask.
    for (int e = tid; e < G * P; e += NT) {
      const int g = e / P, t = e % P;
      const float* qg = qf + g * D;
      const int* kr = kp + t * KW;
      float dot = 0.f;
#pragma unroll 8
      for (int w = 0; w < D / 4; ++w) {
        const int kw = kr[w];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dot = fmaf(qg[4 * w + c], static_cast<float>(static_cast<signed char>((kw >> (8 * c)) & 0xff)), dot);
      }
      float s = dot * ksc;
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
        sg[t] = pe;
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

    // acc = acc * alpha + (P · V) * v_scale
    for (int e = tid; e < G * D; e += NT) {
      const int g = e / D, d = e % D;
      const float* pg = sc + g * P;
      float pv = 0.f;
      for (int t = 0; t < P; ++t) pv = fmaf(pg[t], static_cast<float>(vp[t * D + d]), pv);
      acc[e] = acc[e] * arow[g] + pv * vsc;
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

template <int D, bool QBF16>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(p.Hq / p.Hkv, p.page_size);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, QBF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(p.Hkv, p.B);
  paged_decode_kernel<D, QBF16><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scales, const void* v_scales, const void* lengths,
                            const void* tables, void* o, void* lse, int B, int Hq, int Hkv,
                            int num_pages, int page_size, int max_pages, int D,
                            float sm_scale, int has_softcap, float softcap, int window,
                            int sinks, float mask_value, int q_bf16, void* stream) {
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
  p.sm_scale = sm_scale;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.window = window;
  p.sinks = sinks;
  p.mask_value = mask_value;
  if (page_size % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = q_bf16 ? launch<32, true>(p, s) : launch<32, false>(p, s); break;
    case 64: err = q_bf16 ? launch<64, true>(p, s) : launch<64, false>(p, s); break;
    case 128: err = q_bf16 ? launch<128, true>(p, s) : launch<128, false>(p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
