// Paged-KV decode attention (q_len = 1, GQA) for Hopper (sm_90a), over
// INT8 pages or nibble-packed INT4 pages: one kernel template, two page
// formats, plus the merge of a sequence's splits.
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
// dot, then softcap, then the mask value; the V scale multiplies a page's
// P·V. Positions >= length, and behind the sliding window (sink positions
// excepted), are masked; pages holding no visible position are skipped
// outright. An empty row (l == 0) gives o = 0, lse = -inf.
//
// INT4 form: a packed row holds D/2 bytes (byte j: element j in the low
// nibble, element j + D/2 in the high one), and every key t of a page has
// the K and V scale of its sub-tile, scales[h, page, t / (P / subs)]. The
// K scale multiplies the score; the V scale is folded into P before P·V
// (summed onto acc * alpha key by key: the plain version's terms in
// another order), while l sums the unscaled P. Rows with length 0 (the INT4 partial of
// every sequence still below the mixed cache's boundary) give o = 0 and
// lse = -inf, which the lse merge needs.
//
// What bounds it on the H100: bytes. Each (sequence, kv head) must read its
// int8 (int4) K and V pages once: at batch 8, 8 kv heads and 2-8k of
// context that is ~84 MB (INT4: ~40 MB), 25 us (12 us) at 3.35 TB/s. Its
// f32 arithmetic, ~0.66 GFLOP there, is ~10 us at the FMA rate, so f32 on
// the CUDA cores keeps up once the work is spread over the card and the
// inner loops are register-blocked.
//
// What this design does about it:
//   * Flash-decoding split. The grid is (kv head x q-head chunk, sequence,
//     split): split s walks its own contiguous range of the sequence's
//     logical pages (ops/decode.py:decode_splits, the same splits as the
//     plain version) from zero state and writes its unnormalised f32 sum
//     and its m and l; decode_merge_kernel then merges a row's splits by
//     lse over s in order, so two launches give the same bits. One split
//     writes o and lse itself. A split holding no visible page exits at
//     once with m = -inf, l = 0, and the merge skips it. A block (four
//     warps, three to an SM) holds at most 16 query heads of the group;
//     while the grid is short of two blocks an SM, a large group (MQA) is
//     cut into blocks of 8 heads.
//   * A page copy in flight. cp.async double-buffers each page's K and V
//     rows and its per-key scales: the next visible page is issued before
//     this page's math.
//   * Register blocking. A warp holds four query heads. Scores: each lane
//     reads 16 elements of a K row (16 bytes of int8, 8 bytes of nibbles),
//     neighbouring lanes on neighbouring bytes, against the same 16
//     elements of the four q rows in registers; the D/16 lanes of a row
//     reduce-scatter the four dots by warp shuffle (at d=256, 16 lanes: a
//     fifth shuffle). P·V: each lane reads a 4-byte word of a V row (int8
//     at d=256: 8 bytes, so that a row stays within the warp) and a float4
//     of P (the four heads of one key) into four (INT4 and int8 at d=256:
//     eight) columns of four heads. int8 and int4 values
//     become f32 exactly by the 2^23 mantissa trick (byte_perm, one FADD),
//     not by the quarter-rate int-to-float conversion. Softcap is a
//     compile-time choice (a runtime branch in the per-score loop would be
//     if-converted).
//   * d=256 (Gemma-2): K and V pages of 128 keys take 128 KB of the two
//     stages, so one block an SM (the launch bound asks for one, which
//     leaves the registers for the larger P·V tile).
// No fast math: expf and logf as before, so the f32 numerics are the
// plain version's up to summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int GW = 4;            // query heads a warp holds
constexpr int MAXG = GW * NW;    // query heads a block holds at most
constexpr int FILL = 2 * 132;    // blocks that give each of the H100's SMs two
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;          // [B, Hq, D] f32 or bf16
  const int8_t* k_pages;  // [Hkv, num_pages, page_size, D] (INT4: D/2 bytes a row)
  const int8_t* v_pages;
  const float* k_scales;  // [Hkv, num_pages, subs]
  const float* v_scales;
  const int* lengths;     // [B] context length, pending token included
  const int* tables;      // [B, max_pages] physical page ids
  void* o;                // [B, Hq, D], q's dtype
  float* lse;             // [B, Hq] or nullptr
  float* part;            // splits > 1: [splits, B, Hq, D] unnormalised sums
  float* ml;              // splits > 1: [2, splits, B, Hq], m then l
  int B, Hq, Hkv, num_pages, page_size, max_pages, subs, splits, pages_per_split;
  int heads;              // query heads a block (a multiple of 4, at most MAXG)
  float sm_scale, softcap, mask_value;
  int window, sinks, q_bf16;  // window < 0: none
};

// How the lanes of a warp cover a page's rows.
template <int D, bool INT4>
struct Geo {
  static constexpr int RB = INT4 ? D / 2 : D;  // bytes of a stored row
  // Scores: a lane reads VB bytes (16 elements) of a K row, LPR lanes a row.
  static constexpr int VB = INT4 ? 8 : 16;
  static constexpr int LPR = RB / VB;
  static constexpr int KPI = 32 / LPR;         // keys a warp scores at once
  // P·V: a lane reads a WB-byte word (EPL elements) of a V row, LW <= 32
  // lanes a row (a 4-byte word but for int8 rows of 256 bytes).
  static constexpr int LW = RB / 4 < 32 ? RB / 4 : 32;
  static constexpr int WB = RB / LW;
  static constexpr int KG = 32 / LW;           // keys a warp sums at once
  static constexpr int EPL = INT4 ? 8 : WB;
};

// Byte offsets in dynamic shared memory for GP (a multiple of 4) q heads.
template <int D, bool INT4>
struct Layout {
  size_t scales, q, sc, pt, stat, total;
  __host__ __device__ Layout(int gp, int P) {
    const size_t stages = 4 * size_t(P) * Geo<D, INT4>::RB;  // K and V pages, two stages
    const size_t red = size_t(NW) * GW * D * 4;  // the warps' sums at the end, over the stages
    scales = stages > red ? stages : red;
    q = scales + 4 * size_t(P) * 4;              // per-key K and V scales, two stages
    sc = q + size_t(gp) * D * 4;                 // q * sm_scale [gp][D]
    pt = sc + size_t(gp) * P * 4;                // scores [gp][P]
    stat = pt + size_t(P) * gp * 4;              // P (INT4: P * v_scale) [P][gp]
    total = stat + 3 * size_t(gp) * 4;           // m, l, alpha
  }
};

// Four int8 values of a word to f32, exactly: the byte plus 128 becomes the
// low mantissa byte of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + c)) - 8388736.f;
  }
}

// Eight int4 values of a word of four packed bytes: byte c's low nibble to
// lo[c], its high nibble to hi[c]; a signed nibble plus 8 goes into the
// mantissa of 2^23 likewise, less 2^23 + 8.
__device__ __forceinline__ void int4x8(uint32_t w, float* lo, float* hi) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t lb = u & 0x0F0F0F0Fu;
  const uint32_t hb = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = __uint_as_float(__byte_perm(lb, 0x4B000000u, 0x7540 + c)) - 8388616.f;
    hi[c] = __uint_as_float(__byte_perm(hb, 0x4B000000u, 0x7540 + c)) - 8388616.f;
  }
}

// Column of element e (0-15) of the 16 a scoring lane of row lane lr holds.
template <int D, bool INT4>
__device__ __forceinline__ int score_col(int lr, int e) {
  if (INT4) return e < 8 ? lr * 8 + e : D / 2 + lr * 8 + e - 8;
  return lr * 16 + e;
}

// Column of element e of the EPL a P·V lane of row lane lw holds.
template <int D, bool INT4>
__device__ __forceinline__ int pv_col(int lw, int e) {
  if (INT4) return e < 4 ? lw * 4 + e : D / 2 + lw * 4 + e - 4;
  return lw * Geo<D, INT4>::WB + e;
}

// The LPR lanes of a K row hold partial dots of the warp's four heads:
// halve the heads at each step (send the half the partner keeps), then sum
// what is left. Returns the first head this lane's dot[0..] now holds in
// full (LPR 2: two heads; 4, 8 and 16: one, held LPR / 4 times).
template <int LPR>
__device__ __forceinline__ int reduce_scatter(float (&dot)[GW], int lane) {
  static_assert(GW == 4 && LPR >= 2 && LPR <= 16, "four heads over 2-16 lanes");
  int hoff;
  {
    constexpr int o = LPR / 2;
    const bool up = (lane & o) != 0;
    const float s0 = up ? dot[0] : dot[2], s1 = up ? dot[1] : dot[3];
    const float k0 = up ? dot[2] : dot[0], k1 = up ? dot[3] : dot[1];
    dot[0] = k0 + __shfl_xor_sync(FULL, s0, o);
    dot[1] = k1 + __shfl_xor_sync(FULL, s1, o);
    hoff = up ? 2 : 0;
  }
  if constexpr (LPR >= 4) {
    constexpr int o = LPR / 4;
    const bool up = (lane & o) != 0;
    const float sent = up ? dot[0] : dot[1];
    const float kept = up ? dot[1] : dot[0];
    dot[0] = kept + __shfl_xor_sync(FULL, sent, o);
    hoff += up ? 1 : 0;
  }
  if constexpr (LPR >= 8) dot[0] += __shfl_xor_sync(FULL, dot[0], LPR / 8);
  if constexpr (LPR >= 16) dot[0] += __shfl_xor_sync(FULL, dot[0], LPR / 16);
  return hoff;
}

__device__ __forceinline__ float lse_of(float m, float l) {
  return l == 0.f ? -INFINITY : m + logf(fmaxf(l, 1e-38f));
}

__device__ __forceinline__ void store_out(const Params& p, size_t i, float x) {
  if (p.q_bf16) {
    static_cast<__nv_bfloat16*>(p.o)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p.o)[i] = x;
  }
}

template <int D, bool INT4, bool CAP>
__global__ void __launch_bounds__(NT, D == 256 ? 1 : 3) paged_decode_kernel(const Params p) {
  using Gm = Geo<D, INT4>;
  constexpr int RB = Gm::RB;
  constexpr int LPR = Gm::LPR, KPI = Gm::KPI;
  constexpr int LW = Gm::LW, KG = Gm::KG, EPL = Gm::EPL;
  constexpr int NK = LPR >= 4 ? 1 : 2;   // heads a scoring lane holds after the reduction
  constexpr int DUP = LPR >= 8 ? LPR / 4 : 1;  // lanes holding the same heads
  const int P = p.page_size;
  const int G = p.Hq / p.Hkv;
  const int chunks = (G + p.heads - 1) / p.heads;
  const int h = blockIdx.x / chunks;
  const int hq0 = h * G + (blockIdx.x % chunks) * p.heads;  // the block's first q head
  const int HC = min(h * G + G - hq0, p.heads);              // its q heads
  const int NG = (HC + GW - 1) / GW;                     // its head quads
  const int GP = NG * GW;
  const int WPG = NW / NG;                               // warps sharing a quad
  const int b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hg = warp / WPG, ks = warp % WPG;  // the warp's quad (none if hg >= NG), key slice
  const size_t row0 = size_t(b) * p.Hq + hq0;
  const size_t mslot = (size_t(s) * p.B + b) * p.Hq + hq0;  // this split's m; l one plane on
  const size_t lplane = size_t(p.splits) * p.B * p.Hq;

  const Layout<D, INT4> lay(GP, P);
  extern __shared__ __align__(16) unsigned char smem[];
  float* scl = reinterpret_cast<float*>(smem + lay.scales);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* pt = reinterpret_cast<float*>(smem + lay.pt);
  float* m_s = reinterpret_cast<float*>(smem + lay.stat);
  float* l_s = m_s + GP;
  float* a_s = l_s + GP;

  // The split's logical pages [p_begin, p_end); the visible ones are the
  // sink pages [0, ns) and the window's [w0, n_pages).
  const int length = p.lengths[b];
  const int n_pages = min((length + P - 1) / P, p.max_pages);
  const int p_begin = s * p.pages_per_split;
  const int p_end = min(p_begin + p.pages_per_split, n_pages);
  int ns = n_pages, w0 = 0;
  if (p.window >= 0) {
    ns = (p.sinks + P - 1) / P;
    w0 = max(length - p.window, 0) / P;
  }
  auto next_visible = [&](int i) { return (i < ns || i >= w0) ? i : w0; };
  int i = next_visible(p_begin);
  if (i >= p_end && p.splits > 1) {  // no visible page: nothing for the merge
    for (int g = tid; g < HC; g += NT) {
      p.ml[mslot + g] = -INFINITY;
      p.ml[lplane + mslot + g] = 0.f;
    }
    return;
  }

  for (int e = tid; e < GP * D; e += NT) {
    float x = 0.f;
    if (e < HC * D) {
      const size_t qi = row0 * D + e;
      x = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[qi])
                   : static_cast<const float*>(p.q)[qi];
      x *= p.sm_scale;
    }
    q_s[e] = x;
  }
  for (int g = tid; g < GP; g += NT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();
  // The warp's four q rows, its lanes' 16 elements each, for the whole split.
  float qr[GW][16];
  {
    const int lr = lane % LPR;
    const int g0 = hg < NG ? hg * GW : 0;
#pragma unroll
    for (int g = 0; g < GW; ++g) {
#pragma unroll
      for (int e = 0; e < 16; ++e) qr[g][e] = q_s[(g0 + g) * D + score_col<D, INT4>(lr, e)];
    }
  }

  const int* table = p.tables + size_t(b) * p.max_pages;
  const int sub_w = P / p.subs;
  // cp.async of logical page pi's K and V rows and per-key scales into stage buf.
  auto issue = [&](int pi, int buf) {
    const size_t at = size_t(h) * p.num_pages + table[pi];
    const int8_t* kg = p.k_pages + at * P * RB;
    const int8_t* vg = p.v_pages + at * P * RB;
    unsigned char* kst = smem + size_t(buf) * 2 * P * RB;
    unsigned char* vst = kst + size_t(P) * RB;
    for (int c = tid; c < P * RB / 16; c += NT) {
      cp_async16(kst + 16 * c, kg + 16 * c, true);
      cp_async16(vst + 16 * c, vg + 16 * c, true);
    }
    float* sk = scl + buf * 2 * P;
    for (int t = tid; t < P; t += NT) {
      const int sub = t / sub_w;
      cp_async4(sk + t, p.k_scales + at * p.subs + sub, true);
      cp_async4(sk + P + t, p.v_scales + at * p.subs + sub, true);
    }
    cp_async_commit();
  };

  float acc[GW][EPL];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  if (i < p_end) issue(i, 0);
  for (int buf = 0; i < p_end; buf ^= 1) {
    const int nxt = next_visible(i + 1);
    cp_async_wait_all();
    __syncthreads();  // page i is in stage buf; stage buf ^ 1 and the last P are free
    if (nxt < p_end) issue(nxt, buf ^ 1);
    const unsigned char* kst = smem + size_t(buf) * 2 * P * RB;
    const unsigned char* vst = kst + size_t(P) * RB;
    const float* sk = scl + buf * 2 * P;
    const float* sv = sk + P;
    const int base = i * P;

    // Scores: s = (q*sm_scale · k) * k_scale, then softcap and mask.
    if (hg < NG) {
      const int lr = lane % LPR;
#pragma unroll 2
      for (int t = ks * KPI + lane / LPR; t < P; t += WPG * KPI) {
        float kf[16];
        if constexpr (INT4) {
          const uint2 w = *reinterpret_cast<const uint2*>(kst + t * RB + lr * 8);
          int4x8(w.x, kf, kf + 8);
          int4x8(w.y, kf + 4, kf + 12);
        } else {
          const uint4 w = *reinterpret_cast<const uint4*>(kst + t * RB + lr * 16);
          int8x4(w.x, kf);
          int8x4(w.y, kf + 4);
          int8x4(w.z, kf + 8);
          int8x4(w.w, kf + 12);
        }
        float dot[GW];
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          dot[g] = 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) dot[g] = fmaf(qr[g][e], kf[e], dot[g]);
        }
        const int hoff = reduce_scatter<LPR>(dot, lane);
        if (lr % DUP == 0) {
          const int pos = base + t;
          bool valid = pos < length;
          if (p.window >= 0) valid &= pos >= length - p.window || pos < p.sinks;
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            const int g = hg * GW + hoff + j;
            float x = dot[j] * sk[t];
            if (CAP) x = p.softcap * tanhf(x / p.softcap);
            if (g < HC) sc[g * P + t] = valid ? x : p.mask_value;
          }
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per query head.
    for (int g = warp; g < HC; g += NW) {
      const float* sg = sc + g * P;
      float mc = -INFINITY;
      for (int t = lane; t < P; t += 32) mc = fmaxf(mc, sg[t]);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, o));
      const float m_prev = m_s[g];
      const float m_next = fmaxf(m_prev, mc);
      float ls = 0.f;
      for (int t = lane; t < P; t += 32) {
        const float pe = expf(sg[t] - m_next);
        pt[t * GP + g] = INT4 ? pe * sv[t] : pe;  // INT4: the key's V scale folded into P
        ls += pe;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) ls += __shfl_xor_sync(FULL, ls, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + ls;
        m_s[g] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + (P · V) * v_scale. INT4: P already carries the
    // V scale, so P · V is summed onto acc * alpha directly.
    if (hg < NG) {
      float pv[GW][INT4 ? 1 : EPL];
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        const float a = a_s[hg * GW + g];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          if constexpr (INT4) {
            acc[g][e] *= a;
          } else {
            pv[g][e] = 0.f;
          }
        }
      }
      const int lw = lane % LW;
#pragma unroll 4
      for (int t = ks * KG + lane / LW; t < P; t += WPG * KG) {
        float vf[EPL];
        if constexpr (Gm::WB == 8) {
          const uint2 w = *reinterpret_cast<const uint2*>(vst + t * RB + 8 * lw);
          int8x4(w.x, vf);
          int8x4(w.y, vf + 4);
        } else {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(vst + t * RB + 4 * lw);
          if constexpr (INT4) {
            int4x8(w, vf, vf + 4);
          } else {
            int8x4(w, vf);
          }
        }
        const float4 p4 = *reinterpret_cast<const float4*>(pt + t * GP + hg * GW);
        const float pg[GW] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int g = 0; g < GW; ++g) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            if constexpr (INT4) {
              acc[g][e] = fmaf(pg[g], vf[e], acc[g][e]);
            } else {
              pv[g][e] = fmaf(pg[g], vf[e], pv[g][e]);
            }
          }
        }
      }
      if constexpr (!INT4) {
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          const float a = a_s[hg * GW + g];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * a + pv[g][e] * sv[0];
        }
      }
    }
    i = nxt;
  }

  // Sum the warp's key groups, then the warps of a quad in order through
  // shared memory (over the stages: every copy has landed and been read).
#pragma unroll
  for (int o = LW; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GW; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
    }
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [NW][GW][D]
  if (lane < LW) {
#pragma unroll
    for (int g = 0; g < GW; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) red[(warp * GW + g) * D + pv_col<D, INT4>(lane, e)] = acc[g][e];
    }
  }
  __syncthreads();
  for (int e = tid; e < HC * D; e += NT) {
    const int g = e / D, d = e % D;
    float sum = 0.f;
    for (int k = 0; k < WPG; ++k) sum += red[(((g / GW) * WPG + k) * GW + g % GW) * D + d];
    if (p.splits == 1) {
      const float l = l_s[g];
      store_out(p, row0 * D + e, sum * (l == 0.f ? 1.f : 1.f / l));
    } else {
      p.part[((size_t(s) * p.B + b) * p.Hq + hq0) * D + e] = sum;
    }
  }
  for (int g = tid; g < HC; g += NT) {
    if (p.splits > 1) {
      p.ml[mslot + g] = m_s[g];
      p.ml[lplane + mslot + g] = l_s[g];
    } else if (p.lse != nullptr) {
      p.lse[row0 + g] = lse_of(m_s[g], l_s[g]);
    }
  }
}

// One block per (q head, sequence), a thread per column: the row's splits
// merged by lse in split order. A split with m = -inf held no visible page.
template <int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(const Params p) {
  const int d = threadIdx.x;
  const size_t plane = size_t(p.B) * p.Hq;
  const size_t row = size_t(blockIdx.y) * p.Hq + blockIdx.x;
  const float* m = p.ml + row;
  const float* l = m + size_t(p.splits) * plane;
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, m[s * plane]);
  float lsum = 0.f, acc = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float ms = m[s * plane];
    if (ms == -INFINITY) continue;  // an empty split: its partial is never written
    const float w = expf(ms - mx);
    lsum += w * l[s * plane];
    acc += w * p.part[(s * plane + row) * D + d];
  }
  store_out(p, row * D + d, acc * (lsum == 0.f ? 1.f : 1.f / lsum));
  if (d == 0 && p.lse != nullptr) p.lse[row] = lse_of(mx, lsum);
}

template <int D, bool INT4, bool CAP>
cudaError_t launch(Params p, cudaStream_t stream) {
  // A block holds up to MAXG query heads of a kv head's group; a large
  // group (MQA) is cut into chunks of 8 heads while the grid is short of
  // FILL blocks. A head's arithmetic is the same in any chunk.
  const int G = p.Hq / p.Hkv;
  p.heads = min((G + GW - 1) / GW * GW, MAXG);
  const long base = long(p.B) * p.Hkv * p.splits;
  while (p.heads % 8 == 0 && p.heads > 8 && base * ((G + p.heads - 1) / p.heads) < FILL) {
    p.heads /= 2;
  }
  const int chunks = (G + p.heads - 1) / p.heads;
  const size_t smem = Layout<D, INT4>(p.heads, p.page_size).total;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, INT4, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_decode_kernel<D, INT4, CAP>
      <<<dim3(p.Hkv * chunks, p.B, p.splits), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  decode_merge_kernel<D><<<dim3(p.Hq, p.B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool INT4>
cudaError_t launch_d(const Params& p, bool cap, cudaStream_t s) {
  return cap ? launch<D, INT4, true>(p, s) : launch<D, INT4, false>(p, s);
}

template <bool INT4>
int dispatch(const Params& p, int D, int has_softcap, void* stream) {
  if (p.page_size % 16 || p.subs < 1 || p.page_size % p.subs || p.Hkv < 1 || p.Hq % p.Hkv ||
      p.splits < 1 || p.pages_per_split < 1 ||
      (p.splits > 1 && (p.part == nullptr || p.ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.B == 0) return 0;
  const bool cap = has_softcap != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_d<32, INT4>(p, cap, s); break;
    case 64: err = launch_d<64, INT4>(p, cap, s); break;
    case 128: err = launch_d<128, INT4>(p, cap, s); break;
    case 256: err = launch_d<256, INT4>(p, cap, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales, const void* lengths,
                   const void* tables, void* o, void* lse, void* part, void* ml, int B, int Hq,
                   int Hkv, int num_pages, int page_size, int max_pages, int subs, int splits,
                   int pages_per_split, float sm_scale, float softcap, int window, int sinks,
                   float mask_value, int q_bf16) {
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
  p.part = static_cast<float*>(part);
  p.ml = static_cast<float*>(ml);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.num_pages = num_pages;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.subs = subs;
  p.splits = splits;
  p.pages_per_split = pages_per_split;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window = window;
  p.sinks = sinks;
  p.mask_value = mask_value;
  p.q_bf16 = q_bf16;
  return p;
}

}  // namespace

// part [splits, B, Hq, D] and ml [2, splits, B, Hq] f32 scratch (NULL when
// splits == 1); split s walks logical pages [s * pages_per_split, ...).
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scales, const void* v_scales, const void* lengths,
                            const void* tables, void* o, void* lse, void* part, void* ml, int B,
                            int Hq, int Hkv, int num_pages, int page_size, int max_pages, int D,
                            int splits, int pages_per_split, float sm_scale, int has_softcap,
                            float softcap, int window, int sinks, float mask_value, int q_bf16,
                            void* stream) {
  const Params p = make_params(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, o, lse,
                               part, ml, B, Hq, Hkv, num_pages, page_size, max_pages, 1, splits,
                               pages_per_split, sm_scale, softcap, window, sinks, mask_value,
                               q_bf16);
  return dispatch<false>(p, D, has_softcap, stream);
}

// INT4 pages [Hkv, num_pages, page_size, D/2], scales [Hkv, num_pages, subs].
extern "C" int paged_decode_int4(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scales, const void* v_scales,
                                 const void* lengths, const void* tables, void* o, void* lse,
                                 void* part, void* ml, int B, int Hq, int Hkv, int num_pages,
                                 int page_size, int max_pages, int D, int subs, int splits,
                                 int pages_per_split, float sm_scale, int has_softcap,
                                 float softcap, int window, int sinks, float mask_value,
                                 int q_bf16, void* stream) {
  const Params p = make_params(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, o, lse,
                               part, ml, B, Hq, Hkv, num_pages, page_size, max_pages, subs,
                               splits, pages_per_split, sm_scale, softcap, window, sinks,
                               mask_value, q_bf16);
  return dispatch<true>(p, D, has_softcap, stream);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
