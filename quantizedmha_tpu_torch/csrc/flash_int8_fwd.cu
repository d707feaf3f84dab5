// Fused INT8 attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * quantizedmha_tpu/ops/flash_attention_int8.py:80  _int8_fwd_kernel
//     (MODE_INT8_P: P rounded to int8, int8 x int8 P·V in int32, l sums
//     the f32 P')
//   * quantizedmha_tpu/ops/flash_attention_int8.py:437 _int8_fwd_kernel_t
//     (MODE_BF16_P: P' cast to bf16, bf16 x int8 P·V in f32, l sums the
//     bf16-rounded P' — the numerics of its default summode="mxu")
// The TPU kernel pair differ in orientation AND numerics; here the route
// chooses only the numerics mode, the layout is the same.
//
// Numerics contract (what the plain version in ops/flash_attention_int8.py
// computes, up to a few f32 ulps in P' and the f32 summation order):
//   Q quantized per row: scale = max(amax, clamp)/127, rint(q/scale) clipped
//   to ±127 (IEEE division, round half to even). S = Qq·Kqᵀ exactly in
//   int32, dequantized as s_i32 * (sq * (ks * sm_scale)); optional softcap;
//   masked scores = mask_value. The online softmax steps at EXACTLY the
//   quant block (block_kv): P' = exp(s - (m_next - ln p_scale)) depends on
//   the running max after each block, so a different step would round P
//   differently. Each quant block takes two sweeps over its kv tiles: a
//   max sweep, then an exp + P·V sweep that recomputes S (cheap int8 tensor
//   core products) instead of keeping a block_kv-wide score row on chip.
//   The max sweep runs on the int32 scores: the dequantization (a positive
//   factor) and the softcap are monotone, so max and dequantization commute.
//   Without softcap, P' is taken as exp2(s_i32 * f·log2e - shift·log2e),
//   one fused multiply-add and one MUFU.EX2 per score (a few ulps from the
//   plain version's exp(s - shift), which can flip the rounding of a P
//   that lies within those ulps of a rounding boundary).
//
// What bounds it on the H100: at the reference workload (N=8192, d=32,
// 32 heads) the exponentials, 32·8192² ≈ 2.1e9 of them, on 16 MUFU lanes
// per SM (≈0.5 ms), and the f32 arithmetic around each score (dequantize,
// round P, sum l) on the CUDA cores; the int8 and bf16 products are
// ~0.2 ms on the tensor cores. At the serving prefill shape (S=256, d=128)
// the kernel is tiny and launch/latency bound.
//
// What this design does about it: every product runs on the tensor cores
// through mma.sync (m16n8k32 s8 for S and the int8 P·V, m16n8k16 bf16 for
// the bf16 P·V: bf16 x int8 products are exact, so the f32-accumulated
// product is the TPU kernel's), leaving the CUDA cores only the per-score
// softmax work, cut to three instructions a score where no mask applies;
// in MODE_BF16_P the tensor cores also sum l, as P·1 (the TPU kernel's
// "mxu" sum). The mask and softcap choices are compile-time per tile, so
// no per-score branch is left for the compiler to if-convert. One thread
// block (16 q rows a warp) owns one (batch, q head, q tile) and loops over
// kv blocks; no cross-block carry. K/V tiles are double-buffered with
// cp.async, so the next tile's copy overlaps the current tile's math. The
// score fragments of S feed P·V straight from registers (for the int8
// product, V is stored with its kv index permuted to match), one 32-key
// chunk at a time. Tiles wholly above the causal diagonal or behind the
// window are skipped, per block and per warp (an exact skip: their scores
// are all masked). TMA, wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BKV = 64;   // kv positions per shared-memory tile
constexpr int MODE_INT8_P = 0;
constexpr int MODE_BF16_P = 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BF16_ONES = 0x3F803F80u;  // two bf16 1.0: the ones column that sums l

struct Params {
  const void* q;         // [B, H, Sq, D] f32 or bf16
  const int8_t* k;       // [B, Hkv, Skv, D]
  const int8_t* v;       // [B, Hkv, Skv, D]
  const float* ks;       // [B, Hkv, nkv]
  const float* vs;       // [B, Hkv, nkv]
  const int* offs;       // [B, 2] global (q_off, kv_off)
  void* o;               // [B, H, Sq, D], q's dtype
  float* lse;            // [B, H, Sq] or nullptr
  int B, H, Hkv, Sq, Skv, nkv, block_kv, kv_len;
  float sm_scale, scale_clamp, ln_p, softcap, mask_value, mask_half;
  int has_softcap, causal, window, sinks, mask_kv_tail;  // window < 0: none
};

// Tiles: a block of NT threads holds BQ q rows (16 a warp): 128 rows where
// the head is narrow, so that each K/V tile is copied and converted once
// for more rows; 64 at d=128, where registers are the limit and the serving
// prefill needs the blocks to fill the card.
// Shared memory: Q, its row scales, two K tiles, the V tile as copied and
// the V tile as the P·V product reads it: int8 and transposed (int8 P) or
// bf16 in its own layout, read through ldmatrix.trans (bf16 P). Row strides
// (bytes) are padded so that the fragment loads of a warp hit 32 distinct
// banks.
template <int D>
struct Smem {
  static constexpr int BQ = D <= 64 ? 128 : 64;   // q rows per block
  static constexpr int NT = 2 * BQ;               // threads per block
  static constexpr int QK_ROW = D + 16;           // int8 Q / K rows
  static constexpr int V8_ROW = BKV + 16;         // int8 Vᵀ rows (kv permuted)
  static constexpr int V16_ROW = 2 * D + 16;      // bf16 V rows
  static constexpr int Q_BYTES = BQ * QK_ROW;
  static constexpr int SQ_BYTES = BQ * 4;
  static constexpr int K_BYTES = BKV * QK_ROW;
  static constexpr int VS_BYTES = BKV * D;
  static constexpr int VT_BYTES = D * V8_ROW > BKV * V16_ROW ? D * V8_ROW : BKV * V16_ROW;
  static constexpr int K_OFF = Q_BYTES + SQ_BYTES;
  static constexpr int VS_OFF = K_OFF + 2 * K_BYTES;
  static constexpr int VT_OFF = VS_OFF + VS_BYTES;
  static constexpr int TOTAL = VT_OFF + VT_BYTES;
  static constexpr int CPR = D / 16;              // 16-byte chunks per K/V row
  static constexpr int CPT = (BKV * CPR + NT - 1) / NT;  // chunks of a tile a thread copies
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two m16n8k16
// n-tiles from a row-major [k][n] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// True when no (q, kv) pair of the ranges is masked: the unmasked fast path.
__device__ __forceinline__ bool range_unmasked(const Params& p, int first_q, int last_q,
                                               int first_kv, int last_kv, int last_kv_loc) {
  if (p.mask_kv_tail && last_kv_loc >= p.kv_len) return false;
  if (!p.causal) return true;
  bool ok = last_kv <= first_q;
  if (p.window >= 0) ok &= (last_q - first_kv) < p.window;
  return ok;
}

__device__ __forceinline__ bool pair_valid(const Params& p, int qpos, int kpos, int kloc) {
  bool valid = true;
  if (p.causal) {
    valid = kpos <= qpos;
    if (p.window >= 0) {
      bool in_win = (qpos - kpos) < p.window;
      if (p.sinks) in_win |= kpos < p.sinks;
      valid &= in_win;
    }
  }
  if (p.mask_kv_tail) valid &= kloc < p.kv_len;
  return valid;
}

__device__ __forceinline__ float dequant(const Params& p, int si, float f) {
  // __fmul_rn: rounded as the plain version rounds the dequantized score.
  float x = __fmul_rn(static_cast<float>(si), f);
  if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ int quad_imax(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Logical k index, within a 32-wide chunk, of physical kv offset p. The
// int8 P·V takes P straight from the S accumulators, whose lane t holds kv
// columns 2t, 2t+1 of each 8-wide tile; the m16n8k32 A operand wants k
// columns 4t..4t+3 of each 16-wide half. Storing Vᵀ in this order makes the
// two agree (the product's sum over k does not care about the order).
__device__ __forceinline__ int kv_logical(int p) {
  return (p & 16) | (((p >> 1) & 3) << 2) | (((p >> 3) & 1) << 1) | (p & 1);
}

template <int D, int MODE, bool QBF16>
__global__ void __launch_bounds__(Smem<D>::NT)
flash_int8_fwd_kernel(const Params p) {
  using S = Smem<D>;
  constexpr int BQ = S::BQ, NT = S::NT;
  constexpr int KC = D / 32;  // k32 chunks of the S product
  constexpr int NO = D / 8;   // n8 tiles of the output

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem);                      // [BQ][QK_ROW]
  float* sqs = reinterpret_cast<float*>(smem + S::Q_BYTES);          // [BQ]
  int8_t* kbuf = reinterpret_cast<int8_t*>(smem + S::K_OFF);         // 2 x [BKV][QK_ROW]
  int8_t* vstage = reinterpret_cast<int8_t*>(smem + S::VS_OFF);      // [BKV][D] as copied
  unsigned char* vt = smem + S::VT_OFF;  // int8 P: [D][V8_ROW]; bf16 P: [BKV][V16_ROW]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];

  // ---- Q: per-row symmetric int8 quantization; each warp its 16 rows.
  {
    const size_t qbase = (size_t(b) * p.H + h) * p.Sq * D;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int row = q0 + r;
      float x[D / 32];
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const int d = lane + 32 * j;
        float val = 0.f;
        if (row < p.Sq) {
          if (QBF16) {
            val = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.q)[qbase + size_t(row) * D + d]);
          } else {
            val = reinterpret_cast<const float*>(p.q)[qbase + size_t(row) * D + d];
          }
        }
        x[j] = val;
        amax = fmaxf(amax, fabsf(val));
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = fmaxf(amax, p.scale_clamp) / 127.0f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        float qv = rintf(x[j] / scale);
        qv = fminf(fmaxf(qv, -127.f), 127.f);
        qs[r * S::QK_ROW + lane + 32 * j] = static_cast<int8_t>(qv);
      }
      if (lane == 0) sqs[r] = scale;
    }
  }
  __syncwarp();
  // This thread's A fragments of Q (rows g and g+8 of the warp) and their scales.
  uint32_t qf[KC][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs);
    constexpr int RW = S::QK_ROW / 4;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = q32[r0 * RW + kc * 8 + t];
      qf[kc][1] = q32[(r0 + 8) * RW + kc * 8 + t];
      qf[kc][2] = q32[r0 * RW + kc * 8 + 4 + t];
      qf[kc][3] = q32[(r0 + 8) * RW + kc * 8 + 4 + t];
    }
  }
  const float sq_r[2] = {sqs[warp * 16 + g], sqs[warp * 16 + g + 8]};
  const int qpos_r[2] = {q_off + q0 + warp * 16 + g, q_off + q0 + warp * 16 + g + 8};

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last_row = min(q0 + BQ, p.Sq) - 1;
  const int first_q = q_off + q0, last_q = q_off + q_last_row;
  const int wq_first = q_off + q0 + warp * 16, wq_last = wq_first + 15;
  const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
  const int8_t* kg = p.k + kvbase;
  const int8_t* vg = p.v + kvbase;

  // Start the copies of the tile at t0 (rows past kend zero-filled) into
  // K buffer `buf` and, with V, into the V staging tile.
  auto issue = [&](int t0, int kend, bool with_v, int buf) {
#pragma unroll
    for (int i = 0; i < S::CPT; ++i) {
      const int e = tid + i * NT;
      if (e >= BKV * S::CPR) break;
      const int r = e / S::CPR, c = e % S::CPR;
      const bool ok = t0 + r < kend;
      const size_t src = size_t(ok ? t0 + r : 0) * D + 16 * c;
      cp_async16(kbuf + buf * S::K_BYTES + r * S::QK_ROW + 16 * c, kg + src, ok);
      if (with_v) cp_async16(vstage + r * D + 16 * c, vg + src, ok);
    }
    cp_async_commit();
  };
  // The P·V operand from the staged V; each thread converts the chunks it
  // copied.
  auto convert_v = [&]() {
#pragma unroll
    for (int i = 0; i < S::CPT; ++i) {
      const int e = tid + i * NT;
      if (e >= BKV * S::CPR) break;
      const int r = e / S::CPR, c = e % S::CPR;
      const int4 val = *reinterpret_cast<const int4*>(vstage + r * D + 16 * c);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&val);
      if (MODE == MODE_INT8_P) {
        const int col = (r & ~31) | kv_logical(r & 31);
#pragma unroll
        for (int k = 0; k < 16; ++k) vt[(16 * c + k) * S::V8_ROW + col] = bytes[k];
      } else {
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(static_cast<float>(bytes[2 * k]),
                                                            static_cast<float>(bytes[2 * k + 1]));
          w[k] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        uint4* dst = reinterpret_cast<uint4*>(vt + r * S::V16_ROW + 32 * c);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
  };
  auto next_run = [&](int t0, int kb1) {
    while (t0 < kb1 &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BKV, kb1) - 1))
      t0 += BKV;
    return t0;
  };
  // body(t0, tend, K tile) over the tiles of [kb0, kb1) that should run,
  // the next tile's copies in flight while the body computes.
  auto sweep = [&](int kb0, int kb1, bool with_v, auto&& body) {
    int t0 = next_run(kb0, kb1);
    int buf = 0;
    __syncthreads();  // every warp is done with the previous sweep's buffers
    if (t0 < kb1) issue(t0, kb1, with_v, buf);
    while (t0 < kb1) {
      __syncthreads();  // every warp is done with the previous tile
      cp_async_wait_all();
      if (with_v) convert_v();
      __syncthreads();  // this tile is in shared memory for all
      const int tn = next_run(t0 + BKV, kb1);
      if (tn < kb1) issue(tn, kb1, with_v, buf ^ 1);
      body(t0, min(t0 + BKV, kb1), kbuf + buf * S::K_BYTES);
      buf ^= 1;
      t0 = tn;
    }
  };
  // Integer scores of this warp's 16 rows x the 32 keys of chunk c of the
  // tile: s[jj][e] is row g + 8*(e>>1), key 32c + 8jj + 2t + (e&1).
  auto chunk_scores = [&](const int8_t* kt, int c, int (&s)[4][4]) {
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(kt);
    constexpr int RW = S::QK_ROW / 4;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = 0;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t* kr = k32 + (32 * c + 8 * jj + g) * RW + kc * 8 + t;
        mma_s8(s[jj], qf[kc], kr[0], kr[4]);
      }
    }
  };

  for (int qb = 0; qb < p.nkv; ++qb) {
    const int kb0 = qb * p.block_kv;
    const int kb1 = min(kb0 + p.block_kv, p.Skv);
    if (!range_should_run(p, first_q, last_q, kv_off + kb0, kv_off + kb1 - 1)) continue;
    const size_t sidx = (size_t(b) * p.Hkv + kvh) * p.nkv + qb;
    const float kss = p.ks[sidx] * p.sm_scale;
    const float vsc = p.vs[sidx];
    const float f_r[2] = {sq_r[0] * kss, sq_r[1] * kss};

    // Sweep 1: the row max over the whole quant block, on the int32 scores.
    int imax[2] = {INT_MIN, INT_MIN};
    bool any_masked[2] = {false, false};
    auto max_tile = [&](auto unmasked_tag, int t0, int tend, const int8_t* kt) {
      constexpr bool UNMASKED = decltype(unmasked_tag)::value;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int s[4][4];
        chunk_scores(kt, c, s);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kloc = t0 + 32 * c + 8 * jj + 2 * t + (e & 1);
            if (UNMASKED) {
              imax[r] = max(imax[r], s[jj][e]);
            } else if (kloc < tend) {  // (keys past the quant block are absent)
              if (pair_valid(p, qpos_r[r], kv_off + kloc, kloc)) {
                imax[r] = max(imax[r], s[jj][e]);
              } else {
                any_masked[r] = true;
              }
            }
          }
      }
    };
    sweep(kb0, kb1, false, [&](int t0, int tend, const int8_t* kt) {
      if (!range_should_run(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1)) {
        any_masked[0] = any_masked[1] = true;  // every present score of the warp is masked
        return;
      }
      if (tend - t0 == BKV &&
          range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1)) {
        max_tile(std::true_type{}, t0, tend, kt);
      } else {
        max_tile(std::false_type{}, t0, tend, kt);
      }
    });
    float m_next[2], alpha[2], shift[2], f2[2], shift2[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int im = quad_imax(imax[r]);
      const bool am = quad_max(any_masked[r] ? 1.f : 0.f) > 0.f;
      const float mc = im != INT_MIN ? dequant(p, im, f_r[r]) : (am ? p.mask_value : -INFINITY);
      m_next[r] = fmaxf(m[r], mc);
      // (m_next stays -inf only if every tile of the block was skipped.)
      alpha[r] = m_next[r] == -INFINITY ? 1.f : expf(m[r] - m_next[r]);
      shift[r] = m_next[r] - p.ln_p;
      f2[r] = f_r[r] * LOG2E;
      shift2[r] = shift[r] * LOG2E;
      // Rows masked across the whole block get p = 0 (not p_scale each).
      live[r] = m_next[r] > p.mask_half;
    }

    // Sweep 2: P' = exp(s - (m_next - ln p_scale)), its sum, and P·V.
    int pvi[NO][4];
    float pvf[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pvi[n][e] = 0;
        pvf[n][e] = 0.f;
      }
    float lsum[2] = {0.f, 0.f};
    float lmma[4] = {0.f, 0.f, 0.f, 0.f};  // MODE_BF16_P: l = P·1 on the tensor cores
    auto pv_tile = [&](auto unmasked_tag, auto softcap_tag, int t0, int tend, const int8_t* kt) {
      constexpr bool UNMASKED = decltype(unmasked_tag)::value;
      constexpr bool SOFTCAP = decltype(softcap_tag)::value;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int s[4][4];
        chunk_scores(kt, c, s);
        float pe[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kloc = t0 + 32 * c + 8 * jj + 2 * t + (e & 1);
            bool keep = live[r];
            if (!UNMASKED) keep &= kloc < tend && pair_valid(p, qpos_r[r], kv_off + kloc, kloc);
            const float x = SOFTCAP
                                ? expf(dequant(p, s[jj][e], f_r[r]) - shift[r])
                                : exp2f(fmaf(static_cast<float>(s[jj][e]), f2[r], -shift2[r]));
            pe[jj][e] = keep ? x : 0.f;
          }
        if (MODE == MODE_INT8_P) {
          constexpr int RW = S::V8_ROW / 4;
          uint32_t a[4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)     // k half: tiles 2hh, 2hh+1 of the chunk
#pragma unroll
            for (int r = 0; r < 2; ++r) {    // row g / g+8
              const float v0 = pe[2 * hh][2 * r], v1 = pe[2 * hh][2 * r + 1];
              const float v2 = pe[2 * hh + 1][2 * r], v3 = pe[2 * hh + 1][2 * r + 1];
              lsum[r] += (v0 + v1) + (v2 + v3);
              a[2 * hh + r] = uint32_t(__float2int_rn(v0)) | (uint32_t(__float2int_rn(v1)) << 8) |
                              (uint32_t(__float2int_rn(v2)) << 16) |
                              (uint32_t(__float2int_rn(v3)) << 24);
            }
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const uint32_t* vr = reinterpret_cast<const uint32_t*>(vt) + (8 * n + g) * RW + c * 8 + t;
            mma_s8(pvi[n], a, vr[0], vr[4]);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {   // k16 step 2c+kk: tiles 2kk, 2kk+1 of the chunk
            uint32_t a[4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float v0 = pe[2 * kk + hh][2 * r], v1 = pe[2 * kk + hh][2 * r + 1];
                const __nv_bfloat162 pb = __floats2bfloat162_rn(v0, v1);
                a[2 * hh + r] = *reinterpret_cast<const uint32_t*>(&pb);
              }
            mma_bf16(lmma, a, BF16_ONES, BF16_ONES);
            // rows 32c + 16kk + (lane & 15) of V, n-tiles n and n+1
            const unsigned char* vrow = vt + (32 * c + 16 * kk + (lane & 15)) * S::V16_ROW;
#pragma unroll
            for (int n = 0; n < NO; n += 2) {
              uint32_t bfr[4];
              ldsm_x4_trans(bfr, vrow + (n + (lane >> 4)) * 16);
              mma_bf16(pvf[n], a, bfr[0], bfr[1]);
              mma_bf16(pvf[n + 1], a, bfr[2], bfr[3]);
            }
          }
        }
      }
    };
    // The mask and softcap choices are made once a tile, not once a score.
    auto pv_tile_sc = [&](auto softcap_tag, int t0, int tend, const int8_t* kt) {
      if (!range_should_run(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1)) return;
      if (tend - t0 == BKV &&
          range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1)) {
        pv_tile(std::true_type{}, softcap_tag, t0, tend, kt);
      } else {
        pv_tile(std::false_type{}, softcap_tag, t0, tend, kt);
      }
    };
    if (p.has_softcap) {
      sweep(kb0, kb1, true, [&](int t0, int tend, const int8_t* kt) {
        pv_tile_sc(std::true_type{}, t0, tend, kt);
      });
    } else {
      sweep(kb0, kb1, true, [&](int t0, int tend, const int8_t* kt) {
        pv_tile_sc(std::false_type{}, t0, tend, kt);
      });
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // (every column of the ones product holds the row's whole sum)
      l[r] = alpha[r] * l[r] + (MODE == MODE_BF16_P ? lmma[2 * r] : quad_sum(lsum[r]));
      m[r] = m_next[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = MODE == MODE_INT8_P ? static_cast<float>(pvi[n][e]) : pvf[n][e];
        acc[n][e] = acc[n][e] * alpha[e >> 1] + pv * vsc;
      }
  }

  // ---- Epilogue: o = acc / l (l == 0 -> o = 0); lse = m + log l - ln p.
  const size_t obase = (size_t(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.Sq) continue;
    const float l_inv = l[r] == 0.f ? 1.f : 1.f / l[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float o0 = acc[n][2 * r] * l_inv, o1 = acc[n][2 * r + 1] * l_inv;
      const size_t idx = (obase + row) * D + 8 * n + 2 * t;
      if (QBF16) {
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(p.o) + idx) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.o) + idx) = make_float2(o0, o1);
      }
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[obase + row] = l[r] > 0.f ? m[r] + logf(l[r]) - p.ln_p : -INFINITY;
    }
  }
}

template <int D, int MODE, bool QBF16>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Smem<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_fwd_kernel<D, MODE, QBF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + Smem<D>::BQ - 1) / Smem<D>::BQ, p.H, p.B);
  flash_int8_fwd_kernel<D, MODE, QBF16><<<grid, Smem<D>::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mode(const Params& p, int mode, int q_bf16, cudaStream_t stream) {
  if (mode == MODE_INT8_P) {
    return q_bf16 ? launch<D, MODE_INT8_P, true>(p, stream) : launch<D, MODE_INT8_P, false>(p, stream);
  }
  return q_bf16 ? launch<D, MODE_BF16_P, true>(p, stream) : launch<D, MODE_BF16_P, false>(p, stream);
}

}  // namespace

extern "C" int flash_int8_fwd(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* offs, void* o, void* lse, int B,
                              int H, int Hkv, int Sq, int Skv, int nkv, int D, int kv_len,
                              float sm_scale, float scale_clamp, float ln_p, int has_softcap,
                              float softcap, int causal, int window, int sinks,
                              int mask_kv_tail, float mask_value, float mask_half, int mode,
                              int q_bf16, void* stream) {
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.offs = static_cast<const int*>(offs);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.nkv = nkv;
  p.block_kv = Skv / nkv;
  p.kv_len = kv_len;
  p.sm_scale = sm_scale;
  p.scale_clamp = scale_clamp;
  p.ln_p = ln_p;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  p.mask_kv_tail = mask_kv_tail;
  p.mask_value = mask_value;
  p.mask_half = mask_half;
  if (mode < MODE_INT8_P || mode > MODE_BF16_P) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_mode<32>(p, mode, q_bf16, s); break;
    case 64: err = dispatch_mode<64>(p, mode, q_bf16, s); break;
    case 128: err = dispatch_mode<128>(p, mode, q_bf16, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
