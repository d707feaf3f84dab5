// Fused INT8 attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * quantizedmha_tpu/ops/flash_attention_int8.py:80  _int8_fwd_kernel
//     (MODE_INT8_P: P rounded to int8, int8 x int8 P·V in int32, l sums
//     the f32 P'), kernel flash_int8_int8p_kernel
//   * quantizedmha_tpu/ops/flash_attention_int8.py:437 _int8_fwd_kernel_t
//     (MODE_BF16_P: P' cast to bf16, bf16 x int8 P·V in f32, l sums the
//     bf16-rounded P' — the numerics of its default summode="mxu"), kernel
//     flash_int8_bf16p_kernel
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
// What bounds it on the H100: at the reference workload (solve's fa_int8,
// MODE_BF16_P: N=8192, d=32, 32 heads, not causal) the exponentials,
// 32·8192² ≈ 2.1e9 of them, on 16 SFU lanes per SM (≈0.51 ms), and the f32
// work around each score (its conversion, the FFMA, P's bf16 packing) on
// the CUDA cores; both sweeps' int8 products and the bf16 P·V are ~0.2 ms
// on the tensor cores. At the serving prefills (MODE_INT8_P, d=128,
// causal, GQA 4: w8a16's 256-token prompts, block_kv 256, and w4a16's
// 512-token ones, block_kv 512) the bound is 1.4 / 2.8 µs of bytes and the
// kernel is latency bound (harness/flash_int8_fwd_variants.json's int8p_
// knock-outs, PERF.md): at 256 tokens the launch, Q's loads and divisions
// before the first item and the epilogue take half the time, the heaviest
// block's chain of items (two a visible 64-key tile, ~1 µs each, mostly
// handoffs) the other half.
//
// MODE_BF16_P (flash_int8_bf16p_kernel): a block is (batch, q head, 128 q
// rows) and its warpgroups specialise (setmaxnreg). One producer warpgroup
// walks the block's items without a break at a sweep or a quant block: for
// each quant block, its key tiles for the max sweep, then the same tiles
// for the exp sweep, each into the next stage of a ring (4 at d <= 64, 3
// at d=128) by cp.async, handed over and back through named barriers; an
// exp-sweep item's V rows are converted exactly to bf16 by the producer,
// beside a block of bf16 ones. Two consumer warpgroups (64 rows each) run
// S = Qq·Kqᵀ as s8 wgmma (wgmma_s8.cuh) on every item, Q quantized to int8
// in shared memory: the max sweep takes the int32 row max (VIMNMX3, off the
// exponentials' pipe), the exp sweep P' = exp2(fma(s, f·log2e,
// −shift·log2e)) on the SFU, P' packed to bf16 as the register A of a
// wgmma against [V | 1] (N = D + 8), whose last eight columns sum l on the
// tensor cores; that P·V stays in flight while the next item's S is
// issued and waited for. The quant block's pv is folded in at its end,
// acc = acc·α + pv·vsc. Mask and softcap choices are compile-time per tile
// and per warp; tiles that no row of the block sees are never copied. d=32
// runs two blocks an SM. No atomics: the same bits every launch. What
// bounds it at solve's shape (harness/flash_int8_fwd_variants.json's
// knock-outs, PERF.md): each item's chain of handoff, wgmma and wait, not
// the SFU; the max sweep's items alone cost a quarter of the time.
//
// MODE_INT8_P (flash_int8_int8p_kernel): the same walk and ring, with the
// products in s8 on wgmma. A block is (batch, kv head, GB q heads, a q
// tile): one consumer of 64 rows, GB = 1 (one q head a block; the GQA
// group folded into the rows measured no faster), the heaviest q tiles
// first, two blocks an SM (setmaxnreg 40 / 216), so that the serving
// prefill's few blocks spread over every SM. The producer copies each
// item's K rows and, for an exp-sweep item, its V rows by cp.async, and
// turns the V rows into Vᵀ (int8, keys contiguous: the K-major B that
// 8-bit wgmma needs, having no transpose) by 4 x 4 byte transposes in
// registers, the keys permuted so that k column 4t..4t+3 of Vᵀ holds the
// keys whose scores lane t's S accumulator holds. The consumer quantizes
// its Q rows (eight lanes a row, 16-byte loads), then runs S = Qq·Kqᵀ on
// s8 wgmma for every item: the int32 row max over the max sweep; over the
// exp sweep P' = exp2(fma(s, f·log2e, −shift·log2e)) on the SFU (expf of
// the softcapped score with softcap), l over the f32 P' (per thread, quad
// sums at the block's end), P = rint(P') in [0, 127] packed four a
// register as the s8 register A of a wgmma against Vᵀ (N = D), pvi exact
// in int32 over the quant block; that P·V stays in flight while the next
// item's S is issued and waited for; at the block's end acc = acc·α +
// pvi·vsc and l = α·l + Σ. The epilogue stages each warp's rows of o
// through its rows of the spent Q tile and writes whole rows. A row's
// walk is never split across blocks: P' depends on the running max over
// every quant block so far, which sets which P rounds up. No atomics: the
// same bits every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
#include "wgmma_s8.cuh"

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
  int G, GB, NQ, HC;  // int8-P blocks: group, its heads a block, q positions a block, head chunks
};

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

// ---------------------------------------------------------------------------
// MODE_BF16_P: wgmma, a producer warpgroup and two consumer warpgroups.

template <int D>
struct Bf16pRing {
  // Consumer warpgroups (64 q rows each) and blocks an SM: at d=32, bound
  // by the exponentials, two blocks share an SM and fill each other's
  // waits; above, one block whose consumers hold the wider accumulators.
  static constexpr int CONSUMERS = 2;
  static constexpr int ROWS = 64 * CONSUMERS;        // q rows of a block
  static constexpr int BLOCKS = D == 32 ? 2 : 1;
  static constexpr int NTB = 128 * (1 + CONSUMERS);  // threads; all meet at a handoff
  static constexpr int STAGES = D == 128 ? 3 : 4;    // stages in the ring
  // Items in flight beyond the one handed over. The producer hands item n
  // over before it waits for stage n + LAG to be free, and a consumer holds
  // at most one stage (an exp-sweep item's, whose P·V is in flight) while
  // it waits for the next item: so item n is handed over once item n - 2
  // is handed back, one item ahead of the consumer.
  static constexpr int LAG = STAGES - 1;
  // The registers of a producer and of a consumer thread (setmaxnreg; the
  // launch gives each thread 65536 / (NTB * BLOCKS), rounded down to 8).
  static constexpr int PRODUCER_REGS = D == 32 ? 32 : 40, CONSUMER_REGS = D == 32 ? 104 : 232;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                (1 + CONSUMERS) * (65536 / (NTB * BLOCKS) / 8 * 8), "register budget");
  // Named barriers (0 is __syncthreads): stage s holds an item for consumer
  // c (FULL + CONSUMERS·s + c), stage s is free again (EMPTY + s).
  static constexpr int FULL = 1, EMPTY = FULL + CONSUMERS * STAGES;
  static constexpr int FULL_THREADS = 256;  // the producer and one consumer
  static_assert(EMPTY + STAGES <= 16, "16 named barriers");
  // A stage: the K tile (int8, wgmma_s8.cuh's layout), then the bf16
  // [V | 1] tile (mma_bf16.cuh's layout, D + 8 columns in 64-column
  // blocks). Shared memory: each consumer's Q tile, the stages, each
  // stage's raw int8 V rows as copied, the q rows' scales, acc, m and l
  // (touched once a quant block, so they leave the registers to the
  // sweeps); 1 KB to align.
  static constexpr int VBLOCKS = (D + 8 + 63) / 64;
  static constexpr int STAGE = S8_TILE + VBLOCKS * SW_ROWS * 64 * 2;
  static constexpr int RAW = 64 * D;
  static constexpr int CPT = D / 32;  // 16-byte chunks of a K or V tile a producer thread copies
  static constexpr int KV_OFF = CONSUMERS * S8_TILE;
  static constexpr int RAW_OFF = KV_OFF + STAGES * STAGE;
  static constexpr int SQ_OFF = RAW_OFF + STAGES * RAW;
  static constexpr int ACC_OFF = SQ_OFF + ROWS * 4;
  static constexpr int ML_OFF = ACC_OFF + 128 * CONSUMERS * D / 8 * 16;
  static constexpr int BYTES = ML_OFF + 128 * CONSUMERS * 16 + 1024;
};

// The f32 of an s32 score, exact (|s| <= 128·127² < 2^24): one I2F, which
// the A/B call timed ahead of the magic-number form (an integer add to the
// bits of 1.5·2^23, then less 1.5·2^23: two instructions).
__device__ __forceinline__ float s32_to_f32(int s) { return static_cast<float>(s); }

// Four int8 (one 32-bit word) as four bf16 (two pairs, byte 0 in the low
// half), exactly (|x| <= 128 is a bf16): each byte, biased to unsigned u,
// is the low byte of the f32 2^23 + u; less 2^23 + 128 that is x in f32,
// whose high half is its bf16.
__device__ __forceinline__ uint2 v_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// One block per (batch, q head, q tile of ROWS rows), the heaviest q tiles
// first. The walk is the same for every warpgroup: for each quant block,
// the tiles of it (64 keys from its start, the last clipped at its end)
// that some row of the block sees, once for the max sweep and once for the
// exp sweep; each such item takes the next stage of the ring. Warpgroup 0,
// the producer, copies each item's K rows into its stage and, for the exp
// sweep, its V rows, which it converts to bf16 beside the stage's column
// block of ones. The consumers (consumer c holds block rows 64c..64c+63;
// warp w of each owns 16 of them) run S = Qq·Kqᵀ on wgmma for every item,
// the integer row max over the max sweep, then P' and pv += P'·[V | 1] over
// the exp sweep, and fold each quant block into acc and l at its end.
template <int D, bool QBF16>
__global__ void __launch_bounds__(Bf16pRing<D>::NTB, Bf16pRing<D>::BLOCKS)
    flash_int8_bf16p_kernel(const Params p) {
  using R = Bf16pRing<D>;
  constexpr int ND = D / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  auto k_tile = [&](int s) { return reinterpret_cast<int8_t*>(smem + R::KV_OFF + s * R::STAGE); };
  auto v_tile = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + R::KV_OFF + s * R::STAGE + S8_TILE);
  };

  const int tid = threadIdx.x, wg = tid >> 7, gtid = tid & 127;
  // Heaviest first: the last q tile sees the most keys under a causal
  // mask, so the q tile is the grid's slow index, counted from the end.
  const int heads = p.H * p.B;
  const int ntiles = (p.Sq + R::ROWS - 1) / R::ROWS;
  const int q0 = (ntiles - 1 - int(blockIdx.x / heads)) * R::ROWS;
  const int h = blockIdx.x % p.H, b = (blockIdx.x % heads) / p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];
  const int first_q = q_off + q0, last_q = q_off + min(q0 + R::ROWS, p.Sq) - 1;
  // The walk within the quant block that ends at kb1: its next tile from
  // t0 on that a row of the block sees.
  auto next_run = [&](int t0, int kb1) {
    while (t0 < kb1 &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BKV, kb1) - 1))
      t0 += BKV;
    return t0;
  };

  // ---- Q: per-row symmetric int8 quantization (as MODE_INT8_P's) into the
  // consumers' s8 tiles (block row r in consumer r / 64's), by every warp
  // of the block in turn before the warpgroups specialise (with the
  // launch's registers and nothing else live, the division's slow path
  // spills nothing).
  {
    const int lane = tid & 31;
    const size_t qbase = (size_t(b) * p.H + h) * p.Sq * D;
    for (int r = tid >> 5; r < R::ROWS; r += R::NTB / 32) {
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
      int8_t* qrow = reinterpret_cast<int8_t*>(smem) + (r / 64) * S8_TILE;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        float qv = rintf(x[j] / scale);
        qv = fminf(fmaxf(qv, -127.f), 127.f);
        qrow[sw8(r % 64, 2 * j + (lane >> 4)) + (lane & 15)] = static_cast<int8_t>(qv);
      }
      if (lane == 0) reinterpret_cast<float*>(smem + R::SQ_OFF)[r] = scale;
    }
    fence_async_shared();
    __syncthreads();
  }

  if (wg == 0) {
    // Producer: item n into stage n % STAGES once the consumers handed that
    // stage back; handed over LAG items later, when its copies have landed
    // (and its V is converted).
    setmaxnreg_dec<R::PRODUCER_REGS>();
    const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
    const int8_t* kg = p.k + kvbase;
    const int8_t* vg = p.v + kvbase;
    int8_t* raw = reinterpret_cast<int8_t*>(smem + R::RAW_OFF);
    // The ones block of every stage's [V | 1] tile (n8 tile D / 8), once.
    for (int e = gtid; e < R::STAGES * 64; e += 128)
      *reinterpret_cast<uint4*>(v_tile(e / 64) + sw(e % 64, D / 8)) =
          make_uint4(BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES);
    // Each thread copies, and converts, the same chunks of every tile: its
    // own cp.async wait is all the conversion needs.
    auto issue = [&](int t0, int kend, bool with_v, int s) {
#pragma unroll
      for (int i = 0; i < R::CPT; ++i) {
        const int e = gtid + 128 * i, r = e / (D / 16), c = e % (D / 16);
        const bool ok = t0 + r < kend;  // zero past the quant block's end
        const size_t src = size_t(ok ? t0 + r : 0) * D + 16 * c;
        cp_async16(k_tile(s) + sw8(r, c), kg + src, ok);
        if (with_v) cp_async16(raw + s * R::RAW + 16 * e, vg + src, ok);
      }
      cp_async_commit();
    };
    auto hand_over = [&](int s, bool with_v) {
      if (with_v) {
#pragma unroll
        for (int i = 0; i < R::CPT; ++i) {
          const int e = gtid + 128 * i, r = e / (D / 16), c = e % (D / 16);
          const uint4 w = *reinterpret_cast<const uint4*>(raw + s * R::RAW + 16 * e);
          const uint2 x0 = v_to_bf16(w.x), x1 = v_to_bf16(w.y);
          const uint2 x2 = v_to_bf16(w.z), x3 = v_to_bf16(w.w);
          *reinterpret_cast<uint4*>(v_tile(s) + sw(r, 2 * c)) = make_uint4(x0.x, x0.y, x1.x, x1.y);
          *reinterpret_cast<uint4*>(v_tile(s) + sw(r, 2 * c + 1)) =
              make_uint4(x2.x, x2.y, x3.x, x3.y);
        }
      }
      fence_async_shared();
#pragma unroll
      for (int c = 0; c < R::CONSUMERS; ++c)
        bar_arrive(R::FULL + R::CONSUMERS * s + c, R::FULL_THREADS);
    };
    uint32_t v_items = 0;  // bit s: stage s holds an item of the exp sweep
    int n = 0;
    for (int kb0 = 0; kb0 < p.Skv; kb0 += p.block_kv) {
      const int kb1 = kb0 + p.block_kv;
      const int t_first = next_run(kb0, kb1);
      for (int sweep = 0; sweep < 2; ++sweep) {
        for (int t0 = t_first; t0 < kb1; t0 = next_run(t0 + BKV, kb1), ++n) {
          const int s = n % R::STAGES;
          if (n >= R::LAG) {
            cp_async_wait<R::LAG - 1>();
            const int j = (n - R::LAG) % R::STAGES;
            hand_over(j, (v_items >> j) & 1u);  // item n - LAG landed
          }
          if (n >= R::STAGES) bar_sync(R::EMPTY + s, R::NTB);  // the consumers are done with s
          issue(t0, kb1, sweep == 1, s);
          v_items = (v_items & ~(1u << s)) | (uint32_t(sweep) << s);
        }
      }
    }
    cp_async_wait_all();
    for (int j = max(n - R::LAG, 0); j < n; ++j) {
      const int s = j % R::STAGES;
      hand_over(s, (v_items >> s) & 1u);
    }
    // The consumers hand back every stage: wait for the last ones.
    for (int j = max(n - R::STAGES, 0); j < n; ++j) bar_sync(R::EMPTY + j % R::STAGES, R::NTB);
    return;
  }

  // Consumers.
  setmaxnreg_inc<R::CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int8_t* qs = reinterpret_cast<int8_t*>(smem) + cw * S8_TILE;
  float* sqs = reinterpret_cast<float*>(smem + R::SQ_OFF) + 64 * cw;
  const int rbase = q0 + 64 * cw + 16 * warp;  // this warp's first q row
  const int qpos_r[2] = {q_off + rbase + g, q_off + rbase + g + 8};
  const int wq_first = q_off + rbase, wq_last = wq_first + 15;

  // This thread's acc (the C fragment of pv's first ND n8 tiles; n8 tile c
  // at acc4[c * CONSUMERS·128], threads side by side), and m and l of its
  // rows g and g + 8 (m0, m1, l0, l1).
  float4* acc4 = reinterpret_cast<float4*>(smem + R::ACC_OFF) + 128 * cw + gtid;
  float4* ml = reinterpret_cast<float4*>(smem + R::ML_OFF) + 128 * cw + gtid;
#pragma unroll
  for (int c = 0; c < ND; ++c) acc4[c * R::CONSUMERS * 128] = make_float4(0.f, 0.f, 0.f, 0.f);
  *ml = make_float4(-INFINITY, -INFINITY, 0.f, 0.f);
  float pv[ND + 1][4];  // P'·[V | 1] over the quant block's exp sweep
  uint32_t a[4][4];     // P' in bf16: register A of k16 step kk (keys 16kk..16kk+15)

  // Item n of the walk sits in stage n % STAGES.
  auto full = [&](int n) {
    bar_sync(R::FULL + R::CONSUMERS * (n % R::STAGES) + cw, R::FULL_THREADS);
  };
  auto release = [&](int n) { bar_arrive(R::EMPTY + n % R::STAGES, R::NTB); };
  // S = Qq·Kqᵀ of item n, issued and waited for: sc[j][e] is row g + 8(e >>
  // 1), key 8j + 2t + (e & 1) of the tile (each item's sc is new, so that
  // its registers are free between items).
  auto scores = [&](int n, int (&sc)[8][4]) {
    const int8_t* kt = k_tile(n % R::STAGES);
    wgmma_fence();
    fence_operands(sc);
#pragma unroll
    for (int kc = 0; kc < D / 32; ++kc) wgmma_s8_m64n64(sc, s8_desc(qs, kc), s8_desc(kt, kc), kc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
  };

  int n = 0;
  for (int qb = 0; qb < p.nkv; ++qb) {
    const int kb0 = qb * p.block_kv;
    const int kb1 = kb0 + p.block_kv;
    const int t_first = next_run(kb0, kb1);
    if (t_first >= kb1) continue;  // no row of the block sees it: nothing changes
    const size_t sidx = (size_t(b) * p.Hkv + kvh) * p.nkv + qb;
    const float kss = p.ks[sidx] * p.sm_scale;
    const float f_r[2] = {sqs[16 * warp + g] * kss, sqs[16 * warp + g + 8] * kss};

    // Sweep 1: the row max over the whole quant block, on the int32 scores.
    int imax[2] = {INT_MIN, INT_MIN};
    bool any_masked[2] = {false, false};
    auto max_tile = [&](auto unmasked_tag, const int (&sc)[8][4], int t0, int tend) {
      constexpr bool UNMASKED = decltype(unmasked_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kloc = t0 + 8 * j + 2 * t + (e & 1);
          if (UNMASKED) {
            imax[r] = max(imax[r], sc[j][e]);
          } else if (kloc < tend) {  // (keys past the quant block are absent)
            if (pair_valid(p, qpos_r[r], kv_off + kloc, kloc)) {
              imax[r] = max(imax[r], sc[j][e]);
            } else {
              any_masked[r] = true;
            }
          }
        }
    };
    auto max_of = [&](const int (&sc)[8][4], int t0) {
      const int tend = min(t0 + BKV, kb1);
      if (!range_should_run(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1)) {
        any_masked[0] = any_masked[1] = true;  // every present score of the warp is masked
      } else if (tend - t0 == BKV &&
                 range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1)) {
        max_tile(std::true_type{}, sc, t0, tend);
      } else {
        max_tile(std::false_type{}, sc, t0, tend);
      }
    };
    for (int t0 = t_first; t0 < kb1; t0 = next_run(t0 + BKV, kb1), ++n) {  // max sweep
      int sc[8][4];
      full(n);
      scores(n, sc);
      release(n);
      max_of(sc, t0);
    }
    float m_next[2], alpha[2], shift[2], f2[2], shift2[2];
    const float4 mlp = *ml;
    const float m[2] = {mlp.x, mlp.y};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int im = quad_imax(imax[r]);
      const bool am = quad_max(any_masked[r] ? 1.f : 0.f) > 0.f;
      const float mc = im != INT_MIN ? dequant(p, im, f_r[r]) : (am ? p.mask_value : -INFINITY);
      m_next[r] = fmaxf(m[r], mc);
      alpha[r] = m_next[r] == -INFINITY ? 1.f : expf(m[r] - m_next[r]);
      shift[r] = m_next[r] - p.ln_p;
      f2[r] = f_r[r] * LOG2E;
      shift2[r] = shift[r] * LOG2E;
    }
    *ml = make_float4(m_next[0], m_next[1], mlp.z, mlp.w);  // m is the new max from here on

    // Sweep 2: P' = exp(s - (m_next - ln p_scale)) in bf16, and pv +=
    // P'·[V | 1] on wgmma (l in its last n8 tile). A masked pair's p is 0
    // by the mask itself, so a row masked across the whole block (m_next
    // the mask value: the plain version's `live` select) adds nothing; a
    // tile the warp's rows see whole takes no mask.
    auto exp_tile = [&](auto unmasked_tag, auto cap_tag, const int (&sc)[8][4], int t0,
                        int tend) {
      constexpr bool UNMASKED = decltype(unmasked_tag)::value;
      constexpr bool CAP = decltype(cap_tag)::value;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 2 * kk + hh;
            float pe[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int s = sc[j][2 * r + u];
              float x = CAP ? expf(dequant(p, s, f_r[r]) - shift[r])
                            : ex2(fmaf(s32_to_f32(s), f2[r], -shift2[r]));
              if (!UNMASKED) {
                const int kloc = t0 + 8 * j + 2 * t + u;
                const bool keep = kloc < tend && pair_valid(p, qpos_r[r], kv_off + kloc, kloc);
                x = keep ? x : 0.f;
              }
              pe[u] = x;
            }
            const __nv_bfloat162 pb = __floats2bfloat162_rn(pe[0], pe[1]);
            a[kk][2 * hh + r] = *reinterpret_cast<const uint32_t*>(&pb);
          }
    };
    zero(pv);
    for (int t0 = t_first; t0 < kb1; t0 = next_run(t0 + BKV, kb1), ++n) {  // exp sweep
      int sc[8][4];
      full(n);
      scores(n, sc);  // (P·V of the item before has landed too)
      if (t0 != t_first) {
        fence_operands(a);  // (P held until that P·V landed)
        release(n - 1);
      }
      const int tend = min(t0 + BKV, kb1);
      if (range_should_run(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1)) {
        const bool unmasked =
            tend - t0 == BKV &&
            range_unmasked(p, wq_first, wq_last, kv_off + t0, kv_off + tend - 1, tend - 1);
        with_tags(unmasked, p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
          exp_tile(unmasked_tag, cap_tag, sc, t0, tend);
        });
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[kk][i] = 0u;  // the warp sees nothing of the tile
      }
      const __nv_bfloat16* vt = v_tile(n % R::STAGES);
      wgmma_fence();
      fence_operands(pv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(pv, a[kk], tile_desc_mn(vt, 16 * kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operands(pv);
    fence_operands(a);
    release(n - 1);
    // (every column of the ones block holds the row's whole sum)
    const float v_scale = p.vs[sidx];
    const float4 mlf = *ml;
    *ml = make_float4(mlf.x, mlf.y, alpha[0] * mlf.z + pv[ND][0], alpha[1] * mlf.w + pv[ND][2]);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const float4 x = acc4[c * R::CONSUMERS * 128];
      acc4[c * R::CONSUMERS * 128] =
          make_float4(x.x * alpha[0] + pv[c][0] * v_scale, x.y * alpha[0] + pv[c][1] * v_scale,
                      x.z * alpha[1] + pv[c][2] * v_scale, x.w * alpha[1] + pv[c][3] * v_scale);
    }
  }

  // ---- Epilogue: o = acc / l (l == 0 -> o = 0); lse = m + log l - ln p.
  const size_t obase = (size_t(b) * p.H + h) * p.Sq;
  const float4 mlf = *ml;
  const float m[2] = {mlf.x, mlf.y}, l[2] = {mlf.z, mlf.w};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qpos_r[r] - p.offs[2 * b];  // (rbase + g + 8r, from what is live)
    if (row >= p.Sq) continue;
    const float l_inv = l[r] == 0.f ? 1.f : 1.f / l[r];
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const float4 x = acc4[c * R::CONSUMERS * 128];
      const float o0 = (r ? x.z : x.x) * l_inv, o1 = (r ? x.w : x.y) * l_inv;
      const size_t idx = (obase + row) * D + 8 * c + 2 * t;
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

// ---------------------------------------------------------------------------
// MODE_INT8_P: wgmma, a producer warpgroup and one or two consumer
// warpgroups.

template <int D, int C, int TK>
struct Int8pRing {
  // Consumer warpgroups (64 block rows each), keys an item (a tile: 64 or
  // 128) and blocks an SM: one consumer a block and 64-key tiles, two
  // blocks an SM (the serving prefill's few blocks spread over every SM,
  // a light block beside a heavy one); else one block an SM.
  static constexpr int CONSUMERS = C;
  static constexpr int ROWS = 64 * C;                // q heads x q positions
  static constexpr int BLOCKS = C == 1 && TK == 64 ? 2 : 1;
  static_assert(BLOCKS == 2 || C == 2, "one consumer takes two blocks an SM");
  static constexpr int NTB = 128 * (1 + C);          // threads; all meet at a handoff
  static constexpr int STAGES = TK == 64 && C == 2 ? 4 : 3;  // stages in the ring
  static constexpr int KCPT = TK * D / 2048;  // 16-byte chunks of a K tile a producer thread copies
  // Items in flight beyond the one handed over (as Bf16pRing's LAG); the
  // 4-key x 16-byte units of a V tile.
  static constexpr int LAG = STAGES - 1, VUNITS = TK * D / 64;
  // The registers of a producer and of a consumer thread (setmaxnreg; the
  // launch gives each thread 65536 / (NTB * BLOCKS), rounded down to 8).
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = C == 1 ? 216 : 232;
  static_assert(PRODUCER_REGS + C * CONSUMER_REGS <=
                (1 + C) * (65536 / (NTB * BLOCKS) / 8 * 8), "register budget");
  // Named barriers (0 is __syncthreads): stage s holds an item for consumer
  // c (FULL + C·s + c), stage s is free again (EMPTY + s), consumer c's Q
  // tile is in place (QREADY + c).
  static constexpr int FULL = 1, EMPTY = FULL + C * STAGES, QREADY = EMPTY + STAGES;
  static constexpr int FULL_THREADS = 256;  // the producer and one consumer
  static_assert(QREADY + C <= 16, "16 named barriers");
  // A stage: the K tile and V's rows as copied (TK rows each, int8,
  // wgmma_s8.cuh's layout), then Vᵀ: D rows (one a column of V) of 128
  // bytes, the tile's keys in the first TK, in the order P's register A
  // takes them. Shared memory: each consumer's Q tile, the stages, the
  // rows' scales; 1 KB to align.
  static constexpr int TILE = TK * S8_ROW;
  static constexpr int STAGE = 2 * TILE + D * S8_ROW;
  static constexpr int KV_OFF = C * S8_TILE;
  static constexpr int SQ_OFF = KV_OFF + STAGES * STAGE;
  static constexpr int BYTES = SQ_OFF + ROWS * 4 + 1024;
};

// Block row r holds q head kvh·G + hc·GB + r / NQ at q position q0 + r % NQ
// (GB heads of the group a block, NQ = ROWS / GB positions); the row exists
// when its head is one of the group's and its position < Sq.
__device__ __forceinline__ bool row_exists(const Params& p, int hc, int q0, int r) {
  return r / p.NQ < p.GB && hc * p.GB + r / p.NQ < p.G && q0 + r % p.NQ < p.Sq;
}

// The global positions that rows [r0, r0 + n) of the block hold, over the
// rows that exist, as (lo, hi): lo > hi when none does. A whole warp calls
// it (its lanes take the rows in turn) and gets the same span.
__device__ __forceinline__ int2 row_span(const Params& p, int hc, int q0, int q_off, int r0,
                                         int n) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = r0 + (threadIdx.x & 31); r < r0 + n; r += 32) {
    if (!row_exists(p, hc, q0, r)) continue;
    lo = min(lo, q_off + q0 + r % p.NQ);
    hi = max(hi, q_off + q0 + r % p.NQ);
  }
  return make_int2(__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi));
}

// Word i of a 16-byte vector.
__device__ __forceinline__ uint32_t word(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Four P' in [0, 127.5) rounded to nearest even and packed as int8, byte u
// from pe[u]: the low byte of pe + 1.5·2^23 (an f32 add rounds to an
// integer there) is rint(pe).
__device__ __forceinline__ uint32_t pack_p(const float (&pe)[4]) {
  uint32_t x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) x[u] = __float_as_uint(__fadd_rn(pe[u], 12582912.f));
  return __byte_perm(__byte_perm(x[0], x[1], 0x0040), __byte_perm(x[2], x[3], 0x0040), 0x5410);
}

// One lane's part of a q row (f32 or bf16) as f32: NP pieces of PE
// elements, piece i at element PE·(part + 8i) of the row from `row`, so
// that the 8 lanes of a row read 8 neighbouring pieces at a time; 0 where
// the row does not exist. 16-byte loads (8 at d=32 in bf16) where q's
// address is 16-byte aligned, else one element at a time.
template <bool QBF16, int PE, int NP>
__device__ __forceinline__ void load_q_part(const void* q, size_t row, int part, bool exists,
                                            bool vec, float (&x)[NP * PE]) {
#pragma unroll
  for (int e = 0; e < NP * PE; ++e) x[e] = 0.f;
  if (!exists) return;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const size_t at = row + PE * (part + 8 * i);
    float* xi = x + PE * i;
    if (QBF16) {
      const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(q) + at;
      if (vec) {
        uint32_t w[PE / 2];
        if constexpr (PE == 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          w[0] = v.x, w[1] = v.y;
        }
#pragma unroll
        for (int k = 0; k < PE / 2; ++k) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
          xi[2 * k] = __low2float(h);
          xi[2 * k + 1] = __high2float(h);
        }
      } else {
#pragma unroll
        for (int e = 0; e < PE; ++e) xi[e] = __bfloat162float(src[e]);
      }
    } else {
      const float* src = reinterpret_cast<const float*>(q) + at;
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        xi[0] = v.x, xi[1] = v.y, xi[2] = v.z, xi[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < PE; ++e) xi[e] = src[e];
      }
    }
  }
}

// One block per (batch, kv head, chunk of GB q heads, q tile of NQ
// positions), the heaviest q tiles first. The walk is the same for every
// warpgroup: for each quant block, the tiles of it (64 keys from its
// start, the last clipped at its end) that some row of the block sees,
// once for the max sweep and once for the exp sweep; each such item takes
// the next stage of the ring. Warpgroup 0, the producer, copies each
// item's K rows into its stage and, for the exp sweep, its V rows, which it
// transposes into Vᵀ in registers. The consumers (consumer c holds block
// rows 64c..64c+63; warp w of each owns 16 of them) run S = Qq·Kqᵀ on
// wgmma for every item, the integer row max over the max sweep, then P',
// l and pvi += P·V over the exp sweep (P rounded to int8 as the register A
// of an s8 wgmma against Vᵀ), and fold each quant block into acc and l at
// its end.
//
// Vᵀ's key order: S's accumulator gives lane t of a warp keys 8j + 2t and
// 8j + 2t + 1 of n8 tile j, and the s8 register A wants k columns 4t..4t+3
// (a0, a1) and 16 + 4t.. (a2, a3) of each k32 step. A thread packs the P
// of tiles 4c + 2h and 4c + 2h + 1 into the four k columns 16h + 4t..: so
// k column 32c + 16h + 4t + 2i + u of Vᵀ holds V's key 32c + 16h + 8i +
// 2t + u (the product's sum over k does not care about the order).
template <int D, bool QBF16, int C, int TK>
__global__ void __launch_bounds__(Int8pRing<D, C, TK>::NTB, Int8pRing<D, C, TK>::BLOCKS)
    flash_int8_int8p_kernel(const Params p) {
  using R = Int8pRing<D, C, TK>;
  constexpr int ND = D / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  auto k_of = [&](int s) { return reinterpret_cast<int8_t*>(smem + R::KV_OFF + s * R::STAGE); };
  auto raw_of = [&](int s) { return k_of(s) + R::TILE; };
  auto vt_of = [&](int s) { return k_of(s) + 2 * R::TILE; };

  const int tid = threadIdx.x, wg = tid >> 7, gtid = tid & 127;
  // Heaviest first: the last q tile sees the most keys under a causal
  // mask, so the q tile is the grid's slow index, counted from the end.
  const int heads = p.HC * p.Hkv * p.B;
  const int ntiles = (p.Sq + p.NQ - 1) / p.NQ;
  const int q0 = (ntiles - 1 - int(blockIdx.x / heads)) * p.NQ;
  const int hc = blockIdx.x % p.HC;
  const int kvh = (blockIdx.x / p.HC) % p.Hkv;
  const int b = (blockIdx.x % heads) / (p.HC * p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];
  const int first_q = q_off + q0, last_q = q_off + min(q0 + p.NQ, p.Sq) - 1;
  // The walk within the quant block that ends at kb1: its next tile from
  // t0 on that a row of the block sees.
  auto next_run = [&](int t0, int kb1) {
    while (t0 < kb1 &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + TK, kb1) - 1))
      t0 += TK;
    return t0;
  };

  if (wg == 0) {
    // Producer: item n into stage n % STAGES once the consumers handed that
    // stage back; handed over LAG items later, when its copies have landed
    // (and its V is transposed).
    setmaxnreg_dec<R::PRODUCER_REGS>();
    const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
    const int8_t* kg = p.k + kvbase;
    const int8_t* vg = p.v + kvbase;
    // Unit u of a V tile (u < VUNITS, gtid + 128i): the 16 bytes from column
    // 16·ucc of keys vr + {0, 1, 8, 9}, which k columns 32uc + 16uh + 4ut..
    // of Vᵀ take. A thread copies its units itself, so its own cp.async
    // wait is all its transposition needs.
    struct Unit { int vr, ucc, q, ut; };
    auto unit = [&](int u) {
      const int ut = u & 3, uh = (u >> 3) & 1, rest = u >> 4;
      const int uc = rest % (TK / 32);
      return Unit{32 * uc + 16 * uh + 2 * ut, 2 * (rest / (TK / 32)) + ((u >> 2) & 1),
                  2 * uc + uh, ut};
    };
    auto copy_item = [&](int t0, int kend, bool v_item, int s) {
#pragma unroll
      for (int i = 0; i < R::KCPT; ++i) {
        const int e = gtid + 128 * i, r = e / (D / 16), c = e % (D / 16);
        const bool ok = t0 + r < kend;  // zero past the quant block's end
        cp_async16(k_of(s) + sw8(r, c), kg + size_t(ok ? t0 + r : 0) * D + 16 * c, ok);
      }
      if (v_item) {
        for (int u = gtid; u < R::VUNITS; u += 128) {
          const Unit x = unit(u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = x.vr + (i & 1) + 8 * (i >> 1);
            const bool ok = t0 + r < kend;
            cp_async16(raw_of(s) + sw8(r, x.ucc), vg + size_t(ok ? t0 + r : 0) * D + 16 * x.ucc, ok);
          }
        }
      }
      cp_async_commit();
    };
    // Vᵀ from the copied rows: each 4 x 4 block of bytes (word i of the
    // four rows) transposed by byte permutes, word k of it the four keys of
    // column 16ucc + 4i + k.
    auto hand_over = [&](int s, bool v_item) {
      if (v_item) {
        for (int u = gtid; u < R::VUNITS; u += 128) {
          const Unit x = unit(u);
          uint4 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint4*>(raw_of(s) + sw8(x.vr + (i & 1) + 8 * (i >> 1), x.ucc));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t lo01 = __byte_perm(word(w[0], i), word(w[1], i), 0x5140);
            const uint32_t hi01 = __byte_perm(word(w[0], i), word(w[1], i), 0x7362);
            const uint32_t lo23 = __byte_perm(word(w[2], i), word(w[3], i), 0x5140);
            const uint32_t hi23 = __byte_perm(word(w[2], i), word(w[3], i), 0x7362);
            const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int d = 16 * x.ucc + 4 * i + k;
              *reinterpret_cast<uint32_t*>(vt_of(s) + sw8(d, x.q) + 4 * x.ut) = col[k];
            }
          }
        }
      }
      fence_async_shared();
#pragma unroll
      for (int c = 0; c < C; ++c) bar_arrive(R::FULL + C * s + c, R::FULL_THREADS);
    };
    uint32_t v_items = 0;  // bit s: stage s holds an item of the exp sweep
    int n = 0;
    for (int kb0 = 0; kb0 < p.Skv; kb0 += p.block_kv) {
      const int kb1 = kb0 + p.block_kv;
      const int t_first = next_run(kb0, kb1);
      for (int sw = 0; sw < 2; ++sw) {
        for (int t0 = t_first; t0 < kb1; t0 = next_run(t0 + TK, kb1), ++n) {
          const int s = n % R::STAGES;
          if (n >= R::LAG) {
            cp_async_wait<R::LAG - 1>();
            const int j = (n - R::LAG) % R::STAGES;
            hand_over(j, (v_items >> j) & 1u);  // item n - LAG landed
          }
          if (n >= R::STAGES) bar_sync(R::EMPTY + s, R::NTB);  // the consumers are done with s
          copy_item(t0, kb1, sw == 1, s);
          v_items = (v_items & ~(1u << s)) | (uint32_t(sw) << s);
        }
      }
    }
    cp_async_wait_all();
    for (int j = max(n - R::LAG, 0); j < n; ++j) {
      const int s = j % R::STAGES;
      hand_over(s, (v_items >> s) & 1u);
    }
    // The consumers hand back every stage: wait for the last ones.
    for (int j = max(n - R::STAGES, 0); j < n; ++j) bar_sync(R::EMPTY + j % R::STAGES, R::NTB);
    return;
  }

  // Consumers.
  setmaxnreg_inc<R::CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int8_t* qs = reinterpret_cast<int8_t*>(smem) + cw * S8_TILE;
  float* sqs = reinterpret_cast<float*>(smem + R::SQ_OFF) + 64 * cw;
  const int wrow = 64 * cw + 16 * warp;  // this warp's first block row

  // ---- Q: per-row symmetric int8 quantization of this warp's 16 rows
  // (IEEE division, round half to even, clipped to ±127) into the
  // consumer's s8 tile; rows that do not exist are 0. Eight lanes a row,
  // four rows at a time: every load first, then four short chains of
  // shuffles and divisions side by side.
  {
    constexpr int E = D / 8;  // elements of a row a lane takes
    constexpr int PE = E < 16 / (QBF16 ? 2 : 4) ? E : 16 / (QBF16 ? 2 : 4);  // a piece's
    constexpr int NP = E / PE;
    const int sub = lane >> 3, part = lane & 7;
    const bool vec = (reinterpret_cast<uintptr_t>(p.q) & 15) == 0;
    float x[4][E];
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int br = wrow + 4 * it + sub;
      const size_t row = ((size_t(b) * p.H + kvh * p.G + hc * p.GB + br / p.NQ) * p.Sq + q0 +
                          br % p.NQ) * D;
      load_q_part<QBF16, PE, NP>(p.q, row, part, row_exists(p, hc, q0, br), vec, x[it]);
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(x[it][e]));
#pragma unroll
      for (int o = 1; o <= 4; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = fmaxf(amax, p.scale_clamp) / 127.0f;
      const int rr = 16 * warp + 4 * it + sub;  // the row in the consumer's tile
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        uint32_t w[PE / 4];
#pragma unroll
        for (int e = 0; e < PE; ++e) {
          float qv = rintf(x[it][PE * i + e] / scale);
          qv = fminf(fmaxf(qv, -127.f), 127.f);
          const uint32_t byte = uint32_t(__float2int_rn(qv)) & 0xFFu;
          w[e / 4] = e % 4 == 0 ? byte : w[e / 4] | (byte << (8 * (e % 4)));
        }
        const int d0 = PE * (part + 8 * i);  // the piece's first column
        int8_t* dst = qs + sw8(rr, d0 / 16) + d0 % 16;
        if constexpr (PE == 8) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = w[0];
        }
      }
      if (part == 0) sqs[rr] = scale;
    }
    fence_async_shared();
    bar_sync(R::QREADY + cw, 128);
  }
  // This thread's rows g and g + 8 of its warp's 16: their positions and
  // scales; the positions the warp's rows that exist span.
  int qp[2];
  float sq_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qp[r] = q_off + q0 + (wrow + g + 8 * r) % p.NQ;
    sq_r[r] = sqs[16 * warp + g + 8 * r];
  }
  const int2 wspan = row_span(p, hc, q0, q_off, wrow, 16);
  const int wlo = wspan.x, whi = wspan.y;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
  zero(acc);
  int pvi[ND][4];    // P·V of the quant block's exp sweep, exact in int32
  uint32_t a[TK / 32][4];  // P of an exp item: register A of k32 step c (keys 32c..32c+31)

  // Item n of the walk sits in stage n % STAGES.
  auto full = [&](int n) { bar_sync(R::FULL + C * (n % R::STAGES) + cw, R::FULL_THREADS); };
  auto release = [&](int n) { bar_arrive(R::EMPTY + n % R::STAGES, R::NTB); };
  // S = Qq·Kqᵀ of item n, issued and waited for: sc[j][e] is row g + 8(e >>
  // 1), key 8j + 2t + (e & 1) of the tile.
  auto scores = [&](int n, int (&sc)[TK / 8][4]) {
    const int8_t* kt = k_of(n % R::STAGES);
    wgmma_fence();
    fence_operands(sc);
#pragma unroll
    for (int kc = 0; kc < D / 32; ++kc) wgmma_s8_ss<TK>(sc, s8_desc(qs, kc), s8_desc(kt, kc), kc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
  };

  int n = 0;
  for (int qb = 0; qb < p.nkv; ++qb) {
    const int kb0 = qb * p.block_kv;
    const int kb1 = kb0 + p.block_kv;
    const int t_first = next_run(kb0, kb1);
    if (t_first >= kb1) continue;  // no row of the block sees it: nothing changes
    const size_t sidx = (size_t(b) * p.Hkv + kvh) * p.nkv + qb;
    const float kss = p.ks[sidx] * p.sm_scale;
    const float f_r[2] = {sq_r[0] * kss, sq_r[1] * kss};

    // Sweep 1: the row max over the whole quant block, on the int32 scores.
    int imax[2] = {INT_MIN, INT_MIN};
    bool any_masked[2] = {false, false};
    auto max_tile = [&](auto unmasked_tag, const int (&sc)[TK / 8][4], int t0, int tend) {
      constexpr bool UNMASKED = decltype(unmasked_tag)::value;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kloc = t0 + 8 * j + 2 * t + (e & 1);
          if (UNMASKED) {
            imax[r] = max(imax[r], sc[j][e]);
          } else if (kloc < tend) {  // (keys past the quant block are absent)
            if (pair_valid(p, qp[r], kv_off + kloc, kloc)) {
              imax[r] = max(imax[r], sc[j][e]);
            } else {
              any_masked[r] = true;
            }
          }
        }
    };
    for (int t0 = t_first; t0 < kb1; t0 = next_run(t0 + TK, kb1), ++n) {  // the max sweep
      int sc[TK / 8][4];
      full(n);
      scores(n, sc);
      release(n);
      const int tend = min(t0 + TK, kb1);
      if (!range_should_run(p, wlo, whi, kv_off + t0, kv_off + tend - 1)) {
        any_masked[0] = any_masked[1] = true;  // every present score of the warp is masked
      } else if (tend - t0 == TK &&
                 range_unmasked(p, wlo, whi, kv_off + t0, kv_off + tend - 1, tend - 1)) {
        max_tile(std::true_type{}, sc, t0, tend);
      } else {
        max_tile(std::false_type{}, sc, t0, tend);
      }
    }
    float m_next[2], alpha[2], shift[2], fl2[2], sh2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int im = quad_imax(imax[r]);
      const bool am = quad_max(any_masked[r] ? 1.f : 0.f) > 0.f;
      const float mc = im != INT_MIN ? dequant(p, im, f_r[r]) : (am ? p.mask_value : -INFINITY);
      m_next[r] = fmaxf(m[r], mc);
      // (m_next stays -inf only if every tile of the block was skipped.)
      alpha[r] = m_next[r] == -INFINITY ? 1.f : expf(m[r] - m_next[r]);
      shift[r] = m_next[r] - p.ln_p;
      fl2[r] = f_r[r] * LOG2E;
      sh2[r] = shift[r] * LOG2E;
    }

    // Sweep 2: P' = exp(s - (m_next - ln p_scale)), its f32 sum, and pvi +=
    // round(P')·V on wgmma. A masked pair's P' is 0 by the mask itself, so
    // a row masked across the whole block (m_next the mask value: the plain
    // version's `live` select) adds nothing; a tile the warp's rows see
    // whole takes no mask.
    float lsum[2] = {0.f, 0.f};
    auto exp_tile = [&](auto unmasked_tag, auto cap_tag, const int (&sc)[TK / 8][4], int t0,
                        int tend) {
      constexpr bool UNMASKED = decltype(unmasked_tag)::value;
      constexpr bool CAP = decltype(cap_tag)::value;
#pragma unroll
      for (int c = 0; c < TK / 32; ++c)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pe[4];  // keys 8j + 2t + (u & 1) of tile j = 4c + 2hh + (u >> 1)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * c + 2 * hh + (u >> 1);
              const int s = sc[j][2 * r + (u & 1)];
              float x = CAP ? expf(__fsub_rn(dequant(p, s, f_r[r]), shift[r]))
                            : ex2(fmaf(s32_to_f32(s), fl2[r], -sh2[r]));
              if (!UNMASKED) {
                const int kloc = t0 + 8 * j + 2 * t + (u & 1);
                const bool keep = kloc < tend && pair_valid(p, qp[r], kv_off + kloc, kloc);
                x = keep ? x : 0.f;
              }
              pe[u] = x;
            }
            lsum[r] += (pe[0] + pe[1]) + (pe[2] + pe[3]);
            a[c][2 * hh + r] = pack_p(pe);
          }
    };
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pvi[j][e] = 0;
    for (int t0 = t_first; t0 < kb1; t0 = next_run(t0 + TK, kb1), ++n) {  // the exp sweep
      int sc[TK / 8][4];
      full(n);
      scores(n, sc);  // (P·V of the item before has landed too)
      if (t0 != t_first) {
        fence_operands(a);  // (P held until that P·V landed)
        release(n - 1);
      }
      const int tend = min(t0 + TK, kb1);
      if (range_should_run(p, wlo, whi, kv_off + t0, kv_off + tend - 1)) {
        const bool unmasked =
            tend - t0 == TK && range_unmasked(p, wlo, whi, kv_off + t0, kv_off + tend - 1, tend - 1);
        with_tags(unmasked, p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
          exp_tile(unmasked_tag, cap_tag, sc, t0, tend);
        });
      } else {
#pragma unroll
        for (int c = 0; c < TK / 32; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[c][i] = 0u;  // the warp sees nothing of the tile
      }
      const int8_t* vt = vt_of(n % R::STAGES);
      wgmma_fence();
      fence_operands(pvi);
#pragma unroll
      for (int kc = 0; kc < TK / 32; ++kc) wgmma_s8_pv<D>(pvi, a[kc], s8_desc(vt, kc));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operands(pvi);
    fence_operands(a);
    release(n - 1);
    // (Every rounding spelled out: no multiply-add the compiler may or may
    // not fuse, so the bits do not depend on the instantiation.)
    const float vsc = p.vs[sidx];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = fmaf(alpha[r], l[r], quad_sum(lsum[r]));
      m[r] = m_next[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], static_cast<float>(pvi[j][e]) * vsc);
  }

  // ---- Epilogue: o = acc / l (l == 0 -> o = 0); lse = m + log l - ln p.
  // Each warp stages its 16 rows through its rows of the consumer's Q tile
  // (free once the last S landed), 128 bytes of each row at a time, and
  // writes them out 16 bytes a lane, whole rows side by side.
  using OT = std::conditional_t<QBF16, __nv_bfloat16, float>;
  constexpr int CP = 128 / int(sizeof(OT));                      // columns a pass
  constexpr int CPR = (D < CP ? D : CP) * int(sizeof(OT)) / 16;  // 16-byte chunks of a row a pass
  unsigned char* st = reinterpret_cast<unsigned char*>(qs) + 16 * warp * S8_ROW;
  float l_inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
#pragma unroll
  for (int ps = 0; ps < (D + CP - 1) / CP; ++ps) {
#pragma unroll
    for (int j = ps * CP / 8; j < ND && j < (ps + 1) * CP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r, at = (8 * j + 2 * t - ps * CP) * int(sizeof(OT));
        unsigned char* dst = st + row * S8_ROW + (((at >> 4) ^ (row & 7)) << 4) + (at & 15);
        const float o0 = acc[j][2 * r] * l_inv[r], o1 = acc[j][2 * r + 1] * l_inv[r];
        if constexpr (QBF16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o0, o1);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
        }
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * CPR / 32; ++i) {
      const int id = lane + 32 * i, row = id / CPR, c = id % CPR, br = wrow + row;
      if (!row_exists(p, hc, q0, br)) continue;
      const size_t orow = (size_t(b) * p.H + kvh * p.G + hc * p.GB + br / p.NQ) * p.Sq + q0 +
                          br % p.NQ;
      OT* dst = reinterpret_cast<OT*>(p.o) + orow * D + ps * CP + 16 / int(sizeof(OT)) * c;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(st + row * S8_ROW + ((c ^ (row & 7)) << 4));
    }
    __syncwarp();
  }
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int br = wrow + g + 8 * r;
      if (!row_exists(p, hc, q0, br)) continue;
      const size_t orow = (size_t(b) * p.H + kvh * p.G + hc * p.GB + br / p.NQ) * p.Sq + q0 +
                          br % p.NQ;
      p.lse[orow] = l[r] > 0.f ? m[r] + logf(l[r]) - p.ln_p : -INFINITY;
    }
  }
}

template <int D, bool QBF16, int C, int TK>
cudaError_t launch_int8_p(Params p, cudaStream_t stream) {
  using R = Int8pRing<D, C, TK>;
  constexpr int smem = R::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_int8p_kernel<D, QBF16, C, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.G = p.H / p.Hkv;
  p.GB = 1;  // q heads a block: one, the GQA group not folded into the rows
  p.NQ = R::ROWS / p.GB;
  p.HC = (p.G + p.GB - 1) / p.GB;
  const unsigned blocks = unsigned((p.Sq + p.NQ - 1) / p.NQ) * p.HC * p.Hkv * p.B;
  flash_int8_int8p_kernel<D, QBF16, C, TK><<<blocks, R::NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool QBF16>
cudaError_t launch_bf16_p(const Params& p, cudaStream_t stream) {
  using R = Bf16pRing<D>;
  constexpr int smem = R::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_bf16p_kernel<D, QBF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = unsigned((p.Sq + R::ROWS - 1) / R::ROWS) * p.H * p.B;
  flash_int8_bf16p_kernel<D, QBF16><<<blocks, R::NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mode(const Params& p, int mode, int q_bf16, cudaStream_t stream) {
  if (mode == MODE_INT8_P) {
    constexpr int CONSUMERS = 1;  // consumer warpgroups of an int8-P block
    constexpr int TILE_KEYS = 64;  // keys of an int8-P item
    return q_bf16 ? launch_int8_p<D, true, CONSUMERS, TILE_KEYS>(p, stream)
                  : launch_int8_p<D, false, CONSUMERS, TILE_KEYS>(p, stream);
  }
  return q_bf16 ? launch_bf16_p<D, true>(p, stream) : launch_bf16_p<D, false>(p, stream);
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
