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
//   f32: bf16 x bf16 products are exact in f32 (wgmma with an f32
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
//   at most one bf16 rounding of each P (chip_smoke.py's tolerance). bf16
//   takes p = 2^(x·log2 e − m·log2 e) on the SFU (ex2.approx): within
//   ~2^-22 relative plus the argument's rounding, |m|·2^-24·log2 e, of
//   exp(x − m), inside the tolerance's 1e-5 and 1e-6·|lse| terms.
//
// What bounds it on the H100: the serving prefill (bf16, S=2048, d=128,
// causal, GQA 4) is ~3.4e10 tensor-core flops (0.035 ms at 989 TFLOP/s)
// beside ~6.7e7 exponentials on the SFUs (0.016 ms) and the per-score f32
// work around them; each q tile copies the K/V tiles it sees again, from
// L2, so the copies cost more the fewer rows a block holds. solve's fa_bf16
// rung (N=8192, h=32, d=32, not causal) is 2.1e9 exponentials, 0.51 ms on
// the SFUs, above its 0.27 ms of products; the f32 rung is 2.7e11 f32 FMA
// flops, 4.1 ms at the CUDA cores' 67 TFLOP/s.
//
// What this design does about it. bf16: a block is (batch, kv head, q tile
// of ROWS rows: 192, three consumer warpgroups, at d >= 64; 128, two, at
// d=32), whose rows hold all `group` q heads of the tile (48 positions x 4
// heads at Llama-3-8B's GQA; a larger group is cut into chunks of ROWS
// heads), so each K/V tile is copied into shared memory once for ROWS
// rows. Its warpgroups specialise (setmaxnreg: 32 registers a producer
// thread, 160 a consumer thread; at d=32, where two blocks share an SM to
// fill each other's waits, 24 and 104). The producer keeps a ring of K/V
// stages (3; 4 at d=32) filled by cp.async straight into wgmma's
// 128-byte-swizzled layout and hands each stage over and back through
// named barriers, a full barrier per consumer, so no consumer waits for
// another. Each consumer (64 rows; warp w owns rows 16w..16w+15) holds Q,
// staged once scaled in bf16, and per 64-key tile runs S = Q·Kᵀ as a
// wgmma m64n64 from shared memory; the scores stay in its accumulator
// registers, where the row max and sum are quad shuffles; P, packed to
// bf16 in registers, is the A operand of a wgmma whose B is the V stage
// read MN-major. S of the next tile is issued before P·V of this one, so
// the softmax of the next tile runs while P·V is in flight (not at d=32,
// where the registers for both are not there). A tile wholly visible to a
// warp's rows takes a mask-free per-element loop and softcap is a
// compile-time choice (a runtime branch in the unrolled loop is
// if-converted); a warp whose rows see nothing of a tile skips the
// per-element work; acc is rescaled only when a row's max moved. Tiles
// past the causal bound or wholly behind the window (sink tiles aside) are
// never loaded. The grid runs the heaviest q tiles (the end of the
// sequence) first. Every block writes its own rows in a fixed reduction
// order: no atomics, the same bits every launch. f32: one block of 256
// threads per (batch, q head, 64-row q tile), K/V tiles double-buffered by
// cp.async, each thread owning 4 rows x 4 keys of S and 4 rows x D/16
// columns of O, with float4 shared-memory reads (the tile step of
// f32_tile.cuh, which paged_prefill.cu shares); the same tile skips and
// mask-free path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tile.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;   // q rows per f32 block
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
  int G, GB, NQ, HC;  // bf16 blocks: group, its heads a block, q positions a block, head chunks
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
// bf16: tensor cores (wgmma), a producer and two or three consumer
// warpgroups.

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Bf16Ring {
  using T = Bf16Tile<D>;
  // Consumer warpgroups (64 block rows each) and blocks an SM. At d=32,
  // bound by the exponentials, two blocks of two consumers share an SM and
  // fill each other's waits; above, one block of three, whose 192 rows
  // share each copy of a K/V tile from L2.
  static constexpr int CONSUMERS = D == 32 ? 2 : 3;
  static constexpr int BLOCKS = D == 32 ? 2 : 1;
  static constexpr int ROWS = 64 * CONSUMERS;        // q heads x q positions
  static constexpr int NTB = 128 * (1 + CONSUMERS);  // threads; all meet at a handoff
  static constexpr int STAGES = CONSUMERS == 3 ? 3 : 4;  // K/V stages in the ring
  static constexpr int LAG = STAGES - 2;  // tiles in flight beyond the ones handed over
  // The registers of a producer and of a consumer thread (setmaxnreg; the
  // launch gives each thread 65536 / (NTB * BLOCKS), rounded down to 8).
  static constexpr int PRODUCER_REGS = D == 32 ? 24 : 32, CONSUMER_REGS = D == 32 ? 104 : 160;
  // Whether the softmax of tile n + 1 runs while P·V of tile n is in
  // flight: at d=32 a consumer has not the registers to hold both (they
  // spill), and its SM's other block fills the wait instead.
  static constexpr bool OVERLAP = D != 32;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                (1 + CONSUMERS) * (65536 / (NTB * BLOCKS) / 8 * 8), "register budget");
  // Full barriers a stage: one per consumer, so that a consumer can run
  // ahead of the others by up to the ring.
  static constexpr int FULLS = CONSUMERS;
  static constexpr int FULL_THREADS = 128 + 128 * CONSUMERS / FULLS;
  // Named barriers (0 is __syncthreads): stage s holds a tile for consumer
  // c (FULL + FULLS·s + c % FULLS), stage s is free again (EMPTY + s),
  // consumer c's Q tile is in place (QREADY + c).
  static constexpr int FULL = 1, EMPTY = FULL + FULLS * STAGES, QREADY = EMPTY + STAGES;
  static_assert(QREADY + CONSUMERS <= 16, "16 named barriers");
  // Each consumer's Q tile, then per stage a K and a V tile (swizzled
  // bf16, 1024-byte aligned); 1 KB to align.
  static constexpr int KV_OFF = CONSUMERS * T::TILE * 2;
  static constexpr int BYTES = KV_OFF + STAGES * 2 * T::TILE * 2 + 1024;
};

// Block row r holds q head kvh·G + hc·GB + r / NQ at q position q0 + r % NQ
// (GB = min(G, ROWS) heads of the group, NQ = ROWS / GB positions, ROWS
// the block's rows); the row exists when its head is one of the group's
// and its position < Sq.
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

// One block per (batch, kv head, chunk of the group's q heads, q tile of
// ROWS rows). Warpgroup 0, the producer, copies the walk's key tiles (those
// some row of the block can see) into a ring of K/V stages; warpgroups 1..,
// the consumers (consumer c holds block rows 64c..64c+63; warp w of each
// owns 16 of them), run S = Q·Kᵀ, the online softmax and acc += P·V on each
// tile and hand its stage back. Stages pass between them through named
// barriers.
template <int D>
__global__ void __launch_bounds__(Bf16Ring<D>::NTB, Bf16Ring<D>::BLOCKS)
    flash_fwd_bf16_kernel(const Params p) {
  using T = Bf16Tile<D>;
  using R = Bf16Ring<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + R::KV_OFF);  // stage s: K, V

  const int tid = threadIdx.x, wg = tid >> 7, gtid = tid & 127;
  // Heaviest first: the last q tile sees the most keys, so the q tile is
  // the grid's slow index, counted from the end.
  const int heads = p.HC * p.Hkv * p.B;
  const int ntiles = (p.Sq + p.NQ - 1) / p.NQ;
  const int q0 = (ntiles - 1 - int(blockIdx.x / heads)) * p.NQ;
  const int hc = blockIdx.x % p.HC;
  const int kvh = (blockIdx.x / p.HC) % p.Hkv;
  const int b = (blockIdx.x % heads) / (p.HC * p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];
  const int first_q = q_off + q0, last_q = q_off + min(q0 + p.NQ, p.Sq) - 1;
  // The walk: the key tiles from t0 on that a row of the block can see.
  auto next_run = [&](int t0) {
    while (t0 < p.Skv &&
           !range_should_run(p, first_q, last_q, kv_off + t0, kv_off + min(t0 + BKV, p.Skv) - 1))
      t0 += BKV;
    return t0;
  };

  if (wg == 0) {
    // Producer: tile n of the walk into stage n % STAGES once the consumers
    // handed that stage back; handed over LAG tiles later, when its copies
    // have landed.
    setmaxnreg_dec<R::PRODUCER_REGS>();
    const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
    const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase;
    const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase;
    auto issue = [&](int t0, int s) {
      __nv_bfloat16* kt = kv + 2 * s * T::TILE;
#pragma unroll
      for (int k = 0; k < BKV * T::CPR / 128; ++k) {
        const int e = gtid + 128 * k, r = e / T::CPR, c = e % T::CPR;
        const bool ok = t0 + r < p.Skv;
        const size_t src = size_t(ok ? t0 + r : 0) * D + 8 * c;
        cp_async16(kt + sw(r, c), kg + src, ok);
        cp_async16(kt + T::TILE + sw(r, c), vg + src, ok);
      }
      cp_async_commit();
    };
    auto hand_over = [&](int s) {
#pragma unroll
      for (int c = 0; c < R::FULLS; ++c) bar_arrive(R::FULL + R::FULLS * s + c, R::FULL_THREADS);
    };
    int n = 0;
    for (int t0 = next_run(0); t0 < p.Skv; t0 = next_run(t0 + BKV), ++n) {
      const int s = n % R::STAGES;
      if (n >= R::STAGES) bar_sync(R::EMPTY + s, R::NTB);  // the consumers are done with stage s
      issue(t0, s);
      if (n >= R::LAG) {
        cp_async_wait<R::LAG>();
        fence_async_shared();
        hand_over((n - R::LAG) % R::STAGES);  // tile n - LAG landed
      }
    }
    stage_landed();
    for (int j = max(n - R::LAG, 0); j < n; ++j) hand_over(j % R::STAGES);
    // The consumers hand back every stage: wait for the last ones.
    for (int j = max(n - R::STAGES, 0); j < n; ++j) bar_sync(R::EMPTY + j % R::STAGES, R::NTB);
    return;
  }

  // Consumers.
  setmaxnreg_inc<R::CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem) + cw * T::TILE;
  // This consumer's 64 Q rows (block rows 64cw..), scaled in bf16 (each
  // product rounded back to bf16); rows that do not exist are 0.
  {
    const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q);
    const float scale = p.sm_scale;
    for (int e = gtid; e < 64 * T::CPR; e += 128) {
      const int r = e / T::CPR, c = e % T::CPR;
      const int br = 64 * cw + r;
      const int gi = hc * p.GB + br / p.NQ;  // the row's q head within the group
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row_exists(p, hc, q0, br)) {
        raw = *reinterpret_cast<const uint4*>(
            qg + ((size_t(b) * p.H + kvh * p.G + gi) * p.Sq + q0 + br % p.NQ) * D + 8 * c);
      }
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * scale);
      *reinterpret_cast<uint4*>(qs + sw(r, c)) = raw;
    }
    fence_async_shared();
    bar_sync(R::QREADY + cw, 128);
  }

  // This thread's rows g and g + 8 of its warp's 16 and their positions;
  // the positions the warp's rows that exist span.
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = q_off + q0 + (64 * cw + 16 * warp + g + 8 * h) % p.NQ;
  const int2 wspan = row_span(p, hc, q0, q_off, 64 * cw + 16 * warp, 16);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float acc[T::ND][4];
  zero(acc);

  // The scaled scores s[n][e] (row g + 8(e >> 1), key 8n + 2t + (e & 1) of
  // the tile) become the f32 p in place, p = 2^(x·log2 e − m·log2 e) on the
  // SFU; the running max and l follow, and alpha is the factor acc takes.
  auto softmax_tile = [&](auto unmasked_tag, auto cap_tag, float (&s)[8][4], int t0,
                          float (&alpha)[2]) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr bool CAP = decltype(cap_tag)::value;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[n][2 * h + j];
          if (CAP) x = p.softcap * tanhf(x / p.softcap);
          if (!UNMASKED) {
            const int kloc = t0 + 8 * n + 2 * t + j;
            if (!pair_valid(p, qpos[h], kv_off + kloc, kloc)) x = p.mask_value;
          }
          s[n][2 * h + j] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_next = fmaxf(m[h], mt);
      alpha[h] = expf(m[h] - m_next);
      const bool live = UNMASKED || m_next > p.mask_half;
      m[h] = m_next;
      const float m2 = m_next * LOG2E;
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pe = live ? ex2(fmaf(s[n][2 * h + j], LOG2E, -m2)) : 0.f;
          ls += pe;
          s[n][2 * h + j] = pe;
        }
      l[h] = alpha[h] * l[h] + ls;
    }
  };

  // S = Q·Kᵀ of the tile in stage st for this consumer's 64 rows, into sc:
  // issued.
  float sc[8][4];
  auto scores = [&](int st) {
    zero(sc);
    wgmma_fence();
    fence_operands(sc);
#pragma unroll
    for (int kc = 0; kc < T::KC; ++kc)
      wgmma_m64n64(sc, tile_desc(qs, 0, kc), tile_desc(kv + 2 * st * T::TILE, 0, kc), kc);
    wgmma_commit();
  };
  // Once its S landed: the tile's p in sc (0 on rows of a warp that sees
  // nothing of it) and alpha.
  auto softmax = [&](int t0, float (&alpha)[2]) {
    fence_operands(sc);
    const int k_first = kv_off + t0, k_last = kv_off + min(t0 + BKV, p.Skv) - 1;
    alpha[0] = alpha[1] = 1.f;
    if (wspan.x <= wspan.y && range_should_run(p, wspan.x, wspan.y, k_first, k_last)) {
      const bool unmasked =
          range_unmasked(p, wspan.x, wspan.y, k_first, kv_off + t0 + BKV - 1, t0 + BKV - 1);
      with_tags(unmasked, p.has_softcap, [&](auto unmasked_tag, auto cap_tag) {
        softmax_tile(unmasked_tag, cap_tag, sc, t0, alpha);
      });
    } else {
      zero(sc);
    }
  };
  // Once no product writes acc: acc times alpha (only when a row's max
  // moved), and p rounded to bf16 once as the register A fragments of
  // P·V (k16 step kk: keys 16kk..16kk+15).
  uint32_t a[4][4];
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
    fence_operands(acc);
    fence_operands(a);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < T::ND; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int nt = 2 * kk + hh;
          const __nv_bfloat162 pb = __floats2bfloat162_rn(sc[nt][2 * r], sc[nt][2 * r + 1]);
          a[kk][2 * hh + r] = *reinterpret_cast<const uint32_t*>(&pb);
        }
  };

  // Tile n of the walk sits in stage n % STAGES. While P·V of tile n runs
  // on the tensor cores, the softmax of tile n + 1 runs beside it (OVERLAP):
  // S of tile n + 1 is issued before P·V of tile n and waited for first. So a
  // consumer holds tile n's stage while it waits for tile n + 1's, and
  // the producer keeps STAGES - 2 tiles in flight beyond that one.
  auto full = [&](int n) {  // tile n is in its stage
    bar_sync(R::FULL + R::FULLS * (n % R::STAGES) + cw % R::FULLS, R::FULL_THREADS);
  };
  auto pv = [&](int n) {  // acc += P·V of tile n, issued
    const __nv_bfloat16* vt = kv + (2 * (n % R::STAGES) + 1) * T::TILE;
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], tile_desc_mn(vt, 16 * kk));
    wgmma_commit();
  };
  int t0 = next_run(0), n = 0;
  if (t0 < p.Skv) {
    float alpha[2];
    full(0);
    scores(0);
    wgmma_wait<0>();
    softmax(t0, alpha);
    rescale_and_pack(alpha);
    for (int tn = next_run(t0 + BKV); tn < p.Skv; tn = next_run(tn + BKV), ++n) {
      full(n + 1);
      scores((n + 1) % R::STAGES);
      pv(n);
      wgmma_wait<R::OVERLAP>();  // S of tile n + 1 landed; with OVERLAP P·V of tile n runs on
      softmax(tn, alpha);
      wgmma_wait<0>();
      bar_arrive(R::EMPTY + n % R::STAGES, R::NTB);  // the producer may refill tile n's stage
      rescale_and_pack(alpha);
    }
    pv(n);
    wgmma_wait<0>();
    bar_arrive(R::EMPTY + n % R::STAGES, R::NTB);
  }
  fence_operands(acc);

  // Epilogue: o = acc · l_inv; lse = m + log l.
  float lrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int br = 64 * cw + 16 * warp + g + 8 * h;
    if (!row_exists(p, hc, q0, br)) continue;
    const int head = kvh * p.G + hc * p.GB + br / p.NQ;
    const size_t row = (size_t(b) * p.H + head) * p.Sq + q0 + br % p.NQ;
    const float l_inv = lrow[h] == 0.f ? 1.f : 1.f / lrow[h];
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(p.o) + row * D;
#pragma unroll
    for (int c = 0; c < T::ND; ++c)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[c][2 * h] * l_inv, acc[c][2 * h + 1] * l_inv);
    if (p.lse != nullptr && t == 0) p.lse[row] = lrow[h] > 0.f ? m[h] + logf(lrow[h]) : -INFINITY;
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
cudaError_t launch(Params p, int bf16, cudaStream_t stream) {
  cudaError_t err;
  if (bf16) {
    constexpr int smem = Bf16Ring<D>::BYTES;
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    p.GB = min(p.G, Bf16Ring<D>::ROWS);
    p.NQ = Bf16Ring<D>::ROWS / p.GB;
    p.HC = (p.G + p.GB - 1) / p.GB;
    const unsigned blocks = unsigned((p.Sq + p.NQ - 1) / p.NQ) * p.HC * p.Hkv * p.B;
    flash_fwd_bf16_kernel<D><<<blocks, Bf16Ring<D>::NTB, smem, stream>>>(p);
  } else {
    constexpr int smem = F32Smem<D>::BYTES;
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
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
  p.G = Hkv > 0 ? H / Hkv : 1;
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
