// FlashAttention-2 forward in bf16 or f32 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quantizedmha_tpu/ops/flash_attention.py:124
// _fwd_kernel (the default attention of the Llama model and the "fa" /
// "fa_bf16" rungs of solve).
//
// Numerics contract (what _flash_fwd_plain in ops/flash_attention.py
// computes, up to the f32 summation order and a few ulps of exp/tanh):
//   Q is scaled in its own dtype (bf16: the wrapper passes the scale already
//   rounded to bf16, and each product is rounded back to bf16; f32: one f32
//   product). S = Q·Kᵀ in f32. bf16: bf16 x bf16 products are exact in f32
//   (wgmma with an f32 accumulator). f32: as the TPU's Precision.HIGHEST,
//   every f32 operand a is taken as three bf16 pieces, a0 = bf16(a), a1 =
//   bf16(a − a0), a2 = bf16(a − a0 − a1) (each residual exact in f32, so
//   a0 + a1 + a2 = a for 2^-110 <= |a| <= bf16's max; below, within
//   2^-134), and a·b is the sum of the six bf16 products a0b0, a0b1, a1b0,
//   a0b2, a1b1, a2b0 on wgmma with f32 accumulators, the small ones first.
//   The three left out, a1b2, a2b1, a2b2, are at most 2^-24·|a||b| together
//   (|a1| <= 2^-8|a|, |a2| <= 2^-17|a|). At d=256 the f32 route takes
//   true f32 FMAs on the CUDA cores instead (nothing left out), p =
//   expf(x − m) and P·V summed straight into the f32 acc, key after key.
//   Softcap cap·tanh(s/cap) on the
//   scaled scores, then masked scores take
//   the mask value: causal at global positions (kpos + kv_off <= qpos +
//   q_off), the window ((qpos+q_off) - (kpos+kv_off) < window, OR'd with
//   kpos + kv_off < sinks) and the kv edge (kpos < Skv). The online softmax
//   zeroes p on rows whose running max is still the mask value; l sums the
//   f32 p; p = 2^(x·log2 e − m·log2 e) on the SFU (ex2.approx: within
//   ~2^-22 relative plus the argument's rounding, |m|·2^-24 relative, of
//   exp(x − m)). bf16: P·V takes p in V's dtype; the kernel steps its
//   online softmax 64 keys at a time where the plain version steps block_kv
//   (1024) keys, so the bf16 P is rounded against a different running max,
//   a difference of at most one bf16 rounding of each P (chip_smoke.py's
//   tolerance). f32: P·V is the six bf16 products of p's pieces and V's,
//   summed per key tile from zero (tensor cores) and added to the running
//   f32 sum on the CUDA cores, so the tensor cores' own rounding never sees
//   more than one tile. Epilogue o = acc · (l == 0 ? 1 : 1/l), lse = m +
//   log l (-inf when l == 0).
//
// What bounds it on the H100: the serving prefill (bf16, S=2048, d=128,
// causal, GQA 4) is ~3.4e10 tensor-core flops (0.035 ms at 989 TFLOP/s)
// beside ~6.7e7 exponentials on the SFUs (0.016 ms) and the per-score f32
// work around them; each q tile copies the K/V tiles it sees again, from
// L2, so the copies cost more the fewer rows a block holds. solve's fa_bf16
// rung (N=8192, h=32, d=32, not causal) is 2.1e9 exponentials, 0.51 ms on
// the SFUs, above its 0.27 ms of products. The f32 rung is the same walk
// with six bf16 passes a product: 1.6e12 tensor-core flops, 1.67 ms at 989
// TFLOP/s, above the exponentials' 0.51 ms (true f32 FMAs on the CUDA
// cores would be 4.1 ms at 67 TFLOP/s); its split pass moves 240 MB
// (0.07 ms at 3.35 TB/s). Gemma-2 served in f32 (d=256, 16 q over 8 kv
// heads, S=2048 causal) is 3.4e10 f32 flops a layer, 0.51 ms on the CUDA
// cores at 67 TFLOP/s, far above its 3.4e7 exponentials and 100 MB.
//
// What this design does about it. A block is (batch, kv head, q tile of
// ROWS rows), whose rows hold all `group` q heads of the tile (48
// positions x 4 heads at Llama-3-8B's GQA and 192 rows; a larger group is
// cut into chunks of ROWS heads), so each K/V tile is copied into shared
// memory once for ROWS rows. Its warpgroups specialise (setmaxnreg): a
// producer keeps a ring of K/V stages filled by cp.async straight into
// wgmma's 128-byte-swizzled layout and hands each stage over and back
// through named barriers, a full barrier per consumer, so no consumer
// waits for another. Each consumer (64 rows; warp w owns rows
// 16w..16w+15) holds its Q tile in shared memory and per key tile runs S =
// Q·Kᵀ as wgmma from shared memory; the scores stay in its accumulator
// registers, where the row max and sum are quad shuffles; P, packed to
// bf16 in registers, is the A operand of a wgmma whose B is the V stage
// read MN-major. S of the next tile is issued before P·V of this one, so
// the softmax of the next tile runs while P·V is in flight (not at d=32,
// where the registers for both are not there). A tile wholly visible
// to a warp's rows takes a mask-free per-element loop and softcap is a
// compile-time choice (a runtime branch in the unrolled loop is
// if-converted); a warp whose rows see nothing of a tile skips the
// per-element work; acc is rescaled only when a row's max moved. Tiles
// past the causal bound or wholly behind the window (sink tiles aside) are
// never loaded. The grid runs the heaviest q tiles (the end of the
// sequence) first. Every block writes its own rows in a fixed reduction
// order: no atomics, the same bits every launch.
//   bf16 (Bf16Ring): 192 rows, three consumers, at d >= 64 (setmaxnreg 32 /
//   160 registers a thread), three stages; 128 rows, two consumers, at
//   d=32, where two blocks share an SM to fill each other's waits (24 /
//   104), four stages; Q staged once scaled in bf16. At d=256 (Gemma-2) a
//   consumer's 64 x 256 f32 accumulator is 128 registers a thread and a
//   K/V stage 64 KB: 128 rows, two consumers (40 / 232), two stages and
//   no overlap; P·V as two m64n128 products, one a column half of V and O.
//   f32 (F32Ring, flash_fwd_f32_kernel, the same walk in a kernel of its
//   own): a split pass (flash_fwd_split_kernel) first writes three bf16
//   planes each of Q (scaled in f32 first), K and V in the layout of a
//   bf16 tensor; a stage holds K's three planes and V's, a consumer Q's
//   three; S is six wgmma products of a Q plane and a K plane; p is split
//   into three register A fragments for six wgmma products against the V
//   planes into a per-tile accumulator. A plane of a 64-key tile fills a
//   swizzled tile of 8 KB at d=32 and d=64 (a stage 48 KB), so one block
//   an SM: three consumers at d=32 (32 / 160 registers, no overlap), two
//   at d=64 (40 / 232), three stages. At d=128 a key tile is 32 keys (two
//   planes a 16 KB tile, a stage 48 KB) and one consumer of 64 rows takes
//   all the registers (no setmaxnreg).
//   f32 at d=256 (flash_fwd_f32_d256_kernel): three planes of a 64 x 256
//   operand take 96 KB, so a ring of them does not fit beside Q's, and the
//   64 x 256 accumulator of one consumer is 128 registers a thread. So
//   true f32 FMAs on the CUDA cores over f32_tile.cuh's tile step (the
//   device code of paged_prefill.cu's f32-q kernel): a block of 256 threads
//   is (batch, q head, 64 q rows); Q, K and V as [64][260] f32 tiles and P
//   take 217 KB, one stage each of K and V filled by cp.async straight from
//   the f32 tensors (no split pass, no scratch), K's next tile landing while
//   P·V runs and V's while the next scores run. Tiles past the causal bound
//   or wholly behind the window are never loaded (a sliding layer at 8192
//   tokens does half the work); the heaviest q tiles run first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tile.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BKV = 64;  // kv positions per bf16 shared-memory tile

struct Params {
  const void* q;    // [B, H, Sq, D] (f32 route: Q's first bf16 plane)
  const void* k;    // [B, Hkv, Skv, D] (f32 route: K's first bf16 plane)
  const void* v;    // [B, Hkv, Skv, D] (f32 route: V's first bf16 plane)
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
  // share each copy of a K/V tile from L2; at d=256 one block of two, whose
  // accumulators take the registers of three.
  static constexpr int CONSUMERS = D == 32 || D == 256 ? 2 : 3;
  static constexpr int BLOCKS = D == 32 ? 2 : 1;
  static constexpr int ROWS = 64 * CONSUMERS;        // q heads x q positions
  static constexpr int NTB = 128 * (1 + CONSUMERS);  // threads; all meet at a handoff
  // K/V stages in the ring (d=256: two of 64 KB beside two Q tiles of 32 KB)
  static constexpr int STAGES = D == 256 ? 2 : CONSUMERS == 3 ? 3 : 4;
  static constexpr int LAG = STAGES - 2;  // tiles in flight beyond the ones handed over
  // The registers of a producer and of a consumer thread (setmaxnreg; the
  // launch gives each thread 65536 / (NTB * BLOCKS), rounded down to 8).
  static constexpr int PRODUCER_REGS = D == 32 ? 24 : D == 256 ? 40 : 32;
  static constexpr int CONSUMER_REGS = D == 32 ? 104 : D == 256 ? 232 : 160;
  // Whether the softmax of tile n + 1 runs while P·V of tile n is in
  // flight: at d=32 a consumer has not the registers to hold both (they
  // spill), and its SM's other block fills the wait instead; at d=256 the
  // accumulator leaves no room for both either.
  static constexpr bool OVERLAP = D != 32 && D != 256;
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
  static_assert(BYTES <= 232448, "shared memory of a block");
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
// f32: the same walk on the tensor cores over three bf16 planes of each
// operand, six products a product (Precision.HIGHEST's passes).

// The f32 route's ring.
template <int D>
struct F32Ring {
  using T = Bf16Tile<D>;
  // Keys a tile: at d=128 a 64-key stage of six 16 KB planes leaves no room
  // for a ring beside Q's planes, so 32 keys (two planes a swizzled tile).
  static constexpr int TK = D == 128 ? 32 : 64;
  static constexpr int PPT = 64 / TK;  // planes a swizzled tile of 64 rows
  // A plane of a 64-key tile takes a whole 8 KB tile at d=32 as at d=64,
  // so two blocks do not fit an SM: one block, three consumers at d=32, two
  // at d=64 (the registers of the six-pass pipeline), one at d=128.
  static constexpr int CONSUMERS = D == 32 ? 3 : D == 64 ? 2 : 1;
  static constexpr int ROWS = 64 * CONSUMERS;
  static constexpr int NTB = 128 * (1 + CONSUMERS);
  static constexpr int STAGES = 3, LAG = STAGES - 2;
  // One consumer: 256 threads take 255 registers each without setmaxnreg
  // (whose increase may not go below the launch's count).
  static constexpr bool SETMAXNREG = CONSUMERS > 1;
  static constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 232;
  // At d=32, where three consumers share the SM, the softmax waits for
  // P·V: the registers of both (the three P pieces beside the next S)
  // spill at 160 a thread.
  static constexpr bool OVERLAP = D > 32;
  static_assert(!SETMAXNREG || PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                (1 + CONSUMERS) * (65536 / NTB / 8 * 8), "register budget");
  static constexpr int FULLS = CONSUMERS, FULL_THREADS = 128 + 128 * CONSUMERS / FULLS;
  static constexpr int FULL = 1, EMPTY = FULL + FULLS * STAGES, QREADY = EMPTY + STAGES;
  static_assert(QREADY + CONSUMERS <= 16, "16 named barriers");
  // Plane j of a stage (K's 0-2, V's 3-5), in elements from the stage:
  // rows 0..TK-1 of a tile, or rows 32..63 (2048 elements on, the same
  // swizzle and column-block stride) for the second plane of a tile.
  static constexpr int STAGE = 6 / PPT * T::TILE;
  static constexpr __device__ int plane(int j) { return j / PPT * T::TILE + j % PPT * TK * 64; }
  // Each consumer's three Q tiles, then the stages.
  static constexpr int KV_OFF = CONSUMERS * 3 * T::TILE * 2;
  static constexpr int BYTES = KV_OFF + STAGES * STAGE * 2 + 1024;
  static_assert(BYTES <= 232448, "shared memory of a block");
};

// x and y as three bf16 pairs (x in the low halves): x0 = bf16(x), x1 =
// bf16(x − x0), x2 = bf16(x − x0 − x1); each residual is exact in f32.
__device__ __forceinline__ void split3(float x, float y, uint32_t& w0, uint32_t& w1,
                                       uint32_t& w2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x, y);
  const float2 r1 = make_float2(x - __low2float(h0), y - __high2float(h0));
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(r1.x, r1.y);
  const __nv_bfloat162 h2 =
      __floats2bfloat162_rn(r1.x - __low2float(h1), r1.y - __high2float(h1));
  w0 = *reinterpret_cast<const uint32_t*>(&h0);
  w1 = *reinterpret_cast<const uint32_t*>(&h1);
  w2 = *reinterpret_cast<const uint32_t*>(&h2);
}

// The split pass: Q (times sm_scale in f32, as scaled_q), K and V, each as
// three bf16 planes of its shape, plane j of a tensor of n elements at
// planes + 3·(the elements before it) + j·n. Eight elements a thread and
// step; reads 4 bytes and writes 6 an element.
__global__ void __launch_bounds__(256) flash_fwd_split_kernel(const float* q, const float* k,
                                                              const float* v,
                                                              __nv_bfloat16* planes, size_t nq,
                                                              size_t nkv, float scale) {
  const size_t chunks = (nq + 2 * nkv) / 8;
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < chunks;
       e += size_t(gridDim.x) * blockDim.x) {
    size_t i = 8 * e, n = nq;
    const float* src = q;
    __nv_bfloat16* dst = planes;
    float s = scale;
    if (i >= nq) {  // K, then V (x·1 is exact)
      i -= nq;
      src = k;
      dst += 3 * nq;
      n = nkv;
      s = 1.f;
      if (i >= nkv) {
        i -= nkv;
        src = v;
        dst += 3 * nkv;
      }
    }
    const float4 lo = *reinterpret_cast<const float4*>(src + i);
    const float4 hi = *reinterpret_cast<const float4*>(src + i + 4);
    const float x[8] = {lo.x * s, lo.y * s, lo.z * s, lo.w * s,
                        hi.x * s, hi.y * s, hi.z * s, hi.w * s};
    uint32_t w[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split3(x[2 * j], x[2 * j + 1], w[0][j], w[1][j], w[2][j]);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint4*>(dst + j * n + i) = make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
  }
}

// D[64 x TK] (+)= A·B, both operands in shared memory (K-major).
template <int TK>
__device__ __forceinline__ void wgmma_ss(float (&d)[TK / 8][4], uint64_t a, uint64_t b) {
  if constexpr (TK == 64) {
    wgmma_m64n64(d, a, b, 1);
  } else {
    wgmma_m64n32(d, a, b, 1);
  }
}

// flash_fwd_bf16_kernel's walk, ring and handoffs, with the three planes
// of Q, K and V (p.q, p.k, p.v: the split pass's first planes; the next
// planes one tensor further on) in place of the bf16 tiles: S is six
// products of a Q plane and a K plane; p is split into three register A
// fragments for six products against the V planes, summed a tile at a
// time from zero (pacc) and added to acc on the CUDA cores, so that the
// tensor cores' rounding of a k16 step never sees the sum of earlier
// tiles. A separate kernel and not a template of the bf16 one: sharing the
// body changed the bf16 instance's code (4 bytes of spill at d=128, 3-5%
// slower at serve_flash's shape on an H100).
template <int D>
__global__ void __launch_bounds__(F32Ring<D>::NTB, 1) flash_fwd_f32_kernel(const Params p) {
  using T = Bf16Tile<D>;
  using R = F32Ring<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + R::KV_OFF);
  const size_t q_plane = size_t(p.B) * p.H * p.Sq * D;
  const size_t kv_plane = size_t(p.B) * p.Hkv * p.Skv * D;

  const int tid = threadIdx.x, wg = tid >> 7, gtid = tid & 127;
  const int heads = p.HC * p.Hkv * p.B;
  const int ntiles = (p.Sq + p.NQ - 1) / p.NQ;
  const int q0 = (ntiles - 1 - int(blockIdx.x / heads)) * p.NQ;  // heaviest first
  const int hc = blockIdx.x % p.HC;
  const int kvh = (blockIdx.x / p.HC) % p.Hkv;
  const int b = (blockIdx.x % heads) / (p.HC * p.Hkv);
  const int q_off = p.offs[2 * b];
  const int kv_off = p.offs[2 * b + 1];
  const int first_q = q_off + q0, last_q = q_off + min(q0 + p.NQ, p.Sq) - 1;
  auto next_tile = [&](int t0) {  // the walk: the key tiles a row of the block can see
    while (t0 < p.Skv && !range_should_run(p, first_q, last_q, kv_off + t0,
                                           kv_off + min(t0 + R::TK, p.Skv) - 1))
      t0 += R::TK;
    return t0;
  };

  if (wg == 0) {
    // Producer: tile n into stage n % STAGES, all six planes.
    if constexpr (R::SETMAXNREG) setmaxnreg_dec<R::PRODUCER_REGS>();
    const size_t kvbase = (size_t(b) * p.Hkv + kvh) * p.Skv * D;
    const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) + kvbase;
    const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) + kvbase;
    auto copy_tile = [&](int t0, int s) {
      __nv_bfloat16* st = ring + s * R::STAGE;
#pragma unroll
      for (int k = 0; k < R::TK * T::CPR / 128; ++k) {
        const int e = gtid + 128 * k, r = e / T::CPR, c = e % T::CPR;
        const bool ok = t0 + r < p.Skv;
        const size_t src = size_t(ok ? t0 + r : 0) * D + 8 * c;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          cp_async16(st + R::plane(j) + sw(r, c), kg + j * kv_plane + src, ok);
          cp_async16(st + R::plane(3 + j) + sw(r, c), vg + j * kv_plane + src, ok);
        }
      }
      cp_async_commit();
    };
    auto hand_over = [&](int s) {
#pragma unroll
      for (int c = 0; c < R::FULLS; ++c) bar_arrive(R::FULL + R::FULLS * s + c, R::FULL_THREADS);
    };
    int n = 0;
    for (int t0 = next_tile(0); t0 < p.Skv; t0 = next_tile(t0 + R::TK), ++n) {
      const int s = n % R::STAGES;
      if (n >= R::STAGES) bar_sync(R::EMPTY + s, R::NTB);
      copy_tile(t0, s);
      if (n >= R::LAG) {
        cp_async_wait<R::LAG>();
        fence_async_shared();
        hand_over((n - R::LAG) % R::STAGES);
      }
    }
    stage_landed();
    for (int j = max(n - R::LAG, 0); j < n; ++j) hand_over(j % R::STAGES);
    for (int j = max(n - R::STAGES, 0); j < n; ++j) bar_sync(R::EMPTY + j % R::STAGES, R::NTB);
    return;
  }

  // Consumers.
  if constexpr (R::SETMAXNREG) setmaxnreg_inc<R::CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem) + cw * 3 * T::TILE;
  // This consumer's 64 rows of Q's three planes (scaled in f32 before the
  // split); rows that do not exist are 0.
  {
    const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q);
    for (int e = gtid; e < 64 * T::CPR; e += 128) {
      const int r = e / T::CPR, c = e % T::CPR;
      const int br = 64 * cw + r;
      const int head = hc * p.GB + br / p.NQ;  // the row's q head in the group
      const bool exists = row_exists(p, hc, q0, br);
      const size_t at = ((size_t(b) * p.H + kvh * p.G + head) * p.Sq + q0 + br % p.NQ) * D + 8 * c;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (exists) raw = *reinterpret_cast<const uint4*>(qg + j * q_plane + at);
        *reinterpret_cast<uint4*>(qs + j * T::TILE + sw(r, c)) = raw;
      }
    }
    fence_async_shared();
    bar_sync(R::QREADY + cw, 128);
  }

  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = q_off + q0 + (64 * cw + 16 * warp + g + 8 * h) % p.NQ;
  const int2 span = row_span(p, hc, q0, q_off, 64 * cw + 16 * warp, 16);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float acc[T::ND][4], pacc[T::ND][4];
  zero(acc);
  zero(pacc);

  // The scaled scores s[n][e] (row g + 8(e >> 1), key 8n + 2t + (e & 1) of
  // the tile) become the f32 p in place, as in the bf16 kernel.
  auto softmax_tile = [&](auto unmasked_tag, auto cap_tag, float (&s)[R::TK / 8][4], int t0,
                          float (&alpha)[2]) {
    constexpr bool UNMASKED = decltype(unmasked_tag)::value;
    constexpr bool CAP = decltype(cap_tag)::value;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < R::TK / 8; ++n)
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
      const float m_log2 = m_next * LOG2E;
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < R::TK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pe = live ? ex2(fmaf(s[n][2 * h + j], LOG2E, -m_log2)) : 0.f;
          ls += pe;
          s[n][2 * h + j] = pe;
        }
      l[h] = alpha[h] * l[h] + ls;
    }
  };

  // S of the tile in stage st: Q plane a against K plane b over D, the
  // small products first, so that the accumulator adds them before the
  // large one; issued.
  float sc[R::TK / 8][4];
  auto scores = [&](int st) {
    const __nv_bfloat16* ks = ring + st * R::STAGE;
    zero(sc);
    wgmma_fence();
    fence_operands(sc);
    auto qk = [&](int qp, int kb) {
#pragma unroll
      for (int kc = 0; kc < T::KC; ++kc)
        wgmma_ss<R::TK>(sc, tile_desc(qs + qp * T::TILE, 0, kc),
                        tile_desc(ks + R::plane(kb), 0, kc));
    };
    qk(2, 0);  // q2·k0: Q's third piece
    qk(1, 1);
    qk(0, 2);  // q0·k2: K's third piece
    qk(1, 0);
    qk(0, 1);
    qk(0, 0);
    wgmma_commit();
  };
  auto softmax = [&](int t0, float (&alpha)[2]) {
    fence_operands(sc);
    const int k_first = kv_off + t0, k_last = kv_off + min(t0 + R::TK, p.Skv) - 1;
    alpha[0] = alpha[1] = 1.f;
    if (span.x <= span.y && range_should_run(p, span.x, span.y, k_first, k_last)) {
      const bool unmasked = range_unmasked(p, span.x, span.y, k_first,
                                           kv_off + t0 + R::TK - 1, t0 + R::TK - 1);
      with_tags(unmasked, p.has_softcap, [&](auto mask_free, auto capped) {
        softmax_tile(mask_free, capped, sc, t0, alpha);
      });
    } else {
      zero(sc);
    }
  };
  // Once the tile before landed: acc += its P·V (pacc), acc times alpha
  // (only when a row's max moved), and p split into the three pieces,
  // ap[piece][kk] (k16 step kk: keys 16kk..16kk+15).
  uint32_t ap[3][R::TK / 16][4];
  auto merge = [&] {
    fence_operands(acc);
    fence_operands(pacc);
#pragma unroll
    for (int c = 0; c < T::ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += pacc[c][e];
  };
  auto merge_rescale_split = [&](const float (&alpha)[2]) {
    merge();
#pragma unroll
    for (int j = 0; j < 3; ++j) fence_operands(ap[j]);
    if (__any_sync(0xffffffffu, (alpha[0] != 1.f) | (alpha[1] != 1.f))) {
#pragma unroll
      for (int c = 0; c < T::ND; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < R::TK / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int nt = 2 * kk + hh;
          split3(sc[nt][2 * r], sc[nt][2 * r + 1], ap[0][kk][2 * hh + r], ap[1][kk][2 * hh + r],
                 ap[2][kk][2 * hh + r]);
        }
  };

  // The walk as in the bf16 kernel: S of tile n + 1 issued before P·V of
  // tile n (with OVERLAP the softmax of n + 1 runs while P·V of n is in
  // flight).
  auto full = [&](int n) {
    bar_sync(R::FULL + R::FULLS * (n % R::STAGES) + cw % R::FULLS, R::FULL_THREADS);
  };
  auto pv = [&](int n) {  // pacc = P·V of tile n, issued
    const __nv_bfloat16* vs = ring + (n % R::STAGES) * R::STAGE;
    zero(pacc);
    wgmma_fence();
    fence_operands(pacc);
    auto pvp = [&](int pa, int vb) {  // P piece pa against V plane vb
#pragma unroll
      for (int kk = 0; kk < R::TK / 16; ++kk)
        wgmma_rs<D>(pacc, ap[pa][kk], tile_desc_mn(vs + R::plane(3 + vb), 16 * kk));
    };
    pvp(2, 0);  // p2·v0: P's third piece
    pvp(1, 1);
    pvp(0, 2);  // p0·v2: V's third piece
    pvp(1, 0);
    pvp(0, 1);
    pvp(0, 0);
    wgmma_commit();
  };
  int t0 = next_tile(0), n = 0;
  if (t0 < p.Skv) {
    float alpha[2];
    full(0);
    scores(0);
    wgmma_wait<0>();
    softmax(t0, alpha);
    merge_rescale_split(alpha);
    for (int tn = next_tile(t0 + R::TK); tn < p.Skv; tn = next_tile(tn + R::TK), ++n) {
      full(n + 1);
      scores((n + 1) % R::STAGES);
      pv(n);
      wgmma_wait<R::OVERLAP>();  // S of tile n + 1 landed
      softmax(tn, alpha);
      wgmma_wait<0>();
      bar_arrive(R::EMPTY + n % R::STAGES, R::NTB);
      merge_rescale_split(alpha);
    }
    pv(n);
    wgmma_wait<0>();
    bar_arrive(R::EMPTY + n % R::STAGES, R::NTB);
    merge();
  }
  fence_operands(acc);

  // Epilogue: o = acc · l_inv in f32; lse = m + log l.
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
    const size_t row =
        (size_t(b) * p.H + kvh * p.G + hc * p.GB + br / p.NQ) * p.Sq + q0 + br % p.NQ;
    const float l_inv = lrow[h] == 0.f ? 1.f : 1.f / lrow[h];
    float* of = reinterpret_cast<float*>(p.o) + row * D;
#pragma unroll
    for (int c = 0; c < T::ND; ++c)
      *reinterpret_cast<float2*>(of + 8 * c + 2 * t) =
          make_float2(acc[c][2 * h] * l_inv, acc[c][2 * h + 1] * l_inv);
    if (p.lse != nullptr && t == 0) p.lse[row] = lrow[h] > 0.f ? m[h] + logf(lrow[h]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// f32 at d=256 (Gemma-2 served in f32): true f32 FMAs on the CUDA cores over
// f32_tile.cuh's tile step. Three planes of a 64 x 256 operand do not fit a
// ring beside Q's (a consumer's 64 x 256 accumulator alone is 128 registers
// a thread), so this route reads f32 straight from the tensors: no split
// pass, no scratch.

// One block of 256 threads per (batch, q head, 64-row q tile): Q, K and V as
// [64][260] f32 tiles and P beside them, 217,088 bytes, so one K stage and
// one V stage. Two cp.async groups a key tile: K's next tile lands while
// P·V runs and V's while the next scores run.
struct F32D256 {
  using T = F32Tile<256>;
  static constexpr int K_OFF = TILE_ROWS * T::ROW;
  static constexpr int V_OFF = K_OFF + TILE_KEYS * T::ROW;
  static constexpr int P_OFF = V_OFF + TILE_KEYS * T::ROW;
  static constexpr int BYTES = (P_OFF + TILE_ROWS * T::PROW) * 4;
  static_assert(BYTES <= 232448, "shared memory of a block");
};

__global__ void __launch_bounds__(TILE_THREADS, 1) flash_fwd_f32_d256_kernel(const Params p) {
  constexpr int D = 256;
  using T = F32Tile<D>;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;
  float* kt = smf + F32D256::K_OFF;
  float* vt = smf + F32D256::V_OFF;
  float* ps = smf + F32D256::P_OFF;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // Heaviest first: the q tile is the grid's slow index, counted from the end.
  const int heads = p.H * p.B;
  const int ntiles = (p.Sq + TILE_ROWS - 1) / TILE_ROWS;
  const int q0 = (ntiles - 1 - int(blockIdx.x / heads)) * TILE_ROWS;
  const int h = blockIdx.x % p.H;
  const int b = (blockIdx.x % heads) / p.H;
  const int q_off = p.offs[2 * b], kv_off = p.offs[2 * b + 1];
  const int first_q = q_off + q0, last_q = q_off + min(q0 + TILE_ROWS, p.Sq) - 1;
  // The walk: the key tiles from t0 on that a row of the block can see.
  auto next_run = [&](int t0) {
    while (t0 < p.Skv && !range_should_run(p, first_q, last_q, kv_off + t0,
                                           kv_off + min(t0 + TILE_KEYS, p.Skv) - 1))
      t0 += TILE_KEYS;
    return t0;
  };
  const size_t kv_base = (size_t(b) * p.Hkv + h / p.G) * p.Skv * D;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;
  // A key tile of src into dst (rows past Skv zero-filled): one group.
  auto issue = [&](const float* src, float* dst, int t0) {
    for (int e = tid; e < TILE_KEYS * (D / 4); e += TILE_THREADS) {
      const int r = e / (D / 4), c = e % (D / 4);
      const bool ok = t0 + r < p.Skv;
      cp_async16(dst + r * T::ROW + 4 * c, src + size_t(ok ? t0 + r : 0) * D + 4 * c, ok);
    }
    cp_async_commit();
  };
  int t0 = next_run(0);
  if (t0 < p.Skv) {
    issue(kg, kt, t0);
    issue(vg, vt, t0);
  }
  // Q rows times sm_scale, one f32 product (the plain version's scaled_q);
  // rows past Sq are 0.
  const float* qg = static_cast<const float*>(p.q) + ((size_t(b) * p.H + h) * p.Sq + q0) * D;
  for (int e = tid; e < TILE_ROWS * (D / 4); e += TILE_THREADS) {
    const int r = e / (D / 4), c = e % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) x = *reinterpret_cast<const float4*>(qg + size_t(r) * D + 4 * c);
    *reinterpret_cast<float4*>(qs + r * T::ROW + 4 * c) =
        make_float4(x.x * p.sm_scale, x.y * p.sm_scale, x.z * p.sm_scale, x.w * p.sm_scale);
  }
  float m[4], lpart[4], acc[4][T::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lpart[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc[i][c] = 0.f;
  }
  auto p_of = [](int, float pe) { return pe; };
  while (t0 < p.Skv) {
    const int tn = next_run(t0 + TILE_KEYS);
    cp_async_wait<1>();  // K of this tile landed (V's may still be in flight)
    __syncthreads();
    auto score = [&](int i, int key, float s) {
      float x = s;
      if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
      const int kloc = t0 + key;
      return pair_valid(p, first_q + ty * 4 + i, kv_off + kloc, kloc) ? x : p.mask_value;
    };
    f32_tile_scores<D>(qs, kt, ps, m, lpart, acc, p.mask_half, score, p_of);
    __syncthreads();  // P is complete and K's tile read
    if (tn < p.Skv) issue(kg, kt, tn);
    else cp_async_commit();  // an empty group keeps the count of the waits
    cp_async_wait<1>();  // V of this tile landed (the next K may be in flight)
    __syncthreads();
    f32_tile_pv<D>(ps, vt, acc);
    __syncthreads();  // V's tile and P read
    if (tn < p.Skv) issue(vg, vt, tn);
    else cp_async_commit();
    t0 = tn;
  }

  // Epilogue: o = acc · l_inv in f32; lse = m + log l.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum16(lpart[i]);
    const int r = ty * 4 + i;
    if (q0 + r >= p.Sq) continue;
    const size_t row = (size_t(b) * p.H + h) * p.Sq + q0 + r;
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    float* of = static_cast<float*>(p.o) + row * D;
#pragma unroll
    for (int c4 = 0; c4 < T::CPT; c4 += 4)  // columns 4tx + 16c4 .. + 3
      *reinterpret_cast<float4*>(of + 4 * tx + 16 * c4) =
          make_float4(acc[i][c4] * l_inv, acc[i][c4 + 1] * l_inv, acc[i][c4 + 2] * l_inv,
                      acc[i][c4 + 3] * l_inv);
    if (p.lse != nullptr && tx == 0) p.lse[row] = l > 0.f ? m[i] + logf(l) : -INFINITY;
  }
}

cudaError_t launch_f32_d256(const Params& p, cudaStream_t stream) {
  constexpr int smem = F32D256::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_d256_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = unsigned((p.Sq + TILE_ROWS - 1) / TILE_ROWS) * p.H * p.B;
  flash_fwd_f32_d256_kernel<<<blocks, TILE_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// One launch of a route's kernel: its blocks fold the GQA group into R's rows.
template <typename R, typename Kernel>
cudaError_t launch_ring(Kernel kernel, Params p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.GB = min(p.G, R::ROWS);
  p.NQ = R::ROWS / p.GB;
  p.HC = (p.G + p.GB - 1) / p.GB;
  const unsigned blocks = unsigned((p.Sq + p.NQ - 1) / p.NQ) * p.HC * p.Hkv * p.B;
  kernel<<<blocks, R::NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  return launch_ring<Bf16Ring<D>>(flash_fwd_bf16_kernel<D>, p, Bf16Ring<D>::BYTES, stream);
}

template <int D>
cudaError_t launch(Params p, void* planes, int bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<D>(p, stream);
  // f32: the split pass, then the walk over the planes.
  const size_t nq = size_t(p.B) * p.H * p.Sq * D, nkv = size_t(p.B) * p.Hkv * p.Skv * D;
  __nv_bfloat16* pl = static_cast<__nv_bfloat16*>(planes);
  const size_t want = ((nq + 2 * nkv) / 8 + 255) / 256;  // a few steps a thread past 16 an SM
  const unsigned blocks = unsigned(want < 132 * 16 ? want : 132 * 16);
  flash_fwd_split_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), pl, nq, nkv, p.sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.q = pl;
  p.k = pl + 3 * nq;
  p.v = pl + 3 * nq + 3 * nkv;
  return launch_ring<F32Ring<D>>(flash_fwd_f32_kernel<D>, p, F32Ring<D>::BYTES, stream);
}

}  // namespace

// planes: the f32 route's scratch, 3·(B·H·Sq + 2·B·Hkv·Skv)·D bf16 (unused
// in bf16 and at d=256). The f32 route launches the split pass and the main
// kernel at d <= 128, one kernel at d=256.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* offs, void* o,
                         void* lse, void* planes, int B, int H, int Hkv, int Sq, int Skv, int D,
                         float sm_scale, int has_softcap, float softcap, int causal, int window,
                         int sinks, float mask_value, float mask_half, int bf16, void* stream) {
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
    case 32: err = launch<32>(p, planes, bf16, s); break;
    case 64: err = launch<64>(p, planes, bf16, s); break;
    case 128: err = launch<128>(p, planes, bf16, s); break;
    case 256: err = bf16 ? launch_bf16<256>(p, s) : launch_f32_d256(p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* qmha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
