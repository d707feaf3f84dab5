// Device code shared by paged_prefill.cu (its f32-q kernel) and flash_fwd.cu
// (its f32 kernel at head_dim 256; at d <= 128 flash_fwd.cu's f32 route
// runs six bf16 wgmma passes instead): one step of the f32 online softmax
// on the CUDA cores over a 64-row x 64-key tile held in shared memory
// (and, through cp_async.cuh, the copies that fill it).
//
// Layout of the tile step: 256 threads; thread (ty, tx) = (tid / 16, tid %
// 16) owns rows 4ty..4ty+3, keys tx + 16j (j < 4) of S, and output columns
// tx*VW + 16*VW*nv + w of its four rows. Products are true f32 FMAs (not
// TF32) over float4 shared-memory reads; P goes through shared memory to
// the P·V loop. The step is two halves, f32_tile_scores (S, the softmax,
// P) and f32_tile_pv (acc += P·V), so that paged_prefill.cu can land V in
// K's tile between them (d=256: three f32 tiles and P take 217 KB).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr int TILE_ROWS = 64;      // q rows of a tile step
constexpr int TILE_KEYS = 64;      // keys of a tile step
constexpr int TILE_THREADS = 256;  // threads that run it

// Reductions over the 16 threads (tx) of one row.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
struct F32Tile {
  static constexpr int ROW = D + 4;             // floats per padded q/K/V row
  static constexpr int PROW = TILE_KEYS + 4;    // floats per P row
  static constexpr int CPT = D / 16;            // output columns a thread
  static constexpr int VW = CPT < 4 ? CPT : 4;  // their vector width
  static constexpr int NV = CPT / VW;
  using Vec = typename VecF<VW>::T;
};

// The score half of a tile step. qs: [64][ROW] q rows, already scaled;
// kt: [64][ROW] f32 K of the tile; ps: [64][PROW] P, written here. m, lpart
// and acc are this thread's running max, partial P sum and output (acc is
// rescaled here). score(i, key, s) turns the raw dot s of row i and tile
// key `key` into the (softcapped, masked) score; p_of(key, pe) is what P·V
// takes for key's probability pe. Rows whose running max is still the mask
// value (<= mask_half) get p = 0; l sums the f32 p. The caller syncs the
// block before P is read (f32_tile_pv) or kt is written again.
template <int D, typename Score, typename POf>
__device__ __forceinline__ void f32_tile_scores(const float* qs, const float* kt, float* ps,
                                                float (&m)[4], float (&lpart)[4],
                                                float (&acc)[4][D / 16], float mask_half,
                                                Score score, POf p_of) {
  using T = F32Tile<D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 a[4], bk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * T::ROW + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bk[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * T::ROW + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = score(i, tx + 16 * j, s[i][j]);
      s[i][j] = x;
      mt = fmaxf(mt, x);
    }
    const float m_next = fmaxf(m[i], row_max16(mt));
    const float alpha = expf(m[i] - m_next);
    const bool live = m_next > mask_half;
    m[i] = m_next;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx + 16 * j;
      const float pe = live ? expf(s[i][j] - m_next) : 0.f;
      ls += pe;
      ps[(ty * 4 + i) * T::PROW + key] = p_of(key, pe);
    }
    lpart[i] = alpha * lpart[i] + ls;
#pragma unroll
    for (int c = 0; c < T::CPT; ++c) acc[i][c] *= alpha;
  }
}

// The P·V half: acc += P·V over the tile's 64 keys. ps: the complete P
// tile; vt: [64][ROW] f32 V of the tile.
template <int D>
__device__ __forceinline__ void f32_tile_pv(const float* ps, const float* vt,
                                            float (&acc)[4][D / 16]) {
  using T = F32Tile<D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int k = 0; k < TILE_KEYS; k += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * T::PROW + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pk[i] = kk == 0 ? pr[i].x : kk == 1 ? pr[i].y : kk == 2 ? pr[i].z : pr[i].w;
#pragma unroll
      for (int nv = 0; nv < T::NV; ++nv) {
        const typename T::Vec vv =
            *reinterpret_cast<const typename T::Vec*>(vt + (k + kk) * T::ROW + tx * T::VW + 16 * T::VW * nv);
        const float* vf = reinterpret_cast<const float*>(&vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int w = 0; w < T::VW; ++w)
            acc[i][nv * T::VW + w] = fmaf(pk[i], vf[w], acc[i][nv * T::VW + w]);
      }
    }
  }
}

}  // namespace
