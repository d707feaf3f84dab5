// The bf16 tensor-core PTX of the port's kernels (flash_fwd.cu,
// flash_bwd.cu, flash_int8_fwd.cu, paged_prefill.cu): mma.sync m16n8k16
// with f32 accumulation and the ldmatrix loads of its operands from shared
// memory, and the warpgroup wgmma of Hopper with the swizzled shared-memory
// tiles it reads (flash_bwd.cu, paged_prefill.cu, flash_fwd.cu).
//
// Fragments of m16n8k16 (lane = 4g + t, g = lane / 4, t = lane % 4; two
// bf16 a register, the lower column or k in the low half):
//   A [16][16] row-major: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//     a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..).
//   B [16][8] (k x n), "col": b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g).
//   C [16][8] f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, the same).
// So the C fragments of two neighbouring n-tiles, rounded to bf16 in pairs,
// are the A fragment of one k16 step of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

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

// wgmma (sm_90a): a warpgroup (4 warps, 128 threads) computes D[64 x N]
// (+)= A[64 x 16] · B[16 x N] with A and B in shared memory, both K-major
// (rows of A and of Bᵀ contiguous along k), each named by a descriptor. The
// accumulator of warp w of the group is the m16n8 C fragment of rows
// 16w..16w+15 for each n8 tile j: d[j][0..3] as c0..c3 above, so it feeds
// pack-to-A like an mma.sync accumulator. The ops run asynchronously:
// wgmma_fence before the first, commit, wait, then fence_operands on the
// accumulators before reading them.

// Descriptor of a K-major operand in 128-byte-swizzled shared memory: rows
// of 64 bf16 (128 bytes), 8-row atoms of 1024 bytes (1024-byte aligned,
// stride 1024), 16-byte chunk c of row r stored at chunk c ^ (r % 8).
// `at` is the operand's first row at its k16 step (a 32-byte step within
// the row).
__device__ __forceinline__ uint64_t sw128_desc(const void* at) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(at));
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's committed wgmma groups are in
// flight (groups complete in the order committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; then a barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins accumulator registers at this point of the program (after a wait,
// before the first wgmma), so that no read or write moves across it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// The same for register A fragments (before they are written anew).
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// D[64 x 32] (+)= A·B: accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A·B: accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Descriptor of an MN-major operand (B of a product whose k index runs
// over the rows of a tile, its n index along them) in the same swizzled
// layout: 8-row atoms 1024 bytes apart along k, 64-column blocks
// `block_bytes` apart along n. `at` is the operand's first k row (a
// multiple of 8).
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* at, uint32_t block_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(at));
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t(block_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// D[64 x 32] (+)= A·B with A from registers (each warp's m16n8k16 A
// fragment of its 16 rows) and B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[4][4], const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A·B with A from registers (each warp's m16n8k16 A
// fragment of its 16 rows) and B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A·B with A from registers (each warp's m16n8k16 A
// fragment of its 16 rows) and B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[16][4], const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Shared-memory tiles of wgmma operands: [64 rows][D] bf16 in the K-major
// layout with the 128-byte swizzle: D in blocks of 64 columns
// ([block][64][64], 8 KB each, 1024-byte aligned; d=32 fills half of one
// block), 16-byte chunk c of row r stored at chunk c ^ (r % 8) of its
// 128-byte row. wgmma reads the tiles through descriptors, K-major
// (tile_desc) or MN-major (tile_desc_mn).
constexpr int SW_ROWS = 64;  // rows of a tile

template <int D>
struct Bf16Tile {
  static constexpr int BLOCKS = D < 64 ? 1 : D / 64;  // 64-column blocks
  static constexpr int TILE = BLOCKS * SW_ROWS * 64; // bf16 per tile
  static constexpr int CPR = D / 8;                  // 16-byte chunks a row
  static constexpr int KC = D / 16;                  // k16 steps over D
  static constexpr int ND = D / 8;                   // n8 tiles of a D-wide accumulator
};

// Element offset of 16-byte chunk c of row r in a tile.
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 3) * (SW_ROWS * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Descriptor of the K-major wgmma operand made of rows r0.. (r0 a multiple
// of 8) of a tile, at k16 step kc.
__device__ __forceinline__ uint64_t tile_desc(const __nv_bfloat16* tile, int r0, int kc) {
  return sw128_desc(tile + (kc >> 2) * (SW_ROWS * 64) + r0 * 64 + (kc & 3) * 16);
}

// Descriptor of the MN-major wgmma B operand made of tile rows r0..r0+15
// (its k) by all D columns (its n).
__device__ __forceinline__ uint64_t tile_desc_mn(const __nv_bfloat16* tile, int r0) {
  return sw128_desc_mn(tile + r0 * 64, SW_ROWS * 64 * 2);
}

// The dynamic shared memory from its first 1024-byte boundary (the swizzle
// atoms must be aligned; the launch asks for 1 KB more).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Every copy of this thread landed and is visible to wgmma's reads.
__device__ __forceinline__ void stage_landed() {
  cp_async_wait_all();
  fence_async_shared();
}

// The warpgroup's acc[64 x D] += x · m over one k16 step: x the A
// fragments of its warps (m16n8k16 A fragments of their 16 rows), m a
// tile's 16 rows through tile_desc_mn.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                         uint64_t m) {
  if constexpr (D == 128) {
    wgmma_rs_m64n128(acc, a, m, 1);
  } else if constexpr (D == 64) {
    wgmma_rs_m64n64(acc, a, m, 1);
  } else {
    wgmma_rs_m64n32(acc, a, m, 1);
  }
}

// Warp specialisation (flash_fwd.cu, paged_prefill.cu): named barriers
// (0 is __syncthreads) between producer and consumer warpgroups, and the
// register budget a warpgroup gives up or takes.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// 2^x on the SFU (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// f(unmasked tag, softcap tag): two per-element choices made compile-time
// (a runtime branch inside a fully unrolled per-element loop is
// if-converted: both sides run for every element).
template <typename F>
__device__ __forceinline__ void with_tags(bool unmasked, bool capped, F&& f) {
  if (unmasked) {
    if (capped) {
      f(std::true_type{}, std::true_type{});
    } else {
      f(std::true_type{}, std::false_type{});
    }
  } else if (capped) {
    f(std::false_type{}, std::true_type{});
  } else {
    f(std::false_type{}, std::false_type{});
  }
}

}  // namespace
