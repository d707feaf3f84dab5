// Nibble unpacking shared by the INT4 paths of paged_decode.cu and
// paged_prefill.cu. A packed K/V row of head_dim D holds D/2 bytes: byte j
// carries element j in its low nibble and element j + D/2 in its high
// nibble, both signed 4-bit values in [-7, 7] (ops/quantize.py:
// pack_int4_halves).

#pragma once

#include <cuda_runtime.h>

namespace {

// `b` is the packed byte sign-extended to int (static_cast<signed char>).
__device__ __forceinline__ int int4_lo(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int int4_hi(int b) { return b >> 4; }

// Byte c (0-3) of a 32-bit word of packed bytes, sign-extended.
__device__ __forceinline__ int packed_byte(int word, int c) {
  return static_cast<signed char>((word >> (8 * c)) & 0xff);
}

}  // namespace
