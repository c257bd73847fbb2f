// Stochastic rounding of float32 to bfloat16 and its random bits.
//
// Replaces pltpu.stochastic_round as tpu_sednn/ops/sr_update.py:_sr_kernel
// and tpu_sednn/ops/resident_chunk.py:_resident_kernel (:479-501) use it.
// Hopper has no stochastic-rounding convert, so it is built the way that
// package's own emulation builds it (resident_chunk.py:_sr_to_bf16): add 16
// random bits to the low half of the float32 bit pattern and drop the low
// half.  The value moves away from zero with probability (dropped fraction),
// so the rounding is unbiased; a carry out of the mantissa runs into the
// exponent, which is the next binade's first value (or Inf above the largest
// finite one), as rounding up should give.  A value that bfloat16 holds
// exactly has a zero low half and comes back unchanged whatever the bits.
// Inf and NaN pass through: their top half is kept, and a NaN whose payload
// lay only in the low half gets the quiet bit so that it stays a NaN.
//
// The bits of element (row, col) under a 32-bit stream key are
//
//   word = philox4x32_10(counter = (col / 4, row, 0, 0), key = (key, kSrTag))[col % 4]
//   delta draw = word & 0xFFFF,   weight draw = word >> 16
//
// two independent 16-bit draws from one word; kSrTag in the second key word
// keeps the stream apart from every dropout stream (their second key word is
// 0).  tpu_sednn_torch/ops/philox.py (sr_bits, sr_to_bf16_reference) is the
// bit-equal plain version.
//
// bfloat16 is storage only (vec4.cuh): widened to float32 in registers and
// narrowed by sr_bf16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "vec4.cuh"

namespace sednn {

constexpr uint32_t kSrTag = 0x53524E44u;  // "SRND"
constexpr int kSrDeltaShift = 0, kSrWeightShift = 16;

__device__ inline bf16_t sr_bf16(float v, uint32_t bits16) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7F800000u) == 0x7F800000u) {
    bf16_t h = (bf16_t)(u >> 16);
    if ((u & 0x007FFFFFu) != 0u) h |= 0x0040u;
    return h;
  }
  return (bf16_t)((u + (bits16 & 0xFFFFu)) >> 16);
}

// The words of columns col..col+3 of `row` (col a multiple of 4).
__device__ inline void sr_bits4(uint32_t key, int row, int col, uint32_t w[4]) {
  philox4x32_10((uint32_t)(col >> 2), (uint32_t)row, 0u, 0u, key, kSrTag, w);
}

// Store v[0..3] to float32 storage as they are, or to bfloat16 storage
// rounded with the 16 bits at `shift` of each word.
__device__ inline void st4_sr(float* __restrict__ p, int row, int col, int ld, int nrows,
                              int ncols, bool vec, const float v[4], const uint32_t*, int) {
  st4(p, row, col, ld, nrows, ncols, vec, make_float4(v[0], v[1], v[2], v[3]));
}

__device__ inline void st4_sr(bf16_t* __restrict__ p, int row, int col, int ld, int nrows,
                              int ncols, bool vec, const float v[4], const uint32_t w[4],
                              int shift) {
  bf16_t h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = sr_bf16(v[j], w[j] >> shift);
  st4(p, row, col, ld, nrows, ncols, vec, h);
}

}  // namespace sednn
