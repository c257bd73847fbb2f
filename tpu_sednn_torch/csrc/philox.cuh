// Philox4x32-10 and the dropout-mask device function of the chunk trainer
// (the standalone mask of dropout_mask.cu draws through it too; sr_round.cuh
// takes its stochastic-rounding bits from the same generator).
//
// Replaces the TPU's in-kernel hardware PRNG of
// tpu_sednn/ops/resident_chunk.py:_resident_kernel (:307-331) and the probe
// kernel of sample_resident_masks (:970).  The mask of element (row, col) of
// the GLOBAL bunch under a 32-bit key is
//
//   bits = philox4x32_10(counter = (col / 4, row, 0, 0), key = (key, 0))[col % 4]
//   keep = bits >= threshold,   threshold = floor(omit * 2^32)
//
// so it is a pure function of (key, row, col): tiling, launch geometry and
// the number of devices cannot change it.  One call yields the four words of
// four neighbouring columns, which is what a thread's float4 holds.
// tpu_sednn_torch/ops/philox.py is the bit-equal plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sednn {

__host__ __device__ inline void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
    c0 = n0;
    c2 = n2;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// How a kernel masks a (rows, cols) operand.  mode 0: no mask.  mode 1: read
// 0/1 floats from ptr (row stride ld) — the explicit-mask tests.  mode 2:
// generate with Philox from (key, row0 + row, col).  Kept elements are
// multiplied by `scale` (1 in parity mode, 1/(1-omit) in inverted mode).
struct MaskSpec {
  int mode;
  const float* ptr;
  int ld;
  uint32_t key;
  uint32_t threshold;
  int row0;
  float scale;
};

__host__ __device__ inline MaskSpec no_mask() {
  MaskSpec s;
  s.mode = 0;
  s.ptr = nullptr;
  s.ld = 0;
  s.key = 0;
  s.threshold = 0;
  s.row0 = 0;
  s.scale = 1.0f;
  return s;
}

__host__ __device__ inline MaskSpec philox_mask(uint32_t key, uint32_t threshold, float scale, int row0 = 0) {
  MaskSpec s = no_mask();
  s.mode = 2;
  s.key = key;
  s.threshold = threshold;
  s.scale = scale;
  s.row0 = row0;
  return s;
}

// Factors for columns col..col+3 of `row` (col a multiple of 4): 0 or scale.
// Columns at or past ncols get 0.  Only called when s.mode != 0.
__device__ inline void mask4(const MaskSpec& s, int row, int col, int ncols, float m[4]) {
  if (s.mode == 2) {
    uint32_t w[4];
    philox4x32_10((uint32_t)(col >> 2), (uint32_t)(s.row0 + row), 0u, 0u, s.key, 0u, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = (w[j] >= s.threshold && col + j < ncols) ? s.scale : 0.0f;
  } else {
    const float* p = s.ptr + (long long)row * s.ld + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = (col + j < ncols) ? p[j] * s.scale : 0.0f;
  }
}

}  // namespace sednn
