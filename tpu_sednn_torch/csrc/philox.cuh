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
//
// A kernel either draws those bits itself (MaskSpec mode 2) or reads them
// from a table that one launch drew before (mode 3: bit b of word w of a row
// is the keep of column 32 w + b; columns at or past the width read 0).  Who
// draws which way:
// * the chunk trainers' input mask (resident_chunk.cu:train_chunk, and the
//   data-parallel loop of ops/resident_chunk.py at a rank's rows): one
//   launch of input_mask_bits_kernel draws a call's tables, one a tile, and
//   the layer-0 forward and backward of each tile (dp_chunk_forward and the
//   gradient-out backward in the data-parallel form) read its table (mode
//   3): the bits are drawn once a call, not once in every column tile of x
//   that the forward's blocks load and every split of the backward's
//   stripes;
// * every hidden layer's mask: in the epilogue of the forward that writes
//   the activation (mode 2), which already draws each element once;
// * the standalone wrappers given a (key, omit) mask (fused_linear_act,
//   fused_bwd_update, fused_bwd_grad_out), dropout_mask.cu and the probe:
//   mode 2.

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
// generate with Philox from (key, row0 + row, col).  mode 3: read the keep
// bits from the packed table `bits` (ld words a row, ceil(cols / 32); row0
// unused: the pointer is at the operand's first row).  Kept elements are
// multiplied by `scale` (1 in parity mode, 1/(1-omit) in inverted mode).
struct MaskSpec {
  int mode;
  const float* ptr;
  const uint32_t* bits;
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
  s.bits = nullptr;
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

// The packed table of a (rows, cols) operand's keep bits: `words` per row.
__host__ __device__ inline MaskSpec table_mask(const uint32_t* bits, int words, float scale) {
  MaskSpec s = no_mask();
  s.mode = 3;
  s.bits = bits;
  s.ld = words;
  s.scale = scale;
  return s;
}

// Words a row of a packed keep-bit table of `cols` columns holds.
__host__ __device__ inline int mask_words(int cols) { return (cols + 31) / 32; }

// The keep bits of columns col..col+3 of `row` under a Philox mask (mode 2's
// decision): bit j for column col + j, 0 at or past ncols.
__device__ inline unsigned philox_keep4(uint32_t key, uint32_t threshold, int row, int col,
                                        int ncols) {
  uint32_t w[4];
  philox4x32_10((uint32_t)(col >> 2), (uint32_t)row, 0u, 0u, key, 0u, w);
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) keep |= (w[j] >= threshold && col + j < ncols) ? 1u << j : 0u;
  return keep;
}

// Mode 3: the table word holding columns col..col+3 of `row`.  A kernel loads
// the words early with this (with its operand, or a step ahead) and applies
// them with mask4_word, so that the load's latency hides behind other work:
// read where it is used, the table cost the forwards as much as the Philox
// draw it replaces (PERF.md).
__device__ inline uint32_t mask_word(const MaskSpec& s, int row, int col) {
  return __ldg(s.bits + (long long)row * s.ld + (col >> 5));
}

// Mode 3's factors for columns col..col+3 (col a multiple of 4: the 4 bits lie
// in one word) from `word`, the table word that holds them.
__device__ inline void mask4_word(const MaskSpec& s, uint32_t word, int col, int ncols,
                                  float m[4]) {
  word >>= col & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = ((word >> j) & 1u) && col + j < ncols ? s.scale : 0.0f;
}

// Factors for columns col..col+3 of `row` (col a multiple of 4): 0 or scale.
// Columns at or past ncols get 0.  Only called when s.mode is 1 or 2: the
// kernels that take a table (the layer-0 forwards and the backward) read it
// through mask_word and mask4_word.
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
