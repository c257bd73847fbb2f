// Standalone dropout mask for Hopper (sm_90a).
//
// Replaces tpu_sednn/ops/dropout_pallas.py:_mask_kernel (dropout_mask_pallas):
// a (B, D) float32 0/1 mask with P(0) = omit, from one integer seed.  Kept
// from the TPU kernel: the threshold min(floor(omit * 2^32), 2^32 - 1) on 32
// random bits, and one stream per block of 512 rows seeded `seed + block`, so
// the mask of rows 512.. under seed s is the mask of rows 0.. under s + 1.
// Not kept: its padding to (8, 128) tiles; any B and D.  The bits are
// Philox4x32-10 (philox.cuh:mask4, the device function of the chunk trainer's
// masks), key = seed + block, counter = (col / 4, row within the block);
// ops/dropout_mask.py:dropout_mask_reference draws the same bits.  It is not
// the chunk trainer's stream: key formula and row origin differ.
//
// Bound: bytes, the mask written once (128 x 3084 x 4 B = 1.6 MB, 0.0005 ms
// at 3.35 TB/s): at the shapes a step asks for the launch itself is the cost.

#include "philox.cuh"

using namespace sednn;

namespace {

constexpr int kRowBlock = 512;

__global__ void __launch_bounds__(256)
dropout_mask_kernel(float* __restrict__ out, int rows, int cols, uint32_t seed,
                    uint32_t threshold) {
  const int c4 = (cols + 3) / 4;
  const long long n = (long long)rows * c4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / c4), col = (int)(i % c4) * 4;
    const int blk = row / kRowBlock;
    float m[4];
    mask4(philox_mask(seed + (uint32_t)blk, threshold, 1.0f), row - blk * kRowBlock, col, cols, m);
    for (int j = 0; j < 4 && col + j < cols; ++j) out[(long long)row * cols + col + j] = m[j];
  }
}

}  // namespace

// out (rows, cols) float32 = 1 where the element's bits >= threshold, else 0.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int philox_dropout_mask_f32(float* out, int rows, int cols, unsigned seed,
                                       unsigned threshold, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n = (long long)rows * ((cols + 3) / 4);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dropout_mask_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, rows, cols, seed, threshold);
  return (int)cudaGetLastError();
}
