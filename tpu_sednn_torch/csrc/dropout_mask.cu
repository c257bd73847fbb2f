// Standalone dropout masks for Hopper (sm_90a), a batch of them a launch.
//
// Replaces tpu_sednn/ops/dropout_pallas.py:_mask_kernel (dropout_mask_pallas):
// a (B, D) float32 0/1 mask with P(0) = omit, from one integer seed.  Kept
// from the TPU kernel: the threshold min(floor(omit * 2^32), 2^32 - 1) on 32
// random bits, and one stream per block of 512 rows seeded `seed + block`, so
// the mask of rows 512.. under seed s is the mask of rows 0.. under s + 1.
// Not kept: its padding to (8, 128) tiles; any B and D.  The bits are
// Philox4x32-10 (philox.cuh:mask4, the device function of the chunk trainer's
// masks): element (r, c) of a mask whose rows start at global row row0 is, at
// g = row0 + r, word c % 4 of the call with key seed + g / 512 and counter
// (c / 4, g % 512); ops/dropout_mask.py:dropout_mask_reference draws the same
// bits.  With row0 = 0 that is the whole mask a seed keys; with row0 > 0 it is
// rows row0.. of it (a data-parallel rank's rows).  It is not the chunk
// trainer's stream: key formula and row origin differ.
//
// Bound: bytes, each mask written once.  One 16 kHz bunch's four masks
// (128 x 3084 and 3 x 128 x 2048 floats, 4.7 MB) take 0.0014 ms at 3.35 TB/s,
// half a launch's fixed cost (about 2.8 us on an H100); their 295,296
// Philox calls of 40 integer multiplies take 0.0007 ms at 16.75 T/s.  So one
// launch draws a BATCH of masks (a bunch's layers, a group of bunches, a rank's
// rows of them): the launch takes a table of up to kMaxMasks descriptors by
// value, and its grid covers the sum of their Philox calls, each mask starting
// at a block of its own (a prefix table of first blocks, which a block
// searches for its descriptor); a thread makes two calls, or eight for a
// batch of eight full waves or more (philox_dropout_masks_f32).  Every Philox call
// gives four columns, stored as one 16-byte vector where the row pitch allows
// it (D a multiple of 4; masks start 16-byte aligned in the output), else
// element by element.  A group of 8 such bunches (37.8 MB, 0.0113 ms) is a
// pure write stream of four times a launch's fixed cost.

#include <limits.h>

#include "philox.cuh"

using namespace sednn;

namespace {

constexpr int kRowBlock = 512;
constexpr int kThreads = 256;
constexpr int kMaxMasks = 64;  // ops/dropout_mask.py:MAX_MASKS
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks an SM holds

// A batch of masks, passed by value (2 KB of the 4 KB a kernel's parameters
// may hold).  Mask i covers blocks block0[i] .. block0[i + 1] - 1, each block
// kThreads x CPT Philox calls, and starts at float offset[i] of the output (a
// multiple of 4).
struct MaskBatch {
  int n;
  int block0[kMaxMasks + 1];
  long long offset[kMaxMasks];
  int rows[kMaxMasks], cols[kMaxMasks], row0[kMaxMasks];
  uint32_t seed[kMaxMasks], threshold[kMaxMasks];
};

// CPT Philox calls a thread, kThreads apart in the mask's row-major order of
// calls (a warp stores 512 contiguous bytes a step): the descriptor search and
// the division that finds a thread's first (row, column) are paid once for CPT
// calls.
template <int CPT>
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(float* __restrict__ out, const __grid_constant__ MaskBatch b) {
  // this block's mask: the last i with block0[i] <= blockIdx.x
  int lo = 0, hi = b.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.block0[mid] <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const int cols = b.cols[lo], c4 = (cols + 3) >> 2, calls = b.rows[lo] * c4;
  int call = ((int)blockIdx.x - b.block0[lo]) * (kThreads * CPT) + (int)threadIdx.x;
  if (call >= calls) return;
  int r = call / c4, c = call - r * c4;  // the call's row and column group
  const int dr = kThreads / c4, dc = kThreads - dr * c4;  // a step of kThreads calls
  const MaskSpec base = philox_mask(b.seed[lo], b.threshold[lo], 1.0f);
  const int row0 = b.row0[lo];
  float* const mask = out + b.offset[lo];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    if (call < calls) {
      const int g = row0 + r;  // the global row
      MaskSpec s = base;
      s.key += (uint32_t)(g / kRowBlock);
      float m[4];
      mask4(s, g % kRowBlock, c * 4, cols, m);
      float* dst = mask + (long long)r * cols + c * 4;
      if ((cols & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
      } else {
        for (int j = 0; j < 4 && c * 4 + j < cols; ++j) dst[j] = m[j];
      }
    }
    call += kThreads;
    r += dr;
    c += dc;
    if (c >= c4) {
      c -= c4;
      ++r;
    }
  }
}

template <int CPT>
int launch(float* out, MaskBatch& b, const long long* calls, cudaStream_t stream) {
  long long blocks = 0;
  for (int i = 0; i < b.n; ++i) {
    b.block0[i] = (int)blocks;
    blocks += (calls[i] + kThreads * CPT - 1) / (kThreads * CPT);
  }
  b.block0[b.n] = (int)blocks;
  dropout_mask_kernel<CPT><<<(unsigned)blocks, kThreads, 0, stream>>>(out, b);
  return (int)cudaGetLastError();
}

}  // namespace

// n masks (1 <= n <= kMaxMasks, each rows[i] > 0 and cols[i] > 0) into `out`
// with one launch: mask i (rows[i], cols[i]) float32 at out + offsets[i] (a
// multiple of 4 floats), 1 where the bits of its element at global row
// row0s[i] + r under seeds[i] are >= thresholds[i], else 0.  A thread makes
// eight Philox calls where that still leaves a full wave of resident blocks
// on the card, else two: a group of 8 16 kHz bunches eight, one bunch's four
// masks two (on an H100, 0.016 and 0.0042 ms; one call a thread took 0.0222
// ms for the group and the same 0.0042 ms for the bunch).  Launches on
// `stream`, does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a batch it does not take.
extern "C" int philox_dropout_masks_f32(float* out, int n, const long long* offsets,
                                        const int* rows, const int* cols, const int* row0s,
                                        const unsigned* seeds, const unsigned* thresholds,
                                        void* stream) {
  if (n < 1 || n > kMaxMasks) return (int)cudaErrorInvalidValue;
  MaskBatch b;
  b.n = n;
  long long calls[kMaxMasks], total = 0;
  for (int i = 0; i < n; ++i) {
    calls[i] = (long long)rows[i] * (((long long)cols[i] + 3) / 4);
    if (rows[i] <= 0 || cols[i] <= 0 || row0s[i] < 0 || (offsets[i] & 3) != 0
        || calls[i] > INT_MAX - 8 * kThreads || (long long)row0s[i] + rows[i] > INT_MAX)
      return (int)cudaErrorInvalidValue;
    total += calls[i];
    b.offset[i] = offsets[i];
    b.rows[i] = rows[i];
    b.cols[i] = cols[i];
    b.row0[i] = row0s[i];
    b.seed[i] = seeds[i];
    b.threshold[i] = thresholds[i];
  }
  if (total / kThreads + n > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long wave = (long long)sms * kBlocksPerSm * kThreads;  // calls, one a thread
  const cudaStream_t s = (cudaStream_t)stream;
  return total >= 8 * wave ? launch<8>(out, b, calls, s) : launch<2>(out, b, calls, s);
}
