// Framed, windowed real DFT -> log-power spectrum (LPS), for Hopper (sm_90a).
//
// Replaces tpu_sednn/ops/stft_pallas.py:_stft_kernel (the Pallas TPU kernel
// behind stft_lps_pallas, which featurizes wavs in tools/make_pfile.py).
//
//   out[b, f, k] = log(max(re*re + im*im, 1e-12))
//   re = sum_t x[b, f*hop + t] * C[t, k],   im = sum_t x[b, f*hop + t] * S[t, k]
//
// C and S are dsp/stft.py:_rdft_matrices (window folded in), (win, n_bins)
// row-major.
//
// Bound: 4*win*n_bins FLOP per frame against 4*(hop + n_bins) bytes of
// signal in and LPS out, ~250 FLOP/byte at 8 kHz: fp32-FMA-bound on an
// H100 at the serving shapes (64 x 64 s at 8 kHz: 33.8 GFLOP, ~0.5 ms at
// 67 TFLOP/s against ~0.08 ms for its 263 MB).  Tensor cores (TF32, wgmma)
// would change the numerics and are later work.
//
// Design.  The TPU kernel needed win == 2*hop and hop % 128 == 0 and fell
// back to XLA otherwise; this one takes any hop and any win.  One block per
// (utterance, tile of up to 64 frames), on a flat grid with no batch limit,
// stages the tile's samples in shared memory once: overlapping frames share
// samples and every bin reuses them.
// Each warp owns 96 bins (three per lane, 32 apart) and 16 frames of the
// tile and keeps their 96 re/im sums in registers, so each C[t,k], S[t,k]
// read (coalesced across lanes, L1/L2-resident) feeds 32 FMAs and each
// shared-memory sample read, a broadcast to the warp, feeds 6.  When
// hop % 4 == 0 the samples are read four at a time (float4), and the last
// win % 4 one at a time; otherwise all one at a time.  Measured on
// an H100 against 1 and 2 bins per lane and 8 or 32 frames per warp, this
// blocking was the fastest at 8 kHz, 16 kHz and 11025 Hz; the sample reads,
// not the C/S reads, limited the narrower ones.  fp32 FMA throughout; the
// epilogue uses logf, not __logf, and the build has no --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // 4 warps
constexpr int kFramesPerWarp = 16;   // register-blocked frames per lane
constexpr int kBinsPerLane = 3;      // bins lane, lane + 32, lane + 64 of a 96-bin chunk
constexpr int kMaxGroups = 4;        // frame groups per block: 64 frames

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
stft_lps_kernel(const float* __restrict__ x, long long n_samples,
                const float* __restrict__ cosm, const float* __restrict__ sinm,
                float* __restrict__ out, int n_frames, int n_bins, int win,
                int hop, int n_groups, int n_tiles) {
  extern __shared__ __align__(16) float sig[];
  const long long b = blockIdx.x / n_tiles;
  const int frames_per_block = n_groups * kFramesPerWarp;
  const int f0 = (blockIdx.x % n_tiles) * frames_per_block;
  const long long s0 = (long long)f0 * hop;
  const int span = (frames_per_block - 1) * hop + win;
  const float* xb = x + b * n_samples;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long s = s0 + i;
    sig[i] = s < n_samples ? xb[s] : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kChunk = 32 * kBinsPerLane;
  const int n_chunks = (n_bins + kChunk - 1) / kChunk;
  for (int item = warp; item < n_groups * n_chunks; item += kThreads / 32) {
    const int fl = (item / n_chunks) * kFramesPerWarp;  // first local frame
    if (f0 + fl >= n_frames) continue;                   // warp-uniform
    const int k0 = (item % n_chunks) * kChunk + lane;
    int kc[kBinsPerLane];  // idle lanes read a valid column and store nothing
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) kc[j] = min(k0 + 32 * j, n_bins - 1);
    float re[kFramesPerWarp][kBinsPerLane], im[kFramesPerWarp][kBinsPerLane];
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kBinsPerLane; ++j) re[i][j] = im[i][j] = 0.0f;
    const float* base = sig + fl * hop;
    int t = 0;
    if (kVec) {
      for (; t + 4 <= win; t += 4) {
        float c[4][kBinsPerLane], s[4][kBinsPerLane];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < kBinsPerLane; ++j) {
            c[q][j] = __ldg(cosm + (t + q) * n_bins + kc[j]);
            s[q][j] = __ldg(sinm + (t + q) * n_bins + kc[j]);
          }
#pragma unroll
        for (int i = 0; i < kFramesPerWarp; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(base + i * hop + t);
#pragma unroll
          for (int j = 0; j < kBinsPerLane; ++j) {
            re[i][j] = fmaf(v.x, c[0][j], re[i][j]);
            im[i][j] = fmaf(v.x, s[0][j], im[i][j]);
            re[i][j] = fmaf(v.y, c[1][j], re[i][j]);
            im[i][j] = fmaf(v.y, s[1][j], im[i][j]);
            re[i][j] = fmaf(v.z, c[2][j], re[i][j]);
            im[i][j] = fmaf(v.z, s[2][j], im[i][j]);
            re[i][j] = fmaf(v.w, c[3][j], re[i][j]);
            im[i][j] = fmaf(v.w, s[3][j], im[i][j]);
          }
        }
      }
    }
    for (; t < win; ++t) {  // all of win when !kVec, else its last win % 4
      float c[kBinsPerLane], s[kBinsPerLane];
#pragma unroll
      for (int j = 0; j < kBinsPerLane; ++j) {
        c[j] = __ldg(cosm + t * n_bins + kc[j]);
        s[j] = __ldg(sinm + t * n_bins + kc[j]);
      }
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        const float v = base[i * hop + t];
#pragma unroll
        for (int j = 0; j < kBinsPerLane; ++j) {
          re[i][j] = fmaf(v, c[j], re[i][j]);
          im[i][j] = fmaf(v, s[j], im[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      const int k = k0 + 32 * j;
      if (k >= n_bins) continue;
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        const int f = f0 + fl + i;
        if (f < n_frames) {
          const float p = re[i][j] * re[i][j] + im[i][j] * im[i][j];
          out[(b * n_frames + f) * n_bins + k] = logf(fmaxf(p, 1e-12f));
        }
      }
    }
  }
}

}  // namespace

// x: (batch, n_samples) f32 contiguous; out: (batch, n_frames, n_bins) f32;
// cosm/sinm: (win, n_bins) f32.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
extern "C" int stft_lps_f32(const float* x, float* out, const float* cosm,
                            const float* sinm, long long batch,
                            long long n_samples, int n_frames, int n_bins,
                            int win, int hop, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (hop <= 0 || win <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int groups = kMaxGroups;
  size_t smem = 0;
  for (; groups > 0; --groups) {
    smem = ((size_t)(groups * kFramesPerWarp - 1) * hop + win) * sizeof(float);
    if (smem <= (size_t)max_smem) break;
  }
  if (groups == 0) return (int)cudaErrorInvalidValue;  // one frame tile exceeds shared memory
  const int frames_per_block = groups * kFramesPerWarp;
  const int n_tiles = (n_frames + frames_per_block - 1) / frames_per_block;
  if (batch * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // grid x limit
  void (*kern)(const float*, long long, const float*, const float*, float*, int,
               int, int, int, int, int) =
      hop % 4 == 0 ? stft_lps_kernel<true> : stft_lps_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)(batch * n_tiles), kThreads, smem, (cudaStream_t)stream>>>(
      x, n_samples, cosm, sinm, out, n_frames, n_bins, win, hop, groups, n_tiles);
  return (int)cudaGetLastError();
}
