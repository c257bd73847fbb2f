// Framed, windowed real FFT -> log-power spectrum (LPS), for Hopper (sm_90a).
//
// Replaces tpu_sednn/ops/stft_pallas.py:_stft_kernel (the Pallas TPU kernel
// behind stft_lps_pallas, which featurizes wavs in tools/make_pfile.py).
//
//   out[b, f, k] = log(max(|X[b, f, k]|^2, 1e-12)),  k = 0 .. n_fft/2
//   X[b, f, k]   = sum_t x[b, f*hop + t] * w[t] * e^{-2 pi i t k / n_fft},  t < win
//
// The TPU kernel does that sum as two matrix products against (win, n_bins)
// cos/sin matrices, because a TPU has a matrix unit and little else.  A
// direct sum is 4*win*n_bins FLOP a frame (132 k at 8 kHz), which bounds it
// by the card's float32 rate (~0.5 ms at the 8 kHz serving shape).  A radix
// FFT needs ~6 k FLOP a 256-point frame, so this kernel is bound by its bytes
// instead: the signal read once and the LPS written once (263 MB at the 8 kHz
// serving shape, ~0.08 ms at 3.35 TB/s).
//
// Design.  One block of 8 warps per (utterance, tile of F frames), on a flat
// grid.  It copies the samples its frames span into shared memory once (one
// bulk copy of their 16-byte aligned middle, completing on an mbarrier, the
// at most three samples at either end by plain loads, zeros past the
// signal; any hop, any alignment), with the window (zero from win to n_fft,
// so every frame reads n_fft samples without a test) and the twiddle table.
// Each warp then transforms one frame at a time in its registers: the n_fft
// real samples as M = n_fft/2 = 32 R complex points z[m] = (x[2m] w[2m],
// x[2m+1] w[2m+1]), lane L holding z[L + 32 s], s < R, and the M-point FFT in
// four steps (Z[k1 + R k2] = sum_L W_32^(L k2) W_M^(L k1) sum_s z[L + 32 s]
// W_R^(s k1), W_n = e^{-2 pi i / n}):
//  1. each lane's R-point FFT, radix-2 decimation in frequency in registers
//     (out in bit-reversed order);
//  2. the twiddles W_M^(L k1);
//  3. R 32-point FFTs across the warp, radix-2 decimation in frequency by
//     __shfl_xor_sync: lane L then holds Z[k1 + R brev5(L)];
//  4. the split step, X[k] = E + e^{-2 pi i k/n_fft} O with E = (Z[k] +
//     conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i (Z[M-k] fetched from its
//     lane by __shfl_sync), |X|^2 against the floor, logf; the row goes
//     through the warp's shared-memory row so that it is stored coalesced.
// Shared memory holds only the samples, the tables and the output rows: no
// step of the FFT reads or writes it.  (A Stockham FFT through shared memory,
// a pass at a time, was measured first: its passes were bound by the shared
// memory's bandwidth.)  The twiddles are laid out as the lanes read them
// (ops/stft_lps.py:fft_tables), with T[j] = e^{-2 pi i j / n_fft}: W_R^m
// (m < R/2), then W_M^(L k1) (k1 = 1 .. R-1, L < 32), the 32-point steps'
// W_32^((L mod h) 16/h) (h = 16 .. 1), the split step's T[k(s, L)], and T[M];
// built in float64 on the host and rounded to float32.  No sincosf, no
// fast-math intrinsics (logf, not __logf; the build has no --use_fast_math).
// n_fft is a power of two from 256 to 2048 (StftConfig.for_rate's 8 to 48
// kHz), win <= n_fft.
// tests/test_torch_stft.py holds a float32 emulation of these steps against
// the JAX kernel and numpy's rfft.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kSmemBudget = 80 * 1024;  // several blocks an SM

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_wait0(uint64_t* bar) {  // phase 0
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)) : "memory");
}

__host__ __device__ constexpr int brev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}
__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x >> 1); }

// Entries of the twiddle table for n_fft = 64 R (see above).
__host__ __device__ constexpr int twiddle_count(int R) {
  return R / 2 + 32 * (R - 1) + 5 * 32 + 32 * R + 1;
}

__device__ inline float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ inline float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ inline float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}
__device__ inline float2 shfl_xor(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// log |X[k]|^2 from Z[k], Z[M-k] and e^{-2 pi i k/n_fft}.
__device__ inline float bin_lps(float2 zk, float2 zm, float2 t) {
  const float2 zc = make_float2(zm.x, -zm.y);  // conj Z[M - k]
  const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
  const float2 dd = csub(zk, zc);
  const float2 o = make_float2(0.5f * dd.y, -0.5f * dd.x);  // (Z[k] - conj Z[M-k]) / 2i
  const float2 xk = cadd(e, cmul(o, t));
  return logf(fmaxf(xk.x * xk.x + xk.y * xk.y, 1e-12f));
}

// The warp's output row, padded: a slot's 32 lanes (stride R) hit 32 banks.
__device__ inline int opad(int k) { return k + (k >> 5); }

// The steps over a lane's R registers, unrolled at compile time (a register
// array indexed by anything but a constant would live in local memory).
// Step 1, one radix-2 butterfly of span H on registers I and I + H:
template <int R, int H, int I>
__device__ __forceinline__ void butterfly(float2 (&a)[R], const float2* w_r) {
  if constexpr ((I & H) == 0) {
    const float2 u = a[I], v = a[I + H];
    a[I] = cadd(u, v);
    a[I + H] = cmul(csub(u, v), w_r[(I & (H - 1)) * (R / (2 * H))]);
  }
}
template <int R, int H, int... I>
__device__ __forceinline__ void fft_stage(float2 (&a)[R], const float2* w_r,
                                          std::integer_sequence<int, I...>) {
  (butterfly<R, H, I>(a, w_r), ...);
}
template <int R, int H>
__device__ __forceinline__ void lane_fft(float2 (&a)[R], const float2* w_r) {
  if constexpr (H >= 1) {
    fft_stage<R, H>(a, w_r, std::make_integer_sequence<int, R>{});
    lane_fft<R, H / 2>(a, w_r);
  }
}
// Step 2, the twiddle of register S (Y[brev(S)]):
template <int R, int... S>
__device__ __forceinline__ void twist(float2 (&a)[R], const float2* w_lk, int lane,
                                      std::integer_sequence<int, S...>) {
  ((brev(S, log2i(R)) != 0
        ? (void)(a[S] = cmul(a[S], w_lk[(brev(S, log2i(R)) - 1) * 32 + lane]))
        : (void)0),
   ...);
}
// Step 4, the bins of register S: k = brev(S) + R k2; Z[M - k] is register
// brev((R - brev(S)) mod R) of lane src0 (brev(S) == 0) or 31 - lane.
template <int R, int S>
__device__ __forceinline__ void split_bins(const float2 (&a)[R], int lane, int k2, int src0,
                                           const float2* w_split, float* orow_s) {
  constexpr int RB = log2i(R), k1 = brev(S, RB), sp = brev((R - k1) % R, RB);
  const float2 zm = shfl(a[sp], k1 == 0 ? src0 : 31 - lane);
  const int k = k1 + R * k2;
  orow_s[opad(k)] = bin_lps(a[S], zm, w_split[S * 32 + lane]);
  if (k == 0) orow_s[opad(32 * R)] = bin_lps(zm, a[S], w_split[32 * R]);  // bin M: from Z[0] too
}
template <int R, int... S>
__device__ __forceinline__ void split_step(const float2 (&a)[R], int lane, int k2, int src0,
                                           const float2* w_split, float* orow_s,
                                           std::integer_sequence<int, S...>) {
  (split_bins<R, S>(a, lane, k2, src0, w_split, orow_s), ...);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
stft_lps_kernel(const float* __restrict__ x, long long n_samples, const float* __restrict__ window,
                const float2* __restrict__ twiddle, float* __restrict__ out, int n_frames,
                int n_bins, int win, int hop, int frames_per_block, int n_tiles) {
  constexpr int M = 32 * R, N = 2 * M, kTw = twiddle_count(R);
  constexpr int kRow = M + 1 + (M + 1) / 32 + 1;  // a padded output row
  extern __shared__ __align__(16) float2 smem2[];
  const long long b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * frames_per_block;
  const int nf = min(frames_per_block, n_frames - f0);
  const long long s0 = (long long)f0 * hop;
  const int span = (nf - 1) * hop + N;
  const int span_room = (frames_per_block - 1) * hop + N + 4;  // as smem_bytes counts it
  const float* xb = x + b * n_samples + s0;
  // sig[i] = sample s0 + i, in the same position in 16 bytes as in the signal
  const int phase = (int)((reinterpret_cast<uintptr_t>(xb) >> 2) & 3);
  float* base = reinterpret_cast<float*>(smem2);
  float* sig = base + phase;                    // span
  float* wsm = base + (span_room + 3) / 4 * 4;  // n_fft
  float* rows = wsm + N;                        // kWarps x kRow
  float2* tw = reinterpret_cast<float2*>(rows + (kWarps * kRow + 1) / 2 * 2);  // kTw
  uint64_t* bar = reinterpret_cast<uint64_t*>(tw + kTw);

  const int valid = (int)min((long long)span, n_samples - s0);  // samples in the signal
  const int i0 = (4 - phase) & 3;                                 // the first aligned one
  const int n_bulk = valid > i0 ? (valid - i0) / 4 * 4 : 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(n_bulk * 4) : "memory");
    if (n_bulk > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(sig + i0)), "l"(xb + i0), "r"(n_bulk * 4),
          "r"(smem_addr(bar)) : "memory");
  }
  for (int i = threadIdx.x; i < i0; i += kThreads) sig[i] = i < valid ? xb[i] : 0.0f;
  for (int i = i0 + n_bulk + threadIdx.x; i < span; i += kThreads)  // the tail; zeros past it
    sig[i] = i < valid ? xb[i] : 0.0f;
  for (int i = threadIdx.x; i < N; i += kThreads) wsm[i] = i < win ? window[i] : 0.0f;
  for (int i = threadIdx.x; i < kTw; i += kThreads) tw[i] = twiddle[i];
  mbar_wait0(bar);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float2* w_r = tw;                    // W_R^m, m < R/2
  const float2* w_lk = w_r + R / 2;          // W_M^(L k1), k1 = 1 .. R-1
  const float2* w_32 = w_lk + 32 * (R - 1);  // the 32-point steps'
  const float2* w_split = w_32 + 5 * 32;     // T[k(s, L)], then T[M]
  float* orow_s = rows + warp * kRow;
  const int k2 = __brev(lane) >> 27;            // lane L ends with Z[k1 + R k2]
  const int src0 = __brev((32 - k2) & 31) >> 27;  // the lane of Z[M - R k2]
  for (int fl = warp; fl < nf; fl += kWarps) {
    const float* fr = sig + fl * hop;
    const bool even = ((phase + fl * hop) & 1) == 0;  // the frame's samples 8-byte aligned
    float2 a[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {  // z[L + 32 s], windowed
      const int t = 2 * (lane + 32 * s);
      const float2 wv = *reinterpret_cast<const float2*>(wsm + t);
      const float2 xv =
          even ? *reinterpret_cast<const float2*>(fr + t) : make_float2(fr[t], fr[t + 1]);
      a[s] = make_float2(xv.x * wv.x, xv.y * wv.y);
    }
    // 1. the R-point FFT in registers (decimation in frequency): a[s] = Y[brev(s)]
    lane_fft<R, R / 2>(a, w_r);
    // 2. the twiddles W_M^(L k1)
    twist<R>(a, w_lk, lane, std::make_integer_sequence<int, R>{});
    // 3. the 32-point FFTs across the warp (decimation in frequency)
#pragma unroll
    for (int st = 0; st < 5; ++st) {
      const int h = 16 >> st;
      const bool lower = (lane & h) == 0;
      const float2 t = w_32[st * 32 + lane];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const float2 other = shfl_xor(a[s], h);
        a[s] = lower ? cadd(a[s], other) : cmul(csub(other, a[s]), t);
      }
    }
    // 4. the split step: lane L, slot s holds Z[k], k = brev(s) + R brev5(L)
    split_step<R>(a, lane, k2, src0, w_split, orow_s, std::make_integer_sequence<int, R>{});
    __syncwarp();
    float* orow = out + (b * n_frames + f0 + fl) * (long long)n_bins;
    for (int k = lane; k <= M; k += 32) orow[k] = orow_s[opad(k)];
    __syncwarp();  // the row is the next frame's
  }
}

// the span (room for its phase), window, output rows, twiddles, mbarrier
size_t smem_bytes(int frames, int R, int hop) {
  const int N = 64 * R, M = 32 * R;
  const size_t span_room = (size_t)(frames - 1) * hop + N + 4;
  const size_t rows = (size_t)kWarps * (M + 1 + (M + 1) / 32 + 1);
  return ((span_room + 3) / 4 * 4 + N + (rows + 1) / 2 * 2) * sizeof(float) +
         (size_t)twiddle_count(R) * sizeof(float2) + sizeof(uint64_t);
}

template <int R>
cudaError_t launch(const float* x, float* out, const float* window, const float* twiddle,
                   long long batch, long long n_samples, int n_frames, int n_bins, int win, int hop,
                   int max_smem, cudaStream_t stream) {
  // the most frames a block (a multiple of the 8 warps, up to 64) within the
  // budget, else the most that fit at all
  int frames = 64;
  while (frames > kWarps && smem_bytes(frames, R, hop) > kSmemBudget) frames /= 2;
  while (frames > 1 && smem_bytes(frames, R, hop) > (size_t)max_smem) frames /= 2;
  const size_t smem = smem_bytes(frames, R, hop);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;  // one frame is too large
  const int n_tiles = (n_frames + frames - 1) / frames;
  if (batch * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;  // grid x limit
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_lps_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  stft_lps_kernel<R><<<(unsigned)(batch * n_tiles), kThreads, smem, stream>>>(
      x, n_samples, window, reinterpret_cast<const float2*>(twiddle), out, n_frames, n_bins, win,
      hop, frames, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, n_samples) f32 contiguous; out: (batch, n_frames, n_bins) f32;
// window: (win,) f32; twiddle: twiddle_count(n_fft / 64) complex f32 as (re,
// im) pairs, laid out as above.  n_fft a power of two from 256 to 2048, win <=
// n_fft, n_bins = n_fft/2 + 1.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success).
extern "C" int stft_lps_f32(const float* x, float* out, const float* window, const float* twiddle,
                            long long batch, long long n_samples, int n_frames, int n_bins,
                            int win, int hop, int n_fft, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (hop <= 0 || win <= 0 || win > n_fft || n_bins != n_fft / 2 + 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  auto run = [&](auto r) {
    constexpr int R = decltype(r)::value;
    return (int)launch<R>(x, out, window, twiddle, batch, n_samples, n_frames, n_bins, win, hop,
                          max_smem, (cudaStream_t)stream);
  };
  switch (n_fft) {
    case 256: return run(std::integral_constant<int, 4>{});
    case 512: return run(std::integral_constant<int, 8>{});
    case 1024: return run(std::integral_constant<int, 16>{});
    case 2048: return run(std::integral_constant<int, 32>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
