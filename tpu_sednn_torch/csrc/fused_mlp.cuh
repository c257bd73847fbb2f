// Device code of the fused MLP layer kernels for Hopper (sm_90a), shared by
// fused_mlp.cu (kernels 1 and 2 on their own) and resident_chunk.cu (the
// whole-chunk trainer, which enqueues the same kernels bunch after bunch).
//
// Replaces tpu_sednn/ops/fused_mlp.py:_fwd_kernel (fused_linear_act) and
// :_bwd_kernel (fused_bwd_update), and the per-bunch body of
// tpu_sednn/ops/resident_chunk.py:_resident_kernel.
//
// Two forms of each kernel, as the TPU kernels' `bf16` flag selects:
// * tensor-core products (bf16=True, the JAX kernels' default): tc_fwd_kernel
//   and tc_bwd_kernel.  Both operands of every product are rounded to
//   bfloat16 (to nearest even) as they are staged into shared memory, and
//   mma.sync m16n8k16 sums the exact products in float32 (mma_bf16.cuh).
//   Everything else stays float32: biases, the bias gradient, the update on
//   the unrounded W, activations and their derivatives.
// * float32 FMA products (bf16=False): fwd_kernel and bwd_kernel.
//
// Bound.  A layer at bunch 128 does 2*128*K*N FLOP per product (one in the
// forward, two in the backward) against one pass over W in the forward and
// one read + one write of W and of Delta in the backward: 4*K*N bytes
// forward (64 FLOP/byte), 16*K*N bytes backward (32 FLOP/byte).  An H100
// balances at 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte in float32 without
// tensor cores, so the FMA forms are operations-bound, narrowly; at 989
// TFLOP/s bf16 (295 FLOP/byte) the tensor-core forms are bytes-bound.
//
// What the design keeps out of device memory: no gradient matrix is ever
// written (a block forms its G tile in registers and applies the momentum
// update to the W and Delta tiles it owns, reading and writing each once);
// bias, activation, the next layer's dropout mask and the output layer's
// dedx are epilogues of the forward product; the activation derivative is
// the epilogue of the dedy reduction.
//
// At a bunch of 128 the card is short of blocks, not of arithmetic: the
// forward splits K over the grid (see fwd_k_chunk) and prefetches the next
// tile into registers; measured times beside the bound are in PERF.md.
//
// Blocks of a grid run in no order, so the TPU kernel's accumulation of dedy
// over a sequential grid axis becomes: each block writes its partial
// dedx[:, n-tile] @ W_tile^T (formed from the W tile it loaded, so "W before
// the update" holds by construction) to a scratch (n_tiles, M, K), and a
// second small kernel sums the partials in a fixed order (deterministic; no
// float atomics).
//
// True sizes throughout: K = 1548 and N = 129 are masked at the edges by the
// kernels (16-byte loads where the row stride allows, scalar otherwise; the
// tensor-core forms stage true zeros past every edge), so nothing is padded
// to the TPU's 128-tiles.
//
// Storage types.  Activations, biases and every sum are float32.  W (both
// kernels) and Delta (the backward) are template parameters: float32, or
// bfloat16 bit patterns that are widened as they are loaded (vec4.cuh) and,
// in the backward, narrowed with stochastic rounding as they are stored
// (sr_round.cuh): the TPU kernel's sr_delta and sr_state.  That halves two or
// five of the passes over the state; with float32 products the kernels stay
// operations-bound and it buys memory, not time.
//
// Data parallelism (the TPU kernel's n_dev > 1, resident_chunk.py:_allreduce,
// which sums each row block's gradient over the chips with remote copies from
// inside the kernel): on this card the sum goes through a collective outside
// the kernels, so the backward has a gradient-out form that writes G and gb
// instead of applying them, and update_kernel applies the summed gradient
// with the same update code.  That form writes G once and update_kernel reads
// it back: two passes over K*N floats more than the fused update, the price of
// a sum between the two.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "philox.cuh"
#include "sr_round.cuh"
#include "vec4.cuh"

namespace sednn {

enum Act { kLinear = 0, kRelu = 1, kSigmoid = 2 };

__device__ inline float act_fn(int act, float z) {
  if (act == kRelu) return fmaxf(z, 0.0f);
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-z));
  return z;
}

// ---------------------------------------------------------------------------
// Kernel 1: y = act(x @ W + b), optional masks and the output layer's dedx.
//   x (M, K) row stride K, masked on load by in_mask (the dropout of the
//   net's input); W (K, N); y (M, N) = act(.) * out_mask (the dropout of the
//   NEXT layer's input, so the stored activation is the masked one the
//   backward needs).  If targ != nullptr also
//   dedx = coef * (y - targ) [* y * (1 - y) for a sigmoid head].
// One block: a 32 x 64 tile of y, 128 threads, 4 x 4 outputs a thread, K in
// steps of 32 with the next step's loads in flight.  At a bunch of 128 the
// tiles alone are too few blocks (128 for a 2048-wide layer, 12 for the
// 129-wide one), so K is split over the grid as well (fwd_k_chunk): each
// block then writes its partial sums to a scratch (chunks, M, N) and
// fwd_sum_kernel adds them in chunk order and does the epilogue.
// ---------------------------------------------------------------------------

// What follows the product: bias, activation, the next layer's mask, and the
// output layer's dedx.  Shared by fwd_kernel (K not split) and fwd_sum_kernel.
struct FwdEpilogue {
  const float* b;
  float* y;
  int M, N, act;
  MaskSpec out_mask;
  const float* targ;
  float* dedx;
  float coef;
  bool vec_y, vec_t;
};

// s[0..3]: the products' sums for columns col..col+3 (col a multiple of 4) of `row`.
__device__ inline void fwd_epilogue4(const FwdEpilogue& e, int row, int col, const float s[4]) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = act_fn(e.act, s[j] + (col + j < e.N ? e.b[col + j] : 0.0f));
  if (e.out_mask.mode != 0) {
    float mk[4];
    mask4(e.out_mask, row, col, e.N, mk);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] *= mk[j];
  }
  st4(e.y, row, col, e.N, e.M, e.N, e.vec_y, make_float4(v[0], v[1], v[2], v[3]));
  if (e.targ != nullptr) {
    const float4 tv = ld4(e.targ, row, col, e.N, e.M, e.N, e.vec_t);
    const float tr[4] = {tv.x, tv.y, tv.z, tv.w};
    float g[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[j] = e.coef * (v[j] - tr[j]);
      if (e.act == kSigmoid) g[j] = g[j] * v[j] * (1.0f - v[j]);
    }
    st4(e.dedx, row, col, e.N, e.M, e.N, e.vec_y, make_float4(g[0], g[1], g[2], g[3]));
  }
}

constexpr int kFwdBM = 32, kFwdBN = 64, kFwdBK = 32, kFwdThreads = 128;
constexpr int kFwdALoads = kFwdBM * kFwdBK / 4 / kFwdThreads;  // float4 per thread and tile: 2
constexpr int kFwdWLoads = kFwdBK * kFwdBN / 4 / kFwdThreads;  // 4

template <typename TW>  // storage of W: float or bf16_t (widened as it is loaded)
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel(const float* __restrict__ x, const TW* __restrict__ w, int M, int K, int N,
           MaskSpec in_mask, FwdEpilogue epi, float* __restrict__ part, int k_chunk, bool vec_x,
           bool vec_w, bool vec_p) {
  __shared__ __align__(16) float As[kFwdBK][kFwdBM + 4];  // x tile, transposed
  __shared__ __align__(16) float Bs[kFwdBK][kFwdBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kFwdBM, n0 = blockIdx.x * kFwdBN;
  const int tm = tid / 16, tn = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // The next tile's x and W are loaded into registers while the current one
  // is multiplied: with one block of four warps on an SM nothing else hides
  // the latency of device memory.
  float4 a_reg[kFwdALoads], w_reg[kFwdWLoads];
  float a_mask[kFwdALoads][4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kFwdALoads; ++r) {
      const int idx = tid + r * kFwdThreads;
      const int row = m0 + idx / (kFwdBK / 4), kk = k0 + (idx % (kFwdBK / 4)) * 4;
      a_reg[r] = ld4(x, row, kk, K, M, K, vec_x);
      if (in_mask.mode != 0) {
        if (row < M && kk < K) {
          mask4(in_mask, row, kk, K, a_mask[r]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) a_mask[r][j] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kFwdWLoads; ++r) {
      const int idx = tid + r * kFwdThreads;
      w_reg[r] = ld4(w, k0 + idx / 16, n0 + (idx % 16) * 4, N, K, N, vec_w);
    }
  };
  // this block's share of K: all of it, or chunk blockIdx.z when K is split
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kFwdBK) {
#pragma unroll
    for (int r = 0; r < kFwdALoads; ++r) {
      const int idx = tid + r * kFwdThreads;
      const int ar = idx / (kFwdBK / 4), ak = (idx % (kFwdBK / 4)) * 4;
      float4 a = a_reg[r];
      if (in_mask.mode != 0) {
        a.x *= a_mask[r][0]; a.y *= a_mask[r][1]; a.z *= a_mask[r][2]; a.w *= a_mask[r][3];
      }
      As[ak + 0][ar] = a.x;
      As[ak + 1][ar] = a.y;
      As[ak + 2][ar] = a.z;
      As[ak + 3][ar] = a.w;
    }
#pragma unroll
    for (int r = 0; r < kFwdWLoads; ++r) {
      const int idx = tid + r * kFwdThreads;
      *reinterpret_cast<float4*>(&Bs[idx / 16][(idx % 16) * 4]) = w_reg[r];
    }
    __syncthreads();
    if (k0 + kFwdBK < k_end) fetch(k0 + kFwdBK);
#pragma unroll
    for (int k = 0; k < kFwdBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][tm * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tn * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int col = n0 + tn * 4;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tm * 4 + i;
    if (row >= M) continue;
    if (part == nullptr) {
      fwd_epilogue4(epi, row, col, acc[i]);
    } else {
      st4(part + (long long)blockIdx.z * M * N, row, col, N, M, N, vec_p,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

// Adds the K-chunks' partial sums in chunk order, then the epilogue.
__global__ void __launch_bounds__(256)
fwd_sum_kernel(const float* __restrict__ part, int n_chunks, FwdEpilogue epi, bool vec_p) {
  const int c4 = (epi.N + 3) / 4;
  const long long n = (long long)epi.M * c4, stride = (long long)epi.M * epi.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / c4), col = (int)(i % c4) * 4;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int z = 0; z < n_chunks; ++z) {
      const float4 p = ld4(part + z * stride, row, col, epi.N, epi.M, epi.N, vec_p);
      s[0] += p.x; s[1] += p.y; s[2] += p.z; s[3] += p.w;
    }
    fwd_epilogue4(epi, row, col, s);
  }
}

// Kernel 1, tensor-core form: the same function with rne(x * in_mask) @
// rne(W) in place of the float32 product (rne: rounded to bfloat16, to
// nearest even; the mask and its scale are applied in float32 before the
// rounding, as the TPU kernel scales h before its _dot rounds it).  One
// block: a 64 x 64 tile of y, four warps of 32 x 32 (2 x 4 m16n8k16 tiles
// each), K in steps of 32 staged as bfloat16 into shared memory (true zeros
// past every edge) with the next step's loads in flight in registers; K is
// split over the grid as in fwd_kernel.  The sums go through shared memory
// to fwd_epilogue4, so both forms share one epilogue.
constexpr int kTcBM = 64, kTcBN = 64, kTcBK = 32, kTcThreads = 128;
constexpr int kTcALd = kTcBK + 8;  // bfloat16 row strides of 80 and 144 bytes: 16-byte
constexpr int kTcBLd = kTcBN + 8;  // multiples whose eight rows ldmatrix reads hit all 32 banks
constexpr int kTcCLd = kTcBN + 4;
constexpr int kTcALoads = kTcBM * kTcBK / 4 / kTcThreads;  // float4 per thread and tile: 4
constexpr int kTcWLoads = kTcBK * kTcBN / 4 / kTcThreads;  // 4

template <typename TW>
__global__ void __launch_bounds__(kTcThreads)
tc_fwd_kernel(const float* __restrict__ x, const TW* __restrict__ w, int M, int K, int N,
              MaskSpec in_mask, FwdEpilogue epi, float* __restrict__ part, int k_chunk, bool vec_x,
              bool vec_w, bool vec_p) {
  __shared__ __align__(16) bf16_t As[kTcBM][kTcALd];  // rne(x tile), (m, k)
  __shared__ __align__(16) bf16_t Bs[kTcBK][kTcBLd];  // rne(W tile), (k, n)
  __shared__ __align__(16) float Cs[kTcBM][kTcCLd];   // the sums, for the epilogue
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's 32 x 32 of the tile
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  float4 a_reg[kTcALoads], w_reg[kTcWLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kTcALoads; ++r) {
      const int idx = tid + r * kTcThreads;
      const int row = m0 + idx / (kTcBK / 4), kk = k0 + (idx % (kTcBK / 4)) * 4;
      float4 a = ld4(x, row, kk, K, M, K, vec_x);
      if (in_mask.mode != 0 && row < M && kk < K) {
        float mk[4];
        mask4(in_mask, row, kk, K, mk);
        a.x *= mk[0]; a.y *= mk[1]; a.z *= mk[2]; a.w *= mk[3];
      }
      a_reg[r] = a;
    }
#pragma unroll
    for (int r = 0; r < kTcWLoads; ++r) {
      const int idx = tid + r * kTcThreads;
      w_reg[r] = ld4(w, k0 + idx / (kTcBN / 4), n0 + (idx % (kTcBN / 4)) * 4, N, K, N, vec_w);
    }
  };
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kTcBK) {
#pragma unroll
    for (int r = 0; r < kTcALoads; ++r) {
      const int idx = tid + r * kTcThreads;
      st_rne4(&As[idx / (kTcBK / 4)][(idx % (kTcBK / 4)) * 4], a_reg[r]);
    }
#pragma unroll
    for (int r = 0; r < kTcWLoads; ++r) {
      const int idx = tid + r * kTcThreads;
      st_rne4(&Bs[idx / (kTcBN / 4)][(idx % (kTcBN / 4)) * 4], w_reg[r]);
    }
    __syncthreads();
    if (k0 + kTcBK < k_end) fetch(k0 + kTcBK);
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t a[2][4], b[2][4];
      load_a(a[0], &As[wm][kk], kTcALd, lane);
      load_a(a[1], &As[wm + 16][kk], kTcALd, lane);
      load_b_kn(b[0], &Bs[kk][wn], kTcBLd, lane);
      load_b_kn(b[1], &Bs[kk][wn + 16], kTcBLd, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + g, col = wn + j * 8 + 2 * t;
      Cs[row][col] = acc[i][j][0];
      Cs[row][col + 1] = acc[i][j][1];
      Cs[row + 8][col] = acc[i][j][2];
      Cs[row + 8][col + 1] = acc[i][j][3];
    }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kTcBM * kTcBN / 4 / kTcThreads; ++r) {
    const int idx = tid + r * kTcThreads;
    const int row = idx / (kTcBN / 4), col = (idx % (kTcBN / 4)) * 4;
    if (m0 + row >= M || n0 + col >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(&Cs[row][col]);
    if (part == nullptr) {
      const float s[4] = {v.x, v.y, v.z, v.w};
      fwd_epilogue4(epi, m0 + row, n0 + col, s);
    } else {
      st4(part + (long long)blockIdx.z * M * N, m0 + row, n0 + col, N, M, N, vec_p, v);
    }
  }
}

// How K is split over the grid: enough blocks to put about four on each of
// the card's SMs (one block walks its K range with four warps, too few to
// keep an SM's arithmetic busy), in chunks that are multiples of the K step
// (32 in both forms).  A function of the shape and the form (tc: the
// tensor-core form's 64 x 64 tiles) alone.  -> the chunk length; *n_chunks
// the count.
inline int fwd_k_chunk(int M, int K, int N, bool tc, int* n_chunks) {
  const int bm = tc ? kTcBM : kFwdBM, bn = tc ? kTcBN : kFwdBN;
  const int tiles = ((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  int want = (4 * 132 + tiles - 1) / tiles;
  want = want < 1 ? 1 : (want > 16 ? 16 : want);
  int chunk = ((K + want - 1) / want + kFwdBK - 1) / kFwdBK * kFwdBK;
  if (chunk < kFwdBK) chunk = kFwdBK;
  *n_chunks = K > 0 ? (K + chunk - 1) / chunk : 1;
  return chunk;
}

// Scratch floats launch_fwd needs in `part` (0 when K is not split).
inline long long fwd_scratch_floats(int M, int K, int N, bool tc, int plan_rows = 0) {
  int n_chunks;
  fwd_k_chunk(plan_rows > 0 ? plan_rows : M, K, N, tc, &n_chunks);
  return n_chunks > 1 ? (long long)n_chunks * M * N : 0;
}

// tc: the tensor-core form (tc_fwd_kernel), else the float32 one (fwd_kernel).
// plan_rows > 0: split K as for that many rows (the data-parallel trainer
// plans for the global tile, so a rank's rows are summed in the order the
// single-device trainer sums them: each output's sum depends only on the
// chunk boundaries), else as for M.
template <typename TW>
inline cudaError_t launch_fwd(const float* x, const TW* w, const float* b, float* y, int M,
                              int K, int N, int act, const MaskSpec& in_mask,
                              const MaskSpec& out_mask, const float* targ, float* dedx,
                              float coef, float* part, bool tc, cudaStream_t stream,
                              int plan_rows = 0) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  int n_chunks;
  const int k_chunk = fwd_k_chunk(plan_rows > 0 ? plan_rows : M, K, N, tc, &n_chunks);
  if (n_chunks > 1 && part == nullptr) return cudaErrorInvalidValue;
  FwdEpilogue epi;
  epi.b = b;
  epi.y = y;
  epi.M = M;
  epi.N = N;
  epi.act = act;
  epi.out_mask = out_mask;
  epi.targ = targ;
  epi.dedx = dedx;
  epi.coef = coef;
  epi.vec_y = vec_ok(y, N) && (dedx == nullptr || vec_ok(dedx, N));
  epi.vec_t = targ != nullptr && vec_ok(targ, N);
  float* scratch = n_chunks > 1 ? part : nullptr;
  if (tc) {
    dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM, n_chunks);
    tc_fwd_kernel<TW><<<grid, kTcThreads, 0, stream>>>(x, w, M, K, N, in_mask, epi, scratch,
                                                       k_chunk, vec_ok(x, K), vec_ok(w, N),
                                                       vec_ok(scratch, N));
  } else {
    dim3 grid((N + kFwdBN - 1) / kFwdBN, (M + kFwdBM - 1) / kFwdBM, n_chunks);
    fwd_kernel<TW><<<grid, kFwdThreads, 0, stream>>>(x, w, M, K, N, in_mask, epi, scratch,
                                                     k_chunk, vec_ok(x, K), vec_ok(w, N),
                                                     vec_ok(scratch, N));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  const long long n = (long long)M * ((N + 3) / 4);
  const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  fwd_sum_kernel<<<blocks, 256, 0, stream>>>(scratch, n_chunks, epi, vec_ok(scratch, N));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 2: one layer's backward and in-place momentum update.
//   dedx (M, N), yprev (M, K) (masked on load by in_mask: the net's input),
//   W, Delta (K, N), b, db (N,), scalars m, A, Bc:
//     G      = yprev^T @ dedx
//     Delta' = m*Delta - (A*G + Bc*W),  W' = W + Delta'      (in place)
//     gb     = sum_rows dedx;  db' = m*db - A*gb,  b' = b + db'   (k-tile 0)
//     part[nt] = dedx[:, n-tile] @ W_tile^T   (M, K), if part != nullptr
// One block owns a 64 x 64 tile of W and Delta, 256 threads; it walks the M
// rows in chunks of 32.
//
// Storage (template): W and Delta float32; Delta bfloat16 (the TPU kernel's
// sr_delta: Delta' is stored stochastically rounded, W takes the unrounded
// float32 Delta'); or both bfloat16 (sr_state: W' = SR(W + Delta') too, a
// second draw).  All arithmetic stays float32 on widened values; the bits are
// sr_round.cuh's stream `sr_key`, counter = the element's (row, column) in W.
//
// Row-tiled accumulation (`flags`, float32 storage): a bunch that comes in
// several row tiles accumulates its gradient INTO Delta.  kUpdFirst: this
// launch applies the decay and the weight cost, Delta' = m*Delta - (A*G +
// Bc*W); without it, Delta' = Delta - A*G.  kUpdApply: this launch lands the
// step, W' = W + Delta'; without it W is left alone, so every tile's forward
// and dedy see the W from before the bunch.  Both set is the plain update.
// The bias follows the same flags.
//
// Gradient out (gout != nullptr; the data-parallel trainer): the block
// stores its G tile, and k-tile 0 its gb, into gout (K*N floats of G
// row-major, then N of gb) and leaves W, Delta, b and db alone; dedy is
// formed as above from the W it reads.  The sum over the ranks then goes
// through a collective, and update_kernel applies it.
// ---------------------------------------------------------------------------

constexpr int kUpdFirst = 1, kUpdApply = 2;

// The in-place update of columns col..col+3 (col a multiple of 4) of row kr
// of W and Delta, from the unrounded W the block loaded (wr) and G (gr):
// Delta' = m*Delta - (A*G + Bc*W) with `first` (kUpdFirst), else Delta - A*G;
// W' = W + Delta' with `apply` (kUpdApply); bfloat16 stores rounded
// stochastically.  Shared by both forms of kernel 2 and by update_kernel, as
// is update_bias.  Written with the round-to-nearest intrinsics, which the
// compiler does not contract into fused multiply-adds: one float32 operation
// at a time, in the order the plain versions compute them.
template <typename TW, typename TD>
__device__ inline void update_row4(TW* __restrict__ w, TD* __restrict__ delta, int kr, int col,
                                   int K, int N, const float wr[4], const float gr[4], float mom,
                                   float A, float Bc, uint32_t sr_key, bool first, bool apply,
                                   bool vec_w, bool vec_dl) {
  constexpr bool kSr = !std::is_same<TW, float>::value || !std::is_same<TD, float>::value;
  const float4 dv = ld4(delta, kr, col, N, K, N, vec_dl);
  const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
  float nd[4], nw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    nd[j] = first ? __fsub_rn(__fmul_rn(mom, dr[j]),
                              __fadd_rn(__fmul_rn(A, gr[j]), __fmul_rn(Bc, wr[j])))
                  : __fsub_rn(dr[j], __fmul_rn(A, gr[j]));
    nw[j] = __fadd_rn(wr[j], nd[j]);
  }
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  if (kSr) sr_bits4(sr_key, kr, col, bits);
  st4_sr(delta, kr, col, N, K, N, vec_dl, nd, bits, kSrDeltaShift);
  if (apply) st4_sr(w, kr, col, N, K, N, vec_w, nw, bits, kSrWeightShift);
}

// The bias of column n: db' = m*db - A*gb (first) or db - A*gb, b' = b + db' (apply).
__device__ inline void update_bias(float* b, float* db, int n, float gb, float mom, float A,
                                   bool first, bool apply) {
  const float ndb = first ? __fsub_rn(__fmul_rn(mom, db[n]), __fmul_rn(A, gb))
                          : __fsub_rn(db[n], __fmul_rn(A, gb));
  db[n] = ndb;
  if (apply) b[n] = __fadd_rn(b[n], ndb);
}

constexpr int kBwdBK = 64, kBwdBN = 64, kBwdMC = 32, kBwdThreads = 256;
constexpr int kBwdWLd = kBwdBN + 4;  // padded: the dedy product reads W rows 16 apart

// gout: the gradient-out form (see above); nullptr: the in-place update.
template <typename TW, typename TD>
__global__ void __launch_bounds__(kBwdThreads)
bwd_kernel(const float* __restrict__ dedx, const float* __restrict__ yprev, MaskSpec in_mask,
           TW* __restrict__ w, TD* __restrict__ delta, float* __restrict__ b,
           float* __restrict__ db, float* __restrict__ gout, float* __restrict__ part, int M,
           int K, int N, float mom, float A, float Bc, uint32_t sr_key, int flags, bool vec_d,
           bool vec_y, bool vec_w, bool vec_dl, bool vec_g) {
  const bool first = (flags & kUpdFirst) != 0, apply = (flags & kUpdApply) != 0;
  __shared__ __align__(16) float Ws[kBwdBK][kBwdWLd];
  __shared__ __align__(16) float Ys[kBwdMC][kBwdBK];
  __shared__ __align__(16) float Ds[kBwdMC][kBwdBN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBwdBN, k0 = blockIdx.y * kBwdBK;
  const int tk = tid / 16, tn = tid % 16;  // G: rows tk*4.., cols tn*4..
  const int pm = tid / 16, pk = tid % 16;  // partial: rows pm*2.., cols pk + 16*j

  // the W tile feeds the update and dedy: the gradient-out form of the first
  // layer needs neither
  if (gout == nullptr || part != nullptr) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + r * kBwdThreads;
      const int wr = idx / 16, wc = (idx % 16) * 4;
      *reinterpret_cast<float4*>(&Ws[wr][wc]) = ld4(w, k0 + wr, n0 + wc, N, K, N, vec_w);
    }
  }
  float g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
  float gb = 0.0f;

  for (int mc = 0; mc < M; mc += kBwdMC) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kBwdThreads;
      const int rr = idx / 16, cc = (idx % 16) * 4;
      float4 yv = ld4(yprev, mc + rr, k0 + cc, K, M, K, vec_y);
      if (in_mask.mode != 0 && mc + rr < M && k0 + cc < K) {
        float mk[4];
        mask4(in_mask, mc + rr, k0 + cc, K, mk);
        yv.x *= mk[0]; yv.y *= mk[1]; yv.z *= mk[2]; yv.w *= mk[3];
      }
      *reinterpret_cast<float4*>(&Ys[rr][cc]) = yv;
      *reinterpret_cast<float4*>(&Ds[rr][cc]) = ld4(dedx, mc + rr, n0 + cc, N, M, N, vec_d);
    }
    __syncthreads();  // also orders the Ws stores before their first use

#pragma unroll 8
    for (int r = 0; r < kBwdMC; ++r) {
      const float4 yv = *reinterpret_cast<const float4*>(&Ys[r][tk * 4]);
      const float4 dv = *reinterpret_cast<const float4*>(&Ds[r][tn * 4]);
      const float yr[4] = {yv.x, yv.y, yv.z, yv.w};
      const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(yr[i], dr[j], g[i][j]);
    }
    if (blockIdx.y == 0 && tid < kBwdBN) {
#pragma unroll 8
      for (int r = 0; r < kBwdMC; ++r) gb += Ds[r][tid];
    }
    if (part != nullptr) {
      float p[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
#pragma unroll 4
      for (int n4 = 0; n4 < kBwdBN; n4 += 4) {
        const float4 d0 = *reinterpret_cast<const float4*>(&Ds[pm * 2][n4]);
        const float4 d1 = *reinterpret_cast<const float4*>(&Ds[pm * 2 + 1][n4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(&Ws[pk + 16 * j][n4]);
          p[0][j] = fmaf(d0.x, wv.x, p[0][j]);
          p[0][j] = fmaf(d0.y, wv.y, p[0][j]);
          p[0][j] = fmaf(d0.z, wv.z, p[0][j]);
          p[0][j] = fmaf(d0.w, wv.w, p[0][j]);
          p[1][j] = fmaf(d1.x, wv.x, p[1][j]);
          p[1][j] = fmaf(d1.y, wv.y, p[1][j]);
          p[1][j] = fmaf(d1.z, wv.z, p[1][j]);
          p[1][j] = fmaf(d1.w, wv.w, p[1][j]);
        }
      }
      float* dst = part + (long long)blockIdx.x * M * K;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = mc + pm * 2 + i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = k0 + pk + 16 * j;
          if (kk < K) dst[(long long)row * K + kk] = p[i][j];
        }
      }
    }
    __syncthreads();
  }

  const int col = n0 + tn * 4;
  if (gout != nullptr) {  // gradient out: the tile of G and the bias gradient
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(gout, k0 + tk * 4 + i, col, N, K, N, vec_g,
          make_float4(g[i][0], g[i][1], g[i][2], g[i][3]));
    if (blockIdx.y == 0 && tid < kBwdBN && n0 + tid < N) gout[(long long)K * N + n0 + tid] = gb;
    return;
  }
  // momentum update of the owned tile, from the W copy in shared memory
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + tk * 4 + i;
    if (kr >= K || col >= N) continue;
    const float4 wv = *reinterpret_cast<const float4*>(&Ws[tk * 4 + i][tn * 4]);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
    update_row4(w, delta, kr, col, K, N, wr, g[i], mom, A, Bc, sr_key, first, apply, vec_w,
                vec_dl);
  }
  if (blockIdx.y == 0 && tid < kBwdBN && n0 + tid < N)
    update_bias(b, db, n0 + tid, gb, mom, A, first, apply);
}

// Kernel 2, tensor-core form: the same function with G = rne(yprev)^T @
// rne(dedx) and part[nt] = rne(dedx[:, n-tile]) @ rne(W_tile)^T; the update
// takes the UNROUNDED W and G's float32 sums, the bias its float32 dedx
// (resident_chunk.py:465, 478 and 508).  So the block keeps its W tile twice
// in shared memory: float32 for the update, rounded for the dedy product.
// One block: the 64 x 64 tile of W and Delta, eight warps; M in chunks of 32
// rows staged as bfloat16 (yprev masked in float32 first, true zeros past
// M, K and N), dedx also as float32 for the bias sums.  G: each warp 16 x 32
// (4 m16n8k16 tiles), A = yprev^T read with ldmatrix.trans.  part: each warp
// 16 x 16 of the chunk's (32, 64) dedy partial, B = W^T read as it is
// stored.  G goes through shared memory to the update code of bwd_kernel.
constexpr int kTcMC = 32;
constexpr int kTcWbLd = kBwdBN + 8;  // bfloat16 row stride of 144 bytes (see kTcBLd)

struct TcBwdSmem {
  float Ws[kBwdBK][kBwdWLd];     // W tile, float32: the update
  bf16_t Wb[kBwdBK][kTcWbLd];    // rne(W tile): the dedy product
  union {
    struct {
      bf16_t Yb[kTcMC][kTcWbLd];  // rne(masked yprev chunk), (m, k)
      bf16_t Db[kTcMC][kTcWbLd];  // rne(dedx chunk), (m, n)
      float Ds[kTcMC][kBwdWLd];   // dedx chunk, float32: the bias gradient
    } loop;
    float Gs[kBwdBK][kBwdWLd];    // G after the last chunk
  } u;
};

template <typename TW, typename TD>
__global__ void __launch_bounds__(kBwdThreads)
tc_bwd_kernel(const float* __restrict__ dedx, const float* __restrict__ yprev, MaskSpec in_mask,
              TW* __restrict__ w, TD* __restrict__ delta, float* __restrict__ b,
              float* __restrict__ db, float* __restrict__ gout, float* __restrict__ part, int M,
              int K, int N, float mom, float A, float Bc, uint32_t sr_key, int flags, bool vec_d,
              bool vec_y, bool vec_w, bool vec_dl, bool vec_g) {
  const bool first = (flags & kUpdFirst) != 0, apply = (flags & kUpdApply) != 0;
  __shared__ __align__(16) TcBwdSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBwdBN, k0 = blockIdx.y * kBwdBK;
  const int gk = (warp >> 1) * 16, gn = (warp & 1) * 32;  // the warp's G: rows of W, cols
  const int pm = (warp >> 2) * 16, pk = (warp & 3) * 16;  // the warp's part: chunk rows, K cols

  if (gout == nullptr || part != nullptr) {  // as in bwd_kernel
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + r * kBwdThreads;
      const int wr = idx / 16, wc = (idx % 16) * 4;
      const float4 v = ld4(w, k0 + wr, n0 + wc, N, K, N, vec_w);
      *reinterpret_cast<float4*>(&sm.Ws[wr][wc]) = v;
      st_rne4(&sm.Wb[wr][wc], v);
    }
  }
  float gacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) gacc[j][c] = 0.0f;
  float gb = 0.0f;

  for (int mc = 0; mc < M; mc += kTcMC) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kBwdThreads;
      const int rr = idx / 16, cc = (idx % 16) * 4;
      float4 yv = ld4(yprev, mc + rr, k0 + cc, K, M, K, vec_y);
      if (in_mask.mode != 0 && mc + rr < M && k0 + cc < K) {
        float mk[4];
        mask4(in_mask, mc + rr, k0 + cc, K, mk);
        yv.x *= mk[0]; yv.y *= mk[1]; yv.z *= mk[2]; yv.w *= mk[3];
      }
      st_rne4(&sm.u.loop.Yb[rr][cc], yv);
      const float4 dv = ld4(dedx, mc + rr, n0 + cc, N, M, N, vec_d);
      st_rne4(&sm.u.loop.Db[rr][cc], dv);
      *reinterpret_cast<float4*>(&sm.u.loop.Ds[rr][cc]) = dv;
    }
    __syncthreads();  // also orders the W tile's stores before their first use

#pragma unroll
    for (int kk = 0; kk < kTcMC; kk += 16) {
      uint32_t a[4], bb[2][4];
      load_a_trans(a, &sm.u.loop.Yb[kk][gk], kTcWbLd, lane);
      load_b_kn(bb[0], &sm.u.loop.Db[kk][gn], kTcWbLd, lane);
      load_b_kn(bb[1], &sm.u.loop.Db[kk][gn + 16], kTcWbLd, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16_16816(gacc[j], a, bb[j >> 1][(j & 1) * 2], bb[j >> 1][(j & 1) * 2 + 1]);
    }
    if (blockIdx.y == 0 && tid < kBwdBN) {
#pragma unroll 8
      for (int r = 0; r < kTcMC; ++r) gb += sm.u.loop.Ds[r][tid];
    }
    if (part != nullptr) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[j][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kBwdBN; kk += 16) {
        uint32_t a[4], bb[4];
        load_a(a, &sm.u.loop.Db[pm][kk], kTcWbLd, lane);
        load_b_nk(bb, &sm.Wb[pk][kk], kTcWbLd, lane);
        mma_bf16_16816(p[0], a, bb[0], bb[1]);
        mma_bf16_16816(p[1], a, bb[2], bb[3]);
      }
      float* dst = part + (long long)blockIdx.x * M * K;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mc + pm + g + 8 * h, kk = k0 + pk + j * 8 + 2 * t;
          if (row >= M) continue;
          if (kk < K) dst[(long long)row * K + kk] = p[j][2 * h];
          if (kk + 1 < K) dst[(long long)row * K + kk + 1] = p[j][2 * h + 1];
        }
    }
    __syncthreads();
  }

  // G to shared memory (over the chunks' buffers), then bwd_kernel's update
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = gk + g, col = gn + j * 8 + 2 * t;
    sm.u.Gs[row][col] = gacc[j][0];
    sm.u.Gs[row][col + 1] = gacc[j][1];
    sm.u.Gs[row + 8][col] = gacc[j][2];
    sm.u.Gs[row + 8][col + 1] = gacc[j][3];
  }
  __syncthreads();
  const int tk = tid / 16, tn = tid % 16;
  const int col = n0 + tn * 4;
  if (gout != nullptr) {  // gradient out, as in bwd_kernel
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(gout, k0 + tk * 4 + i, col, N, K, N, vec_g,
          *reinterpret_cast<const float4*>(&sm.u.Gs[tk * 4 + i][tn * 4]));
    if (blockIdx.y == 0 && tid < kBwdBN && n0 + tid < N) gout[(long long)K * N + n0 + tid] = gb;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + tk * 4 + i;
    if (kr >= K || col >= N) continue;
    const float4 wv = *reinterpret_cast<const float4*>(&sm.Ws[tk * 4 + i][tn * 4]);
    const float4 gv = *reinterpret_cast<const float4*>(&sm.u.Gs[tk * 4 + i][tn * 4]);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
    const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
    update_row4(w, delta, kr, col, K, N, wr, gr, mom, A, Bc, sr_key, first, apply, vec_w, vec_dl);
  }
  if (blockIdx.y == 0 && tid < kBwdBN && n0 + tid < N)
    update_bias(b, db, n0 + tid, gb, mom, A, first, apply);
}

// ---------------------------------------------------------------------------
// The update from a given gradient (the data-parallel trainer's, after the
// all-reduce of the gradient-out backward's G and gb):
//   g: K*N floats of G (row-major) then N of gb; W (K, N) float32, Delta
//   float32 or bfloat16 (sr_delta), b, db (N,):
//   Delta' = m*Delta - (A*G + Bc*W) (kUpdFirst) or Delta - A*G,
//   W' = W + Delta' (kUpdApply);  the bias alike (update_row4, update_bias).
// Elementwise; a thread takes four neighbouring columns (one Philox call when
// Delta is rounded stochastically, stream sr_key at the element's (row, col)
// in W, as the backward kernels draw).  Bound: bytes, G, W and Delta read, W
// and Delta written: 20 bytes an element in float32.
// ---------------------------------------------------------------------------

template <typename TD>
__global__ void __launch_bounds__(256)
update_kernel(float* __restrict__ w, TD* __restrict__ delta, float* __restrict__ b,
              float* __restrict__ db, const float* __restrict__ g, int K, int N, float mom,
              float A, float Bc, uint32_t sr_key, int flags, bool vec_w, bool vec_dl, bool vec_g) {
  const bool first = (flags & kUpdFirst) != 0, apply = (flags & kUpdApply) != 0;
  const int c4 = (N + 3) / 4;
  const long long n = (long long)K * c4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int kr = (int)(i / c4), col = (int)(i % c4) * 4;
    const float4 wv = ld4(w, kr, col, N, K, N, vec_w);
    const float4 gv = ld4(g, kr, col, N, K, N, vec_g);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
    const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
    update_row4(w, delta, kr, col, K, N, wr, gr, mom, A, Bc, sr_key, first, apply, vec_w, vec_dl);
  }
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < N; c += blockDim.x)
      update_bias(b, db, c, g[(long long)K * N + c], mom, A, first, apply);
}

template <typename TD>
inline cudaError_t launch_update(float* w, TD* delta, float* b, float* db, const float* g, int K,
                                 int N, float mom, float A, float Bc, uint32_t sr_key, int flags,
                                 cudaStream_t stream) {
  if (K <= 0 || N <= 0) return cudaSuccess;
  const long long n = (long long)K * ((N + 3) / 4);
  const int blocks = (int)((n + 255) / 256 < 4 * 132 * 8 ? (n + 255) / 256 : 4 * 132 * 8);
  update_kernel<TD><<<blocks, 256, 0, stream>>>(w, delta, b, db, g, K, N, mom, A, Bc, sr_key,
                                                flags, vec_ok(w, N), vec_ok(delta, N),
                                                vec_ok(g, N));
  return cudaGetLastError();
}

// dedy[m, k] = sum over the n-tiles of part[nt, m, k], in tile order; then
// the activation derivative of the layer below, taken on its stored (masked)
// activation y: relu -> y > 0 ? dedy : 0, sigmoid -> y * (1 - y) * dedy.
__global__ void __launch_bounds__(256)
reduce_dedy_kernel(const float* __restrict__ part, int n_tiles, const float* __restrict__ y,
                   float* __restrict__ out, long long total, int deriv) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < n_tiles; ++t) s += part[t * total + i];
    if (deriv == kRelu) {
      s = y[i] > 0.0f ? s : 0.0f;
    } else if (deriv == kSigmoid) {
      const float yv = y[i];
      s = yv * (1.0f - yv) * s;
    }
    out[i] = s;
  }
}

inline int bwd_n_tiles(int N) { return (N + kBwdBN - 1) / kBwdBN; }

// part: scratch of bwd_n_tiles(N) * M * K floats, or nullptr with dedy ==
// nullptr when the layer below needs no gradient (the first layer).  tc: the
// tensor-core form (tc_bwd_kernel), else the float32 one (bwd_kernel).
// gout: K*N + N floats for the gradient-out form (W is then only read, and
// delta, b and db may be nullptr), or nullptr for the in-place update.
template <typename TW, typename TD>
inline cudaError_t launch_bwd(const float* dedx, const float* yprev, const MaskSpec& in_mask,
                              TW* w, TD* delta, float* b, float* db, float* gout, float* part,
                              float* dedy, int deriv, int M, int K, int N, float mom, float A,
                              float Bc, uint32_t sr_key, int flags, bool tc,
                              cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  dim3 grid(bwd_n_tiles(N), (K + kBwdBK - 1) / kBwdBK);
  if (tc) {
    tc_bwd_kernel<TW, TD><<<grid, kBwdThreads, 0, stream>>>(
        dedx, yprev, in_mask, w, delta, b, db, gout, part, M, K, N, mom, A, Bc, sr_key, flags,
        vec_ok(dedx, N), vec_ok(yprev, K), vec_ok(w, N), vec_ok(delta, N), vec_ok(gout, N));
  } else {
    bwd_kernel<TW, TD><<<grid, kBwdThreads, 0, stream>>>(
        dedx, yprev, in_mask, w, delta, b, db, gout, part, M, K, N, mom, A, Bc, sr_key, flags,
        vec_ok(dedx, N), vec_ok(yprev, K), vec_ok(w, N), vec_ok(delta, N), vec_ok(gout, N));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long long total = (long long)M * K;
  const int blocks = (int)((total + 255) / 256 < 2048 ? (total + 255) / 256 : 2048);
  reduce_dedy_kernel<<<blocks, 256, 0, stream>>>(part, bwd_n_tiles(N), yprev, dedy, total, deriv);
  return cudaGetLastError();
}

}  // namespace sednn
