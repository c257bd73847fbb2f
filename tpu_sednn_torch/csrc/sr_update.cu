// Stochastic-rounding momentum update of bfloat16 weights for Hopper (sm_90a),
// and a probe of the rounding function itself.
//
// Replaces tpu_sednn/ops/sr_update.py:_sr_kernel (sr_momentum_update):
//
//   nd = m*delta - lr*(g + wc*w)           in float32, on widened values
//   delta' = SR_bf16(nd),  w' = SR_bf16(w + nd)
//
// w, delta (K, N) bfloat16 (a bias is (1, N)), g bfloat16 or float32, true
// sizes (the TPU version pads the rows to its block).  One elementwise pass:
// a thread takes four neighbouring columns, which is one Philox call
// (sr_round.cuh: the word's low half rounds delta, its high half w).  The
// TPU kernel seeds one stream per 512-row block, seed + block*7919; that is
// kept: element (row, col) draws from stream seed + (row / 512)*7919 at
// (row % 512, col), so a block's bits do not depend on the blocks above it.
//
// The float32 operations are written with the round-to-nearest intrinsics, so
// that the compiler does not contract them into fused multiply-adds: the
// plain version (ops/sr_update.py, one torch operation each) then computes
// the same float32 nd and, with the same bits, the same bfloat16 results.
//
// Bound: bytes.  Per element 2 + 2 + (2 or 4) read and 2 + 2 written against
// 6 float32 operations and 1/4 of a Philox call (~60 integer operations):
// at (3084, 2048) with a float32 g, 75.8 MB, 0.0226 ms at 3.35 TB/s.
//
// Every function launches on `stream`, does not synchronise, allocates
// nothing and returns cudaGetLastError() (0 on success).

#include "sr_round.cuh"

using namespace sednn;

namespace {

constexpr int kRowBlock = 512;
constexpr unsigned kBlockStride = 7919u;

template <typename TG>
__global__ void __launch_bounds__(256)
sr_update_kernel(const bf16_t* __restrict__ w, const bf16_t* __restrict__ d,
                 const TG* __restrict__ g, bf16_t* __restrict__ w_out,
                 bf16_t* __restrict__ d_out, int K, int N, uint32_t seed, float m, float lr,
                 float wc, bool vec, bool vec_g) {
  const int c4 = (N + 3) / 4;
  const long long n = (long long)K * c4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / c4), col = (int)(i % c4) * 4;
    const int blk = row / kRowBlock;
    uint32_t bits[4];
    sr_bits4(seed + (uint32_t)blk * kBlockStride, row - blk * kRowBlock, col, bits);
    const float4 wv = ld4(w, row, col, N, K, N, vec);
    const float4 dv = ld4(d, row, col, N, K, N, vec);
    const float4 gv = ld4(g, row, col, N, K, N, vec_g);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
    const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
    const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
    float nd[4], nw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nd[j] = __fsub_rn(__fmul_rn(m, dr[j]),
                        __fmul_rn(lr, __fadd_rn(gr[j], __fmul_rn(wc, wr[j]))));
      nw[j] = __fadd_rn(wr[j], nd[j]);
    }
    st4_sr(d_out, row, col, N, K, N, vec, nd, bits, kSrDeltaShift);
    st4_sr(w_out, row, col, N, K, N, vec, nw, bits, kSrWeightShift);
  }
}

__global__ void sr_round_kernel(const float* __restrict__ v, const int* __restrict__ bits,
                                bf16_t* __restrict__ out, int rows, int cols, uint32_t key,
                                int shift) {
  const int c4 = (cols + 3) / 4;
  const long long n = (long long)rows * c4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / c4), col = (int)(i % c4) * 4;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (bits == nullptr) sr_bits4(key, row, col, w);
    for (int j = 0; j < 4 && col + j < cols; ++j) {
      const long long e = (long long)row * cols + col + j;
      const uint32_t b = bits != nullptr ? (uint32_t)bits[e] : (w[j] >> shift);
      out[e] = sr_bf16(v[e], b);
    }
  }
}

int grid_for(long long n) { return (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096); }

}  // namespace

// w_out, d_out (K, N) bfloat16 = the update of w, d (bfloat16) by g (bfloat16
// if g_bf16 else float32); in place when w_out == w and d_out == d.
extern "C" int sr_momentum_update_bf16(const void* w, const void* d, const void* g, int g_bf16,
                                       void* w_out, void* d_out, int K, int N, unsigned seed,
                                       float m, float lr, float wc, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  const bf16_t *wp = (const bf16_t*)w, *dp = (const bf16_t*)d;
  bf16_t *wo = (bf16_t*)w_out, *dout = (bf16_t*)d_out;
  const bool vec = vec_ok(wp, N) && vec_ok(dp, N) && vec_ok(wo, N) && vec_ok(dout, N);
  const int blocks = grid_for((long long)K * ((N + 3) / 4));
  if (g_bf16)
    sr_update_kernel<bf16_t><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        wp, dp, (const bf16_t*)g, wo, dout, K, N, seed, m, lr, wc, vec,
        vec_ok((const bf16_t*)g, N));
  else
    sr_update_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        wp, dp, (const float*)g, wo, dout, K, N, seed, m, lr, wc, vec, vec_ok((const float*)g, N));
  return (int)cudaGetLastError();
}

// out (rows, cols) bfloat16 = v (float32) rounded stochastically: with the low
// 16 bits of bits[e] (int32, one an element) if bits != nullptr, else with
// the stream `key`'s draw at (row, col), `shift` 0 (the delta draw) or 16 (the
// weight draw).  The device function every kernel above and in fused_mlp.cuh
// rounds with, on its own.
extern "C" int sr_round_bf16(const float* v, const int* bits, void* out, int rows, int cols,
                             unsigned key, int shift, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (shift != kSrDeltaShift && shift != kSrWeightShift) return (int)cudaErrorInvalidValue;
  sr_round_kernel<<<grid_for((long long)rows * ((cols + 3) / 4)), 256, 0, (cudaStream_t)stream>>>(
      v, bits, (bf16_t*)out, rows, cols, key, shift);
  return (int)cudaGetLastError();
}
