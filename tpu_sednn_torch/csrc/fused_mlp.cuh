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
//   and stripe_bwd_kernel<true, ...>.  Both operands of every product are rounded to
//   bfloat16 (to nearest even) as they are staged into shared memory, and
//   mma.sync m16n8k16 sums the exact products in float32 (mma_bf16.cuh).
//   Everything else stays float32: biases, the bias gradient, the update on
//   the unrounded W, activations and their derivatives.
// * float32 FMA products (bf16=False): f32_fwd_kernel and
//   stripe_bwd_kernel<false, ...>: the backward's two forms are one kernel
//   with a product policy; the forward's float32 form is a sibling of
//   tc_fwd_kernel on the same cluster split and DSMEM sum.
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
// the epilogue of the dedy sum.
//
// At a bunch of 128 the card is short of blocks, not of arithmetic: both
// forwards split K within a thread-block cluster and sum the chunks through
// distributed shared memory, one launch a layer (tc_fwd_kernel,
// f32_fwd_kernel; the float32 form's chunks are fwd_k_chunk's, the order its
// sums keep); measured times beside the bound are in PERF.md.
//
// Blocks of a grid run in no order, so the TPU kernel's accumulation of dedy
// over a sequential grid axis becomes, in the backward (stripe_bwd_kernel,
// both product forms): a block owns a stripe of W's rows over a range of N,
// sums its stripe of dedy in registers, and a thread-block cluster sums the
// ranges' stripes through distributed shared memory in rank order
// (deterministic; no scratch, no second launch, no float atomics).
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "pdl.cuh"
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
//   net's input: Philox drawn in the kernel, or in the chunk trainer a table
//   of keep bits drawn once a call, philox.cuh); W (K, N); y (M, N) = act(.) * out_mask (the dropout of the
//   NEXT layer's input, so the stored activation is the masked one the
//   backward needs).  If targ != nullptr also
//   dedx = coef * (y - targ) [* y * (1 - y) for a sigmoid head].
// Two forms, each one launch a layer: f32_fwd_kernel (float32 products) and
// tc_fwd_kernel (tensor-core products), below.  The epilogue may store
// rne(y) and rne(dedx) beside y and dedx (FwdCopies): the tensor-core forward
// of the next layer and the tensor-core backward read those copies.
// ---------------------------------------------------------------------------

// What follows the product: bias, activation, the next layer's mask, and the
// output layer's dedx.  Shared by both forms of kernel 1.
struct FwdEpilogue {
  const float* b;
  float* y;
  int M, N, act;
  MaskSpec out_mask;
  const float* targ;
  float* dedx;
  bf16_t* y_bf;     // rne(y) beside it (rows of ld_bf), or nullptr
  bf16_t* dedx_bf;  // rne(dedx) beside it (rows of ld_bf), or nullptr
  int ld_bf;
  float coef;
  bool vec_y, vec_t;
};

// The row stride, in elements, of the bfloat16 copies that the tensor-core
// kernels read (rne(dedx) for the backward, rne(y) for the next layer's
// forward, each written by the launch that makes the float32 values): N
// padded to a multiple of 8, 16 bytes, so that a copy goes by tensor copies at
// every N (129 and 257 too).
inline int bf16_ld(int N) { return (N + 7) / 8 * 8; }

// Four float32 values, those at or past column n_valid of them zeroed,
// rounded to nearest even (st_cvt4) and stored at row `row`, columns
// col..col+3 of a bfloat16 copy of row stride ld (a multiple of 8, col one
// of 4: the four lie within the row's padding).
__device__ inline void st_copy4(bf16_t* copy, int ld, int row, int col, int n_valid, float4 v) {
  if (col + 1 > n_valid) v.x = 0.0f;
  if (col + 2 > n_valid) v.y = 0.0f;
  if (col + 3 > n_valid) v.z = 0.0f;
  if (col + 4 > n_valid) v.w = 0.0f;
  st_cvt4(copy + (long long)row * ld + col, v);
}

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
  if (e.y_bf != nullptr && row < e.M)
    st_copy4(e.y_bf, e.ld_bf, row, col, e.N, make_float4(v[0], v[1], v[2], v[3]));
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
    if (e.dedx_bf != nullptr && row < e.M)
      st_copy4(e.dedx_bf, e.ld_bf, row, col, e.N, make_float4(g[0], g[1], g[2], g[3]));
  }
}

// The float32 form's split of K, which defines the order of its sums: the
// output in tiles of kFwdPlanBM x kFwdPlanBN (the two-launch form's, which
// split K over its grid), and enough chunks to put about four such tiles on
// each of the card's 132 SMs, at most 16, in chunks that are multiples of the
// K step (32).  A function of the shape alone, whatever tile f32_fwd_kernel
// uses: every output of a layer is the sum over these chunks in order of each
// chunk's sum, so the sums do not move when the kernel's tiles do.  -> the
// chunk length; *n_chunks the count.
constexpr int kFwdPlanBM = 32, kFwdPlanBN = 64, kFwdBK = 32;

inline int fwd_k_chunk(int M, int K, int N, int* n_chunks) {
  const int tiles = ((N + kFwdPlanBN - 1) / kFwdPlanBN) * ((M + kFwdPlanBM - 1) / kFwdPlanBM);
  int want = (4 * 132 + tiles - 1) / tiles;
  want = want < 1 ? 1 : (want > 16 ? 16 : want);
  int chunk = ((K + want - 1) / want + kFwdBK - 1) / kFwdBK * kFwdBK;
  if (chunk < kFwdBK) chunk = kFwdBK;
  *n_chunks = K > 0 ? (K + chunk - 1) / chunk : 1;
  return chunk;
}

// Kernel 1, tensor-core form: the same function with rne(x * in_mask) @
// rne(W) in place of the float32 product (rne: rounded to bfloat16, to
// nearest even; the mask and its scale are applied in float32 before the
// rounding, as the TPU kernel scales h before its _dot rounds it), float32
// sums on mma.sync m16n8k16.
//
// Bound: bytes.  A bunch of 128 rows does 256 FLOP per element of W, 64 per
// byte of float32 W, under the 295 FLOP/byte at which the tensor cores would
// limit; so every W tile is read from device memory once, and enough of them
// are in flight to keep the memory busy:
// * one block owns ALL the rows of its tile (up to kTcFwdBM = 128: a bunch,
//   or a data-parallel rank's 64 or 32) and a BN-column slice of W (BN = 64
//   or 128, tc_fwd_bn); x is read once per column slice, from L2;
// * K is split over the blocks of one thread-block cluster (up to 16, along
//   the grid's z; above 8 only for the narrow layers' few column slices,
//   with the non-portable cluster size): each block multiplies its K chunk,
//   keeps its partial tile in shared memory, and after cluster.sync() sums
//   its share of the tile's rows over every block's partial through
//   distributed shared memory, in cluster-rank order (each output's sum
//   depends only on the chunk boundaries and that order), and runs
//   fwd_epilogue4 on the sums.  No scratch in device memory and no second
//   launch.  The split is sized so that every cluster of the grid is
//   resident at once (tc_fwd_k_chunk);
// * operands arrive through a ring of kTcFwdStages stages filled by the
//   Tensor Memory Accelerator: one 2-D tile copy for x's (128, 32) and one
//   for W's (32, BN) a step, zero-filled past every edge, completing on the
//   slot's mbarrier.  (cp.async from every thread was measured first:
//   starting the copies stalled each step on the SM's load queue, and one
//   1-D bulk copy a row was slower still.)  A tensor map needs rows whose
//   stride is a multiple of 16 bytes: W at N = 129 or 257 (float32) goes by
//   4-byte cp.async copies, and at odd N in bfloat16 (2-byte aligned)
//   through registers; so does x if K % 4 != 0;
// * step s+1 is rounded to bfloat16 (the mask applied first), two values an
//   instruction (st_cvt4), into one of two tiles while step s is multiplied
//   from the other: one barrier a step;
// * x as its bfloat16 copy (TX = bf16_t; FwdCopies::x): where the launch that
//   made x also stored rne(x) beside it (a hidden layer's input: the epilogue
//   of the layer below, after its mask), the tensor copy brings that, in
//   (128, 32) boxes of 64-byte rows with the copy's 64-byte swizzle, and the
//   products read the ring's box in place (load_a_sw64): no rounding pass over
//   x, no tile for it, half of x's bytes through L2 and the ring.  The split
//   of K is the float32-x form's (tc_fwd_k_chunk), and so are W's rounding,
//   the products' order, the cluster sum and the epilogue: every output is
//   that form's bit for bit.  An input with a mask (layer 0) comes as float32.
// Warps: 32 x 32 tiles of the block's (128, BN), each 2 x 4 m16n8k16 tiles
// (larger warp tiles, fewer warps, were measured slower: the rounding pass
// and the ldmatrix / mma chains are latency-bound at one block an SM);
// warps whose rows lie past the tile's skip their work.  Where the time goes
// (PERF.md; the float32-x form): a step's rounding and its products take
// about as long as each other and the copies rarely keep them waiting; what
// comes before the loop (the first tiles' latency) and after it (two cluster
// barriers and the sum through distributed shared memory; one bulk copy
// between the blocks in place of the remote loads was no faster) costs about
// as much as the loop at these sizes.
constexpr int kTcFwdBM = 128, kTcFwdBK = 32, kTcFwdStages = 4, kTcFwdMaxCluster = 16;
constexpr int kTcFwdALd = kTcFwdBK + 8;  // bfloat16 row stride of 80 bytes: an odd multiple of
                                         // 16, so ldmatrix's eight rows hit all 32 banks

// TX: x's storage, float32 or its bfloat16 copy (rne(x)).
template <typename TW, int BN, typename TX>
struct TcFwdTile {
  static constexpr bool kXCopy = std::is_same<TX, bf16_t>::value;  // x comes rounded
  static constexpr int kWM = 32, kWN = 32;  // a warp's tile (see above)
  static constexpr int kWarps = (kTcFwdBM / kWM) * (BN / kWN), kThreads = 32 * kWarps;
  static constexpr int kBLd = BN + 8;  // bfloat16: an odd multiple of 16 bytes
  static constexpr int kPLd = BN + 4;
  // of the stages: the copy's swizzle repeats every 512 bytes of the ring
  static constexpr int kAlign = kXCopy ? 1024 : 128;
  struct alignas(kAlign) Stage {  // the tensor copies' boxes, dense
    TX x[kTcFwdBM][kTcFwdBK];     // x rows of the step, as stored (x's copy swizzled: sw64)
    TW w[kTcFwdBK][BN];           // W rows of the step, as stored
  };
  struct NoTile {};
  struct alignas(kAlign) Smem {
    union {
      Stage ring[kTcFwdStages];
      float part[kTcFwdBM][kPLd];  // the block's partial sums, after the K loop
    } u;
    // rne(x * mask), (m, k), where x comes as float32
    std::conditional_t<kXCopy, NoTile, bf16_t[2][kTcFwdBM][kTcFwdALd]> a;
    alignas(16) bf16_t b[2][kTcFwdBK][kBLd];  // rne(W), (k, n)
    uint64_t full[kTcFwdStages];              // a ring slot's bulk copies have landed
  };
  static constexpr int kSmemBytes = (int)sizeof(Smem) + kAlign;  // + its alignment
};

// The dynamic shared memory a block of tc_fwd_kernel<TW, BN, ...> asks for in
// either form of x: the float32-x form's, so that a block of the next launch
// shares an SM with one of this launch only where it would beside that form.
// (Asking only what its layout takes, the head's copy form let a block of the
// backward after it in beside it, and the chain ran 2.7% slower a bunch at
// 8 kHz and 2.9% at 16 kHz on an H100 SXM than with this.)
template <typename TW, int BN>
constexpr int tc_fwd_smem_bytes() {
  static_assert(TcFwdTile<TW, BN, bf16_t>::kSmemBytes <= TcFwdTile<TW, BN, float>::kSmemBytes,
                "the copy form's layout fits the float32-x form's request");
  return TcFwdTile<TW, BN, float>::kSmemBytes;
}

__device__ inline void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// mbarriers and the Tensor Memory Accelerator's 2-D tile copy.
__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
// expects `bytes` more on the barrier's phase without arriving: the first half of a
// slot whose arrival comes with its second half
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity) : "memory");
}
// The box of `map` at (c0 inner, c1 outer) into shared memory at dst
// (128-byte aligned), completing on bar; past the tensor's edges it writes zeros.
__device__ inline void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)) : "memory");
}

// the 128-byte line at p into L2
__device__ inline void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// the tensor map's descriptor into the cache ahead of the first copy
__device__ inline void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ inline float4 widen4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 widen4(const bf16_t* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xFFFF0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xFFFF0000u));
}

// The end of both forwards where K is split over a cluster: with every
// block's partial tile written to its shared memory (`part`, row stride ld),
// cluster.sync(); this block's share of the tile's `rows` rows summed over
// the cluster's partials in rank (chunk) order from 0.0f, eight ranks' loads
// in flight at once (each output's sum depends only on the chunk boundaries
// and that order), and fwd_epilogue4 on the sums; cluster.sync() again, so
// that no block leaves while another still reads its partial tile.
template <int BN, int kThreads>
__device__ inline void fwd_cluster_sum(const float* part, int ld, int rows, int m0, int n0,
                                       const FwdEpilogue& epi) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial tile is complete
  const int n_ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (rows + n_ranks - 1) / n_ranks, r0 = rank * per, r1 = min(rows, r0 + per);
  for (int idx = threadIdx.x; idx < (r1 > r0 ? r1 - r0 : 0) * (BN / 4); idx += kThreads) {
    const int row = r0 + idx / (BN / 4), col = (idx % (BN / 4)) * 4;
    if (n0 + col >= epi.N) continue;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q0 = 0; q0 < n_ranks; q0 += 8) {
      float4 p[8];  // eight ranks' partials first, so the reads overlap
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < n_ranks)
          p[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part + row * ld + col, q0 + q));
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < n_ranks) {
          s[0] += p[q].x; s[1] += p[q].y; s[2] += p[q].z; s[3] += p[q].w;
        }
    }
    fwd_epilogue4(epi, m0 + row, n0 + col, s);
  }
  cluster.sync();  // no block leaves while another still reads its partial tile
}

// x_tma / w_tma: the operand goes by tensor copies (tmx, tmw), else by
// cp.async: 4-byte copies for float32 (x when K % 4 != 0, W when N % 4 != 0),
// registers for bfloat16 W at an odd N.  x's bfloat16 copy (TX = bf16_t)
// always goes by tensor copies and takes no mask.  early (pdl.cuh): with
// kEarlyW the W half of the first kTcFwdStages - 1 steps is loaded before
// griddepcontrol.wait, beside the mbarriers' set-up; x and every store come
// after it.
template <typename TW, int BN, typename TX>
__global__ void __launch_bounds__(TcFwdTile<TW, BN, TX>::kThreads)
tc_fwd_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
              const TX* __restrict__ x, const TW* __restrict__ w, int M, int K, int N,
              MaskSpec in_mask, FwdEpilogue epi, int k_chunk, bool x_tma, bool w_tma,
              int early) {
  using T = TcFwdTile<TW, BN, TX>;
  constexpr bool kXCopy = T::kXCopy;
  constexpr int kThreads = T::kThreads, kS = kTcFwdStages;
  extern __shared__ unsigned char tc_fwd_smem[];
  typename T::Smem& sm = *reinterpret_cast<typename T::Smem*>(
      (reinterpret_cast<uintptr_t>(tc_fwd_smem) + T::kAlign - 1) & ~(uintptr_t)(T::kAlign - 1));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcFwdBM;
  const int rows = min(kTcFwdBM, M - m0);      // the tile's rows
  constexpr int kWM = T::kWM, kWN = T::kWN;
  const int rows_pad = (rows + kWM - 1) / kWM * kWM;  // whole warp bands
  const int wm = (warp / (BN / kWN)) * kWM, wn = (warp % (BN / kWN)) * kWN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kTcFwdBK - 1) / kTcFwdBK : 0;
  const bool any_tma = x_tma || w_tma, all_tma = x_tma && w_tma;

  // step `step`'s x and / or W into ring slot `slot`: thread 0 posts the
  // tensor copies' bytes on the slot's mbarrier and starts them; every
  // thread starts its cp.async copies of an operand that has no tensor map
  // (zero-filled past the edges).  The slot's one arrival comes with its x,
  // which is never loaded before its W: a W loaded ahead only adds its bytes
  auto load_stage = [&](int slot, int step, bool with_x, bool with_w) {
    typename T::Stage& st = sm.u.ring[slot];
    const int k0 = k_begin + step * kTcFwdBK;
    const bool tx = with_x && x_tma, tw = with_w && w_tma;
    if (any_tma && tid == 0) {  // the slot's bytes; a copy may land first (the phase waits)
      const uint32_t bytes =
          (tx ? (uint32_t)sizeof(st.x) : 0u) + (tw ? (uint32_t)sizeof(st.w) : 0u);
      if (with_x)
        mbar_arrive_expect_tx(&sm.full[slot], bytes);
      else
        mbar_expect_tx(&sm.full[slot], bytes);
      if (tx) tma_load_2d(&st.x[0][0], &tmx, k0, m0, &sm.full[slot]);
    }
    if (tw && tid == 32) tma_load_2d(&st.w[0][0], &tmw, n0, k0, &sm.full[slot]);
    if constexpr (!kXCopy) {
      if (with_x && !x_tma) {
        for (int idx = tid; idx < kTcFwdBM * kTcFwdBK; idx += kThreads) {
          const int row = idx / kTcFwdBK, c = idx % kTcFwdBK;
          if (row >= rows_pad) continue;
          const bool in = row < rows && k0 + c < K;
          cp_async4(&st.x[row][c], in ? x + (long long)(m0 + row) * K + k0 + c : x, in ? 4 : 0);
        }
      }
    }
    if (with_w && !w_tma) {
      for (int idx = tid; idx < kTcFwdBK * BN; idx += kThreads) {
        const int kr = idx / BN, c = idx % BN;
        const bool in = k0 + kr < K && n0 + c < N;
        if constexpr (std::is_same<TW, bf16_t>::value) {  // 2-byte aligned: registers
          st.w[kr][c] = in ? w[(long long)(k0 + kr) * N + n0 + c] : (TW)0;
        } else {
          cp_async4(&st.w[kr][c], in ? w + (long long)(k0 + kr) * N + n0 + c : w, in ? 4 : 0);
        }
      }
    }
  };

  // wait until step `step` is in its slot, seen by every thread
  auto wait_stage = [&](int step) {
    if (any_tma) mbar_wait(&sm.full[step % kS], (step / kS) & 1);
    if (!all_tma) {
      cp_async_wait<kS - 2>();
      __syncthreads();
    }
  };

  // A table mask (mode 3): a step is one word of each of the tile's rows
  // (k_begin and the step are multiples of 32), and a thread's words of the
  // next step are loaded while this one converts, so that the table's latency
  // hides behind a step's products (loaded further ahead, they ran slower).
  constexpr int kXIters = kTcFwdBM * kTcFwdBK / 4 / kThreads;  // float4s of x a thread converts
  const bool table = !kXCopy && in_mask.mode == 3;
  uint32_t words[kXIters];  // the words of the next step to convert
  auto load_words = [&](int step) {
    const int k0 = k_begin + step * kTcFwdBK;
#pragma unroll
    for (int r = 0; r < kXIters; ++r) {
      const int row = (tid + r * kThreads) / (kTcFwdBK / 4);
      words[r] = table && step < n_steps && row < rows ? mask_word(in_mask, m0 + row, k0) : 0u;
    }
  };

  // the step's operands, rounded: x masked in float32 first (x's copy comes
  // rounded, and the products read it in its ring slot)
  auto convert = [&](int slot, int buf, int step) {
    const typename T::Stage& st = sm.u.ring[slot];
    if constexpr (!kXCopy) {
      const int k0 = k_begin + step * kTcFwdBK;
      uint32_t cur[kXIters];
#pragma unroll
      for (int r = 0; r < kXIters; ++r) cur[r] = words[r];
      if (table) load_words(step + 1);
#pragma unroll
      for (int r = 0; r < kXIters; ++r) {
        const int idx = tid + r * kThreads, row = idx / (kTcFwdBK / 4);
        const int c = (idx % (kTcFwdBK / 4)) * 4;
        if (row >= rows_pad) continue;
        float4 v = *reinterpret_cast<const float4*>(&st.x[row][c]);
        if (in_mask.mode != 0 && row < rows && k0 + c < K) {
          float mk[4];
          if (table)
            mask4_word(in_mask, cur[r], k0 + c, K, mk);
          else
            mask4(in_mask, m0 + row, k0 + c, K, mk);
          v.x *= mk[0]; v.y *= mk[1]; v.z *= mk[2]; v.w *= mk[3];
        }
        st_cvt4(&sm.a[buf][row][c], v);
      }
    }
#pragma unroll
    for (int r = 0; r < kTcFwdBK * BN / 4 / kThreads; ++r) {
      const int idx = tid + r * kThreads, kr = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      st_cvt4(&sm.b[buf][kr][c], widen4(&st.w[kr][c]));
    }
  };

  float acc[kWM / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  // step s: W's rounded tile `buf`, x's rounded tile `buf` or its copy in ring slot `slot`
  auto mma_step = [&](int buf, int slot) {
    if (wm >= rows_pad) return;
#pragma unroll
    for (int kk = 0; kk < kTcFwdBK; kk += 16) {
      uint32_t a[kWM / 16][4], b[kWN / 16][4];
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i) {
        if constexpr (kXCopy)
          load_a_sw64(a[i], &sm.u.ring[slot].x[0][0], wm + 16 * i, kk, lane);
        else
          load_a(a[i], &sm.a[buf][wm + 16 * i][kk], kTcFwdALd, lane);
      }
#pragma unroll
      for (int j = 0; j < kWN / 16; ++j)
        load_b_kn(b[j], &sm.b[buf][kk][wn + 16 * j], T::kBLd, lane);
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWN / 8; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  };

  // The pipeline: kS - 1 steps in flight; step s+1 is rounded while step s
  // is multiplied (two bfloat16 buffers), one barrier a step.  Ring slot
  // (s - 1) % kS is refilled at step s: its rounding was two steps ago, and
  // the products that read x's copy there one step ago.
  // Before the wait: the mbarriers, the tensor maps, and W where the plan
  // allows (uncommitted cp.async copies of it join step 0's group)
  if (any_tma) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kS; ++i) mbar_init(&sm.full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (x_tma) prefetch_tensormap(&tmx);
      if (w_tma) prefetch_tensormap(&tmw);
    }
    __syncthreads();
  }
  const bool early_w = (early & kEarlyW) != 0;
  if (early_w) {
#pragma unroll
    for (int s = 0; s < kS - 1; ++s)
      if (s < n_steps) load_stage(s, s, false, true);
  }
  grid_dep_wait();  // every thread, a block without steps too: it stores the epilogue
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_steps) load_stage(s, s, true, !early_w);
    if (!all_tma) cp_async_commit();  // one group per step, empty or not: the wait counts steps
  }
  if (table) load_words(0);
  if (n_steps > 0) {
    wait_stage(0);
    convert(0, 0, 0);
  }
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int ahead = s + kS - 1;
    if (ahead < n_steps) load_stage(ahead % kS, ahead, true, true);
    if (!all_tma) cp_async_commit();
    if (s + 1 < n_steps) {
      wait_stage(s + 1);
      convert((s + 1) % kS, (s + 1) & 1, s + 1);
    }
    mma_step(s & 1, s % kS);
    __syncthreads();
  }
  if (!all_tma) cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place
  grid_dep_launch_dependents();  // the next launch's prologue overlaps the cluster sum

  const int g = lane >> 2, t = lane & 3;
  if (wm < rows_pad) {
#pragma unroll
    for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const int row = wm + i * 16 + g, col = wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(&sm.u.part[row][col]) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(&sm.u.part[row + 8][col]) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
  fwd_cluster_sum<BN, kThreads>(&sm.u.part[0][0], T::kPLd, rows, m0, n0, epi);
}

// The column slice of the tensor-core forward: 128 for wide layers, 64 for
// narrow ones (N = 129 and 257: fewer empty columns in the last slice).
inline int tc_fwd_bn(int N) { return N > 512 ? 128 : 64; }

// Kernel 1, float32 form (f32_fwd_kernel): act(mask_in(x) @ W + b) with
// float32 FMA products, one launch a layer, on tc_fwd_kernel's cluster split.
//
// Bound: operations, narrowly (a bunch of 128 does 64 FLOP a byte of float32
// W against the FP32 pipe's 20).  At a bunch of 128 the output tiles alone
// are too few blocks for the card, so K is split, into fwd_k_chunk's chunks
// (5 at the 1548- to 3084-deep layers of width 2048, 16 at the heads: the
// split that defines the sums' order).  The chunks of one output tile are the
// blocks of a thread-block cluster along the grid's z (up to 16, above 8 with
// the non-portable cluster size): each block sums its chunk into registers,
// keeps its partial tile in shared memory, and fwd_cluster_sum adds the
// partials in chunk order from 0.0f through distributed shared memory.  No
// scratch in device memory, no second launch.  Every output is summed as the
// two-launch form this replaced summed it, bit for bit: one thread a chunk's
// sum, fmaf(x * mask, w, acc) for k ascending from 0.0f (zeros past K, as
// there); the chunks' sums added in order from 0.0f; a K that is not split
// (one chunk) handed to the epilogue as it is.
// * a block: 64 x 64 outputs, 128 threads, each 8 rows (tm + 8 i) by 4
//   neighbouring columns.  At a 2048-wide layer that is 2 x 32 x 5 = 320
//   blocks on 3 x 132 slots (shared memory fits three an SM; clusters of 5
//   leave 8 SMs empty: 72 SMs hold 3 blocks, 52 hold 2, measured), where
//   128-row tiles would give 160: two blocks on some SMs, one on the rest;
// * x and W come through a ring of kF32FwdStages stages of 32 k, filled by
//   tensor copies that thread 0 issues (zeros past every edge).  x's box is
//   swizzled by 128 bytes (f32_fwd_x), so the 8 rows a warp reads at one k
//   lie in 8 different bank groups.  For each 4 k a thread reads a float4 of
//   x from each of its 8 rows and a float4 of W a k: 12 floats for 32 FMAs a
//   k.  An SM's shared memory gives 32 floats a clock (a warp's 16-byte load
//   takes four wavefronts whatever it broadcasts) against 128 FMAs, so the
//   loop is held by shared memory at two thirds of the FP32 pipe's rate, and
//   runs at about that (PERF.md).  8 x 8 tiles would balance the two,
//   but at a bunch of 128 they leave 5 warps an SM, too few to hide a shared
//   load's latency: they ran 28% slower (measured, variants of this kernel);
// * in_mask: each stage's x is masked in place in float32 (one pass and a
//   barrier) before the products, as the two-launch form masked it (a
//   table's words loaded a step ahead; the pass and its barrier stay, and
//   cost layer 0 about 0.009 ms at 8 kHz on an H100: PERF.md);
// * W without a tensor map (N * sizeof(TW) % 16 != 0: N = 129, 257) goes by
//   4-byte cp.async (float32) or through registers (bfloat16), and x without
//   one (K % 4 != 0) by 4-byte cp.async into its swizzled places;
// * dependent launches (pdl.cuh) as tc_fwd_kernel's: with kEarlyW the W half
//   of the first kF32FwdStages - 1 steps before griddepcontrol.wait; x and
//   every store after it; launch_dependents after the K loop.
constexpr int kF32FwdBM = 64, kF32FwdBN = 64, kF32FwdStages = 4, kF32FwdThreads = 128;

template <typename TW>
struct F32FwdTile {
  struct alignas(1024) Stage {     // the tensor copies' boxes; x's swizzle repeats every 1 KB
    float x[kF32FwdBM][kFwdBK];    // x rows of the step, swizzled (f32_fwd_x)
    TW w[kFwdBK][kF32FwdBN];       // W rows of the step, as stored
  };
  struct alignas(1024) Smem {
    union {
      Stage ring[kF32FwdStages];
      float part[kF32FwdBM][kF32FwdBN + 4];  // the block's partial sums, after the K loop
    } u;
    uint64_t full[kF32FwdStages];  // a ring slot's copies have landed
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + its alignment
};

// Where x's (row r, column c) of a step lies in its stage: the tensor copy's
// 128-byte swizzle puts the 16-byte chunk c / 4 of row r at chunk (c / 4) ^ (r % 8).
__device__ inline int f32_fwd_x(int r, int c) {
  return r * kFwdBK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// x_tma / w_tma: the operand goes by tensor copies (tmx, tmw), else by
// cp.async or registers (above); early: pdl.cuh's bits (kEarlyW).  kTable:
// in_mask is a table (mode 3), whose words take registers through the K
// loop and whose pass is unrolled: an instance of its own, so that the other
// layers' code is as it was without tables.
template <typename TW, bool kTable>
__global__ void __launch_bounds__(kF32FwdThreads, 3)
f32_fwd_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
               const float* __restrict__ x, const TW* __restrict__ w, int M, int K, int N,
               MaskSpec in_mask, FwdEpilogue epi, int k_chunk, bool x_tma, bool w_tma,
               int early) {
  using T = F32FwdTile<TW>;
  constexpr int BM = kF32FwdBM, BN = kF32FwdBN, BK = kFwdBK, kS = kF32FwdStages;
  constexpr int kThreads = kF32FwdThreads;
  extern __shared__ unsigned char f32_fwd_smem[];
  // aligned by an offset from the array itself, not through an integer, so
  // that the compiler keeps it in the shared space: shared loads (LDS), where
  // a generic pointer would make every operand load a generic one
  typename T::Smem& sm = *reinterpret_cast<typename T::Smem*>(
      f32_fwd_smem + ((1024u - (smem_addr(f32_fwd_smem) & 1023u)) & 1023u));
  const int tid = threadIdx.x, tm = tid % 8, tn = tid / 8;  // rows tm + 8 i, columns 4 tn..
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const bool any_tma = x_tma || w_tma, all_tma = x_tma && w_tma;

  // step `step`'s x and / or W into ring slot `slot`, as tc_fwd_kernel's
  // load_stage: the slot's one arrival comes with its x
  auto load_stage = [&](int slot, int step, bool with_x, bool with_w) {
    typename T::Stage& st = sm.u.ring[slot];
    const int k0 = k_begin + step * BK;
    const bool tx = with_x && x_tma, tw = with_w && w_tma;
    if (any_tma && tid == 0) {
      const uint32_t bytes =
          (tx ? (uint32_t)sizeof(st.x) : 0u) + (tw ? (uint32_t)sizeof(st.w) : 0u);
      if (with_x)
        mbar_arrive_expect_tx(&sm.full[slot], bytes);
      else
        mbar_expect_tx(&sm.full[slot], bytes);
      if (tx) tma_load_2d(&st.x[0][0], &tmx, k0, m0, &sm.full[slot]);
      if (tw) tma_load_2d(&st.w[0][0], &tmw, n0, k0, &sm.full[slot]);
    }
    if (with_x && !x_tma) {
      for (int idx = tid; idx < BM * BK; idx += kThreads) {
        const int r = idx / BK, c = idx % BK;
        const bool in = m0 + r < M && k0 + c < K;
        cp_async4(&st.x[0][0] + f32_fwd_x(r, c), in ? x + (long long)(m0 + r) * K + k0 + c : x,
                  in ? 4 : 0);
      }
    }
    if (with_w && !w_tma) {
      for (int idx = tid; idx < BK * BN; idx += kThreads) {
        const int kr = idx / BN, c = idx % BN;
        const bool in = k0 + kr < K && n0 + c < N;
        if constexpr (std::is_same<TW, bf16_t>::value) {  // 2-byte aligned: registers
          st.w[kr][c] = in ? w[(long long)(k0 + kr) * N + n0 + c] : (TW)0;
        } else {
          cp_async4(&st.w[kr][c], in ? w + (long long)(k0 + kr) * N + n0 + c : w, in ? 4 : 0);
        }
      }
    }
  };

  // Before the wait: the mbarriers, the tensor maps, and W where the plan
  // allows (uncommitted cp.async copies of it join step 0's group)
  if (any_tma) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kS; ++i) mbar_init(&sm.full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (x_tma) prefetch_tensormap(&tmx);
      if (w_tma) prefetch_tensormap(&tmw);
    }
    __syncthreads();
  }
  const bool early_w = (early & kEarlyW) != 0;
  if (early_w) {
#pragma unroll
    for (int s = 0; s < kS - 1; ++s)
      if (s < n_steps) load_stage(s, s, false, true);
  }
  grid_dep_wait();  // every thread, a block without steps too: it stores the epilogue
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_steps) load_stage(s, s, true, !early_w);
    if (!all_tma) cp_async_commit();  // one group per step, empty or not: the wait counts steps
  }

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // A table mask (mode 3): a step is one word of each of the tile's rows
  // (k_begin and BK are multiples of 32), and a thread's words of the next
  // step are loaded while this one's products run, so that the table's
  // latency hides behind them.
  constexpr int kXIters = BM * BK / 4 / kThreads;  // float4s of x a thread masks
  [[maybe_unused]] uint32_t words[kXIters];
  auto load_words = [&](int step) {
    const int k0 = k_begin + step * BK;
#pragma unroll
    for (int j = 0; j < kXIters; ++j) {
      const int r = (tid + j * kThreads) / (BK / 4);
      words[j] = step < n_steps && m0 + r < M ? mask_word(in_mask, m0 + r, k0) : 0u;
    }
  };
  if constexpr (kTable) load_words(0);

  // kS - 1 steps in flight; step s + kS - 1 goes into the slot step s - 1
  // was read from, which the barrier ending step s - 1 has released
  for (int s = 0; s < n_steps; ++s) {
    const int ahead = s + kS - 1;
    if (ahead < n_steps) load_stage(ahead % kS, ahead, true, true);
    if (!all_tma) cp_async_commit();
    if (any_tma) mbar_wait(&sm.full[s % kS], (s / kS) & 1);
    if (!all_tma) {
      cp_async_wait<kS - 1>();
      __syncthreads();
    }
    float* xs = &sm.u.ring[s % kS].x[0][0];
    const TW* ws = &sm.u.ring[s % kS].w[0][0];
    if (in_mask.mode != 0) {  // x * mask in float32, in place
      const int k0 = k_begin + s * BK;
      if constexpr (kTable) {
        uint32_t cur[kXIters];
#pragma unroll
        for (int j = 0; j < kXIters; ++j) cur[j] = words[j];
        load_words(s + 1);
#pragma unroll
        for (int j = 0; j < kXIters; ++j) {
          const int idx = tid + j * kThreads, r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
          if (m0 + r >= M || k0 + c >= K) continue;
          float mk[4];
          mask4_word(in_mask, cur[j], k0 + c, K, mk);
          float4* p = reinterpret_cast<float4*>(xs + f32_fwd_x(r, c));
          float4 v = *p;
          v.x *= mk[0]; v.y *= mk[1]; v.z *= mk[2]; v.w *= mk[3];
          *p = v;
        }
      } else {
        for (int idx = tid; idx < BM * BK / 4; idx += kThreads) {
          const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
          if (m0 + r >= M || k0 + c >= K) continue;
          float mk[4];
          mask4(in_mask, m0 + r, k0 + c, K, mk);
          float4* p = reinterpret_cast<float4*>(xs + f32_fwd_x(r, c));
          float4 v = *p;
          v.x *= mk[0]; v.y *= mk[1]; v.z *= mk[2]; v.w *= mk[3];
          *p = v;
        }
      }
      // the slot's next tensor copy (step s + kS) comes after these stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BK / 4; ++kk) {
      float4 xv[8];  // rows tm + 8 i, k = 4 kk..4 kk + 3 (row % 8 == tm: chunk kk ^ tm)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (tm + 8 * i) * BK + ((kk ^ tm) << 2));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = widen4(ws + (4 * kk + j) * BN + 4 * tn);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = j == 0 ? xv[i].x : (j == 1 ? xv[i].y : (j == 2 ? xv[i].z : xv[i].w));
          acc[i][0] = fmaf(a, wv.x, acc[i][0]);
          acc[i][1] = fmaf(a, wv.y, acc[i][1]);
          acc[i][2] = fmaf(a, wv.z, acc[i][2]);
          acc[i][3] = fmaf(a, wv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the slot is free for step s + kS
  }
  if (!all_tma) cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place
  grid_dep_launch_dependents();  // the next launch's prologue overlaps the cluster sum

  if (gridDim.z == 1) {  // K not split: the chunk's sums are the outputs'
    const int col = n0 + 4 * tn;
    if (col >= N) return;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (m0 + tm + 8 * i < M) fwd_epilogue4(epi, m0 + tm + 8 * i, col, acc[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(&sm.u.part[tm + 8 * i][4 * tn]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  fwd_cluster_sum<BN, kThreads>(&sm.u.part[0][0], BN + 4, min(BM, M - m0), m0, n0, epi);
}

constexpr int kTcFwdMaxDevices = 64;

// Per library (static: a function-local static of an inline function would
// be one object for the whole process, a unique symbol shared by every
// library that includes this header, though each has its own kernel to set
// up) and per device (a function attribute holds for the current device
// only): raises the shared memory of tc_fwd_kernel<TW, BN, TX> (kTc) or of
// f32_fwd_kernel<TW, kTable> once, and -> how many clusters of `size` blocks
// along z the card holds at once (cached; cudaErrorInvalidConfiguration where
// not one such cluster can be placed).
template <bool kTc, typename TW, int BN, bool kTable = false, typename TX = float>
static cudaError_t fwd_clusters(int size, int* clusters) {
  static bool attr_set[kTcFwdMaxDevices] = {};
  static int cached[kTcFwdMaxDevices][kTcFwdMaxCluster + 1] = {};
  const void* kernel;
  int threads;
  size_t smem;
  if constexpr (kTc) {
    kernel = (const void*)tc_fwd_kernel<TW, BN, TX>;
    threads = TcFwdTile<TW, BN, TX>::kThreads;
    smem = tc_fwd_smem_bytes<TW, BN>();
  } else {
    kernel = (const void*)f32_fwd_kernel<TW, kTable>;
    threads = kF32FwdThreads;
    smem = F32FwdTile<TW>::kSmemBytes;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kTcFwdMaxDevices) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)  // clusters above 8 blocks (the narrow layers' few column slices)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && !kTc)  // all of the SM's shared memory: three blocks an SM
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (cached[dev][size] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, size);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = size;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;  // such a cluster cannot be placed
    cached[dev][size] = n;
  }
  *clusters = cached[dev][size];
  return cudaSuccess;
}

// How the tensor-core forward splits K: into as many chunks of whole K steps
// as make the grid fill the blocks the card holds at once, at most
// kTcFwdMaxCluster, and fewer where every cluster of the grid could not then
// be resident at once (a second wave of clusters would double the time).
// A function of (M, K, N) and the card alone, and of K, N and the card
// while M fits one row tile (M <= 128): a data-parallel rank's rows are
// summed as the single-device trainer sums them.  Planned on the float32-x
// form for both forms of x, so that the form that reads x's bfloat16 copy
// sums as that one does.  -> the chunk; *n_chunks.
template <typename TW, int BN>
static cudaError_t tc_fwd_k_chunk(int M, int K, int N, int* chunk, int* n_chunks) {
  const int tiles = ((N + BN - 1) / BN) * ((M + kTcFwdBM - 1) / kTcFwdBM);
  int one = 0;
  cudaError_t err = fwd_clusters<true, TW, BN>(1, &one);  // blocks the card holds at once
  if (err != cudaSuccess) return err;
  int c = (one + tiles - 1) / tiles;
  c = c < 1 ? 1 : (c > kTcFwdMaxCluster ? kTcFwdMaxCluster : c);
  for (;; --c) {
    *chunk = ((K + c - 1) / c + kTcFwdBK - 1) / kTcFwdBK * kTcFwdBK;
    if (*chunk < kTcFwdBK) *chunk = kTcFwdBK;
    *n_chunks = K > 0 ? (K + *chunk - 1) / *chunk : 1;
    if (*n_chunks == 1) return cudaSuccess;
    int fit = 0;
    err = fwd_clusters<true, TW, BN>(*n_chunks, &fit);
    if (err != cudaSuccess) return err;
    if (tiles <= fit) return cudaSuccess;
  }
}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point query
// (the libraries link the runtime only).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of a row-major (rows, cols) array at p, rows `ld` elements
// apart (0: cols), read in boxes of (box_rows, box_cols), zeros past its
// edges, each box row `swizzle`d in shared memory (none: as stored).
static cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                                 int rows, int cols, int elem_bytes, int box_rows, int box_cols,
                                 CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE,
                                 int ld = 0) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = (EncodeTiledFn)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : cols) * (cuuint64_t)elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x_bf (nullptr: none): x's bfloat16 copy, read in place of x (bf16_ld(K)
// a row, 16-byte aligned; the caller passes no mask with it).  pdl: a
// programmatic dependent launch that reads before its wait what `early`
// names (pdl.cuh).
template <typename TW, int BN>
static cudaError_t launch_tc_fwd_bn(const float* x, const bf16_t* x_bf, const TW* w, int M, int K,
                                    int N, const MaskSpec& in_mask, const FwdEpilogue& epi,
                                    int plan_rows, bool pdl, int early, cudaStream_t stream) {
  int k_chunk, n_chunks;
  cudaError_t err =
      tc_fwd_k_chunk<TW, BN>(plan_rows > 0 ? plan_rows : M, K, N, &k_chunk, &n_chunks);
  if (err != cudaSuccess) return err;
  // tensor maps where the rows' stride is a multiple of 16 bytes
  CUtensorMap tmx = {}, tmw = {};
  const bool x_tma =
      x_bf != nullptr || ((reinterpret_cast<uintptr_t>(x) & 15u) == 0 && K % 4 == 0);
  const bool w_tma = (reinterpret_cast<uintptr_t>(w) & 15u) == 0 &&
                     ((long long)N * (long long)sizeof(TW)) % 16 == 0;
  if (x_bf != nullptr) {
    // the float32-x form's split: this form asks as much shared memory of as
    // many threads (tc_fwd_smem_bytes), so its grid is resident wherever that
    // one's is
    int fit = 0;
    err = fwd_clusters<true, TW, BN, false, bf16_t>(n_chunks, &fit);  // its attributes
    if (err != cudaSuccess) return err;
    err = tensor_map_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT16, x_bf, M, K, 2, kTcFwdBM, kTcFwdBK,
                        CU_TENSOR_MAP_SWIZZLE_64B, bf16_ld(K));
    if (err != cudaSuccess) return err;
  } else if (x_tma) {
    err = tensor_map_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, M, K, 4, kTcFwdBM, kTcFwdBK);
    if (err != cudaSuccess) return err;
  }
  if (w_tma) {
    err = tensor_map_2d(&tmw,
                        sizeof(TW) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                        w, K, N, (int)sizeof(TW), kTcFwdBK, BN);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + kTcFwdBM - 1) / kTcFwdBM, n_chunks);
  cfg.blockDim = dim3(TcFwdTile<TW, BN, float>::kThreads);
  cfg.dynamicSmemBytes = tc_fwd_smem_bytes<TW, BN>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;
  cfg.numAttrs = cluster_launch_attrs(attr, 1, n_chunks, pdl);
  if (x_bf != nullptr)
    return cudaLaunchKernelEx(&cfg, tc_fwd_kernel<TW, BN, bf16_t>, tmx, tmw, x_bf, w, M, K, N,
                              in_mask, epi, k_chunk, x_tma, w_tma, early);
  return cudaLaunchKernelEx(&cfg, tc_fwd_kernel<TW, BN, float>, tmx, tmw, x, w, M, K, N, in_mask,
                            epi, k_chunk, x_tma, w_tma, early);
}

template <typename TW>
static cudaError_t launch_tc_fwd(const float* x, const bf16_t* x_bf, const TW* w, int M, int K,
                                 int N, const MaskSpec& in_mask, const FwdEpilogue& epi,
                                 int plan_rows, bool pdl, int early, cudaStream_t stream) {
  if (tc_fwd_bn(N) == 128)
    return launch_tc_fwd_bn<TW, 128>(x, x_bf, w, M, K, N, in_mask, epi, plan_rows, pdl, early,
                                     stream);
  return launch_tc_fwd_bn<TW, 64>(x, x_bf, w, M, K, N, in_mask, epi, plan_rows, pdl, early,
                                  stream);
}

// pdl: a programmatic dependent launch that reads before its wait what
// `early` names (pdl.cuh).  K split into fwd_k_chunk's chunks for plan_rows
// rows (0: M), one cluster of blocks an output tile.
template <typename TW>
static cudaError_t launch_f32_fwd(const float* x, const TW* w, int M, int K, int N,
                                  const MaskSpec& in_mask, const FwdEpilogue& epi, int plan_rows,
                                  bool pdl, int early, cudaStream_t stream) {
  int n_chunks, fit = 0;
  const int k_chunk = fwd_k_chunk(plan_rows > 0 ? plan_rows : M, K, N, &n_chunks);
  const bool table = in_mask.mode == 3;
  cudaError_t err = table ? fwd_clusters<false, TW, kF32FwdBN, true>(n_chunks, &fit)
                          : fwd_clusters<false, TW, kF32FwdBN, false>(n_chunks, &fit);
  if (err != cudaSuccess) return err;
  // tensor maps where the rows' stride is a multiple of 16 bytes
  CUtensorMap tmx = {}, tmw = {};
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool x_tma = K > 0 && aligned(x) && K % 4 == 0;
  const bool w_tma = K > 0 && aligned(w) && ((long long)N * (long long)sizeof(TW)) % 16 == 0;
  if (x_tma) {
    err = tensor_map_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, M, K, 4, kF32FwdBM, kFwdBK,
                        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  if (w_tma) {
    err = tensor_map_2d(&tmw,
                        sizeof(TW) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                        w, K, N, (int)sizeof(TW), kFwdBK, kF32FwdBN);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kF32FwdBN - 1) / kF32FwdBN, (M + kF32FwdBM - 1) / kF32FwdBM, n_chunks);
  cfg.blockDim = dim3(kF32FwdThreads);
  cfg.dynamicSmemBytes = F32FwdTile<TW>::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;
  cfg.numAttrs = cluster_launch_attrs(attr, 1, n_chunks, pdl);
  if (table)
    return cudaLaunchKernelEx(&cfg, f32_fwd_kernel<TW, true>, tmx, tmw, x, w, M, K, N, in_mask,
                              epi, k_chunk, x_tma, w_tma, early);
  return cudaLaunchKernelEx(&cfg, f32_fwd_kernel<TW, false>, tmx, tmw, x, w, M, K, N, in_mask, epi,
                            k_chunk, x_tma, w_tma, early);
}

// The float32 forward's plan for (M, K, N), K split as for plan_rows rows (0:
// M): out[0] the chunk length, out[1] the chunks (a cluster's blocks), out[2]
// the grid's blocks, out[3] the blocks of f32_fwd_kernel the card holds at
// once, out[4] the clusters of out[1] blocks it holds at once.
template <typename TW>
static cudaError_t f32_fwd_plan(int M, int K, int N, int plan_rows, int out[5]) {
  out[0] = fwd_k_chunk(plan_rows > 0 ? plan_rows : M, K, N, &out[1]);
  out[2] = ((N + kF32FwdBN - 1) / kF32FwdBN) * ((M + kF32FwdBM - 1) / kF32FwdBM) * out[1];
  const cudaError_t err = fwd_clusters<false, TW, kF32FwdBN>(1, &out[3]);
  return err != cudaSuccess ? err : fwd_clusters<false, TW, kF32FwdBN>(out[1], &out[4]);
}

// The bfloat16 copies of a forward (bf16_ld rows, 16-byte aligned; nullptr:
// none): the copy of x that the tensor-core form reads in place of x (rne(x),
// written by the launch that made x: an input without a mask), and the
// copies of y and of dedx that the epilogue stores beside them, rne(y) for
// the next layer's tensor-core forward and rne(dedx) for the tensor-core
// backward.
struct FwdCopies {
  const bf16_t* x = nullptr;
  bf16_t* y = nullptr;
  bf16_t* dedx = nullptr;
};

// tc: the tensor-core form (tc_fwd_kernel), else the float32 one
// (f32_fwd_kernel); either is one launch, K split within a cluster.
// copies: as FwdCopies says; copies.x only in the tensor-core form, without
// an input mask, copies.dedx only with dedx.  plan_rows > 0: split K as for
// that many rows (the data-parallel trainer plans for the global tile, so a
// rank's rows are summed in the order the single-device trainer sums them:
// each output's sum depends only on the chunk boundaries), else as for M.
// pdl, early: a programmatic dependent launch that reads before its wait what
// `early` names (pdl.cuh).
template <typename TW>
inline cudaError_t launch_fwd(const float* x, const TW* w, const float* b, float* y, int M,
                              int K, int N, int act, const MaskSpec& in_mask,
                              const MaskSpec& out_mask, const float* targ, float* dedx,
                              const FwdCopies& copies, float coef, bool tc, cudaStream_t stream,
                              int plan_rows = 0, bool pdl = false, int early = 0) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  if ((copies.dedx != nullptr && (dedx == nullptr || !aligned(copies.dedx))) ||
      !aligned(copies.y) ||
      (copies.x != nullptr && (!tc || in_mask.mode != 0 || !aligned(copies.x))))
    return cudaErrorInvalidValue;
  FwdEpilogue epi;
  epi.b = b;
  epi.y = y;
  epi.M = M;
  epi.N = N;
  epi.act = act;
  epi.out_mask = out_mask;
  epi.targ = targ;
  epi.dedx = dedx;
  epi.y_bf = copies.y;
  epi.dedx_bf = copies.dedx;
  epi.ld_bf = bf16_ld(N);
  epi.coef = coef;
  epi.vec_y = vec_ok(y, N) && (dedx == nullptr || vec_ok(dedx, N));
  epi.vec_t = targ != nullptr && vec_ok(targ, N);
  return tc ? launch_tc_fwd(x, copies.x, w, M, K, N, in_mask, epi, plan_rows, pdl, early, stream)
            : launch_f32_fwd(x, w, M, K, N, in_mask, epi, plan_rows, pdl, early, stream);
}

// ---------------------------------------------------------------------------
// Kernel 2: one layer's backward and in-place momentum update.
//   dedx (M, N), yprev (M, K) (masked on load by in_mask: the net's input),
//   W, Delta (K, N), b, db (N,), scalars m, A, Bc:
//     G      = yprev^T @ dedx
//     Delta' = m*Delta - (A*G + Bc*W),  W' = W + Delta'      (in place)
//     gb     = sum_rows dedx;  db' = m*db - A*gb,  b' = b + db'   (bias blocks)
//     dedy   = (dedx @ W^T) * deriv(yprev)   with W before the update
// Replaces tpu_sednn/ops/fused_mlp.py:_bwd_kernel (and the backward half of
// resident_chunk.py:_resident_kernel's bunch): stripe_bwd_kernel, below, one
// launch a layer with dedy summed in the kernel, with float32 FMA products
// (operations-bound) or tensor-core products (bytes-bound).
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
// Gradient out (gout != nullptr; the data-parallel trainer): a block stores
// its G tiles, and the bias blocks gb, into gout (K*N floats of G
// row-major, then N of gb) and leaves W, Delta, b and db alone; dedy is
// formed as above from the W it reads.  The sum over the ranks then goes
// through a collective, and update_kernel applies it.
// ---------------------------------------------------------------------------

constexpr int kUpdFirst = 1, kUpdApply = 2;

// The in-place update of columns col..col+3 (col a multiple of 4) of row kr
// of W and Delta, from the unrounded W the block loaded (wr) and G (gr):
// Delta' = m*Delta - (A*G + Bc*W) with `first` (kUpdFirst), else Delta - A*G;
// W' = W + Delta' with `apply` (kUpdApply); bfloat16 stores rounded
// stochastically.  update4 takes Delta's old values given (dr), as the
// backward has them in shared memory already; update_row4 reads them
// (update_kernel).  Both, and update_bias, are written with the
// round-to-nearest intrinsics, which the compiler does not contract into fused
// multiply-adds: one float32 operation at a time, in the order the plain
// versions compute them.
template <typename TW, typename TD>
__device__ inline void update4(TW* __restrict__ w, TD* __restrict__ delta, int kr, int col, int K,
                               int N, const float wr[4], const float dr[4], const float gr[4],
                               float mom, float A, float Bc, uint32_t sr_key, bool first,
                               bool apply, bool vec_w, bool vec_dl) {
  constexpr bool kSr = !std::is_same<TW, float>::value || !std::is_same<TD, float>::value;
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

template <typename TW, typename TD>
__device__ inline void update_row4(TW* __restrict__ w, TD* __restrict__ delta, int kr, int col,
                                   int K, int N, const float wr[4], const float gr[4], float mom,
                                   float A, float Bc, uint32_t sr_key, bool first, bool apply,
                                   bool vec_w, bool vec_dl) {
  const float4 dv = ld4(delta, kr, col, N, K, N, vec_dl);
  const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
  update4(w, delta, kr, col, K, N, wr, dr, gr, mom, A, Bc, sr_key, first, apply, vec_w, vec_dl);
}

// The bias of column n: db' = m*db - A*gb (first) or db - A*gb, b' = b + db' (apply).
__device__ inline void update_bias(float* b, float* db, int n, float gb, float mom, float A,
                                   bool first, bool apply) {
  const float ndb = first ? __fsub_rn(__fmul_rn(mom, db[n]), __fmul_rn(A, gb))
                          : __fsub_rn(db[n], __fmul_rn(A, gb));
  db[n] = ndb;
  if (apply) b[n] = __fadd_rn(b[n], ndb);
}

// The backward kernel (stripe_bwd_kernel): G = yprev^T @ dedx, dedy = dedx @
// W^T, the update, one launch a layer, in either product form, as the policy
// kTc selects:
// * tensor-core products (kTc): G = rne(yprev)^T @ rne(dedx) and dedy =
//   rne(dedx) @ rne(W)^T, float32 sums on mma.sync m16n8k16; the update takes
//   the UNROUNDED W and G's float32 sums, the bias its float32 dedx
//   (resident_chunk.py:465, 478 and 508);
// * float32 FMA products (!kTc): the same sums of float32 products, each
//   output's in a fixed order (below).
//
// Bound.  At a bunch of 128 a layer does 4*128*K*N FLOP (G and dedy) against
// one read and one write of W and of Delta, 16*K*N bytes in float32: 32 FLOP
// a byte.  That is far under the 295 at which the tensor cores would limit
// (bytes-bound) and over the 20 of the FP32 pipe (operations-bound, narrowly).
// So the design moves W and Delta once, keeps bytes in flight, and keeps
// everything else out of device memory:
// * a block owns a stripe of BK rows of W and Delta (BK = 64, 32, 16 at up to
//   128, 256, 512 rows of dedx: the stripe's dedy lives in registers, 32 a
//   thread) and a range of N, which it streams in chunks of kBwdBN columns.
//   For each chunk it forms G's (BK, chunk) tile over all M rows and applies
//   the momentum update to that tile at once: W and Delta are read once and
//   written once and no gradient is stored;
// * the stripe's dedy (M, BK) is summed over the block's chunks in registers
//   (chunk order) with W from before the update (a chunk's W is taken for
//   dedy before it is stepped);
// * the TPU kernel sums dedy over a sequential grid axis (fused_mlp.py:108;
//   resident_chunk.py:437-462 walks stripes of W rows across all of N); a
//   Hopper grid runs in no order, so N is split over the blocks of a
//   thread-block cluster (up to 8, along the grid's x, sized so that every
//   cluster of the grid is resident at once: bwd_split; a second wave of
//   clusters was measured slower), and each block sums its share of dedy's
//   rows over the cluster's partial stripes through distributed shared memory
//   in rank order, then applies the activation derivative and writes dedy
//   once.  No scratch in device memory, no second launch, no atomics: every
//   output's sum depends only on the split, a function of (K, N, BK) and the
//   card;
// * operands arrive through a ring of BwdTile::kStages stages filled by the
//   Tensor Memory Accelerator (one 2-D tile copy each for dedx's (128, BN),
//   W's (BK, BN) and Delta's (BK, BN) a step, zeros past every edge,
//   completing on the slot's `full` mbarrier).  The tensor-core form reads
//   dedx as the launch that made it rounded it (rne(dedx), a bfloat16 copy
//   beside the float32 dedx, rows padded to 16 bytes, so it goes by tensor
//   copies at every N), swizzled by 128 bytes into the ring, where its
//   products read it: no rounding pass a step.  One producer warp issues them
//   and waits on the slot's `empty` mbarrier for the compute warps to release
//   it; issued from a compute warp, the copies held every warp at the step's
//   barrier (measured: a third of a step).  So Delta's read is in flight with
//   W's and dedx's, ahead of the products.  A tensor map needs rows whose
//   stride is a multiple of 16 bytes: at N = 129 or 257 the float32 operands
//   go by 4-byte cp.async and bfloat16 W or Delta through registers, from the
//   compute warps;
// * the stripe of yprev (M, BK) is loaded once and masked (in_mask, layer
//   0's input: Philox, or a table's words loaded with the stripe; the two
//   kinds take separate loops, so the Philox form's is as it was) into
//   shared memory: rounded to bfloat16 for the tensor
//   cores, each G warp then keeping its A fragments of it in registers for
//   the whole launch, or as it is (float32) for the FMA products;
// * the update goes through shared memory in row order (G's chunk written
//   there from the accumulators): eight threads a 128-byte row, so the shared
//   loads meet no bank conflict and the global stores are whole lines (from
//   the fragments' layout, 16 rows a warp instruction, it took twice as long);
// * the bias gradient: a last row of blocks sums dedx's columns over the rows
//   in order and updates the bias (or stores gb), so no stripe's block is
//   slower for it; it fetches its range of dedx into L2 first, since nothing
//   else keeps the float32 rows there where the stripes read the copy (without
//   it the first layer's bias blocks, which sum 1,024 columns a block at 16
//   kHz, outlasted the stripes by 16 us).
// Rows past 128 (M up to 512) come as further steps of the same chunk: G
// accumulates over them and the update waits for the last; W is then read
// again from L2 for the update.
// Warps (8 compute + 1 producer), tensor cores: G's (BK, BN) tile in (16, 16
// * kGN16) tiles, A = yprev^T held in registers, B = rne(dedx) read from the
// ring's swizzled box with ldmatrix.trans, two accumulator chains (even and
// odd 16-row steps) added at the end; dedy's 16-row tiles, warp w owning rows
// 16w.. of each 128 rows, A = rne(dedx) from the same box, B = W^T read as it
// is stored, W's chunk rounded once a chunk.  A step: W rounded (for dedy), G's
// products and G's chunk to shared memory, one barrier, dedy's products and the
// update, one barrier.  What bounds it now (H100, PERF.md, per-block
// %globaltimer): at a 2048-wide layer a step takes about 2.6 us of the
// compute warps' work with its copies landed (they wait 0.18 us a step), and
// the 96 blocks move W and Delta at about 2.3 TB/s together, near what device
// memory gives a stream half of writes; 36 of the 132 SMs hold no stripe (the
// split of N); a launch's fixed cost is its first step (5.4 us, the first
// copies' latency) and the cluster's dedy sum (5 us).
// FMA products: every compute thread holds a 4 x 4 tile of G's chunk (four
// rows of the stripe, four neighbouring columns; a row of 64 columns is 16
// threads) and sums it over its group's rows of the step (the rows split in
// 64 / BK groups of threads where BK < 64, whose tiles are added in group
// order at the chunk's end); a row of yprev and of dedx are one float4 load
// each, broadcast within the warp, for 16 FMAs.  dedy: every thread holds
// BK / 8 rows x 4 columns of the stripe a step (columns kl + BK/4 * c, so a
// warp's loads of W's rows meet no bank conflict), 32 accumulators in all,
// summed over the chunk's n in order into a partial that is then added to the
// sum over the chunks (the chains of the two-launch form this kernel
// replaced), from W's chunk widened once into a padded float32 tile: four
// float4 of W and BK / 8 of dedx for 4 * 4 * BK / 8 FMAs; the cluster adds its
// ranks' partials in float64 and rounds once.
// What bounds it (PERF.md, PR 13): shared memory.  An SM's shared memory
// delivers 32 floats a clock against 128 FMAs, and these tiles load one float
// for every 2 to 2.7 FMAs; 8 x 8 tiles (4 FMAs a float) reach 59% of the FP32
// pipe in a loop alone but need 64 accumulators beside dedy's 32, more than
// the 168 registers 9 warps leave a thread: the variants that had them
// (spilling, or without the producer warp at 255 registers) took 0.42-0.51
// ms for a bunch's four 8 kHz layers against this form's 0.38.  A cluster of
// 4 blocks a stripe does not fit 33 stripe rows on the card, so a 2048-row
// layer runs on 3 x 33 blocks.
//
// Storage (template): W and Delta float32; Delta bfloat16 (sr_delta); or both
// bfloat16 (sr_state), widened as they are read from the stage and narrowed
// with stochastic rounding by update4.  Row-tile flags and the gradient-out
// form (gout != nullptr: G and gb written, W only read, and not at all where
// no dedy is asked for) as above.
constexpr int kBwdBN = 64, kBwdSubM = 128;
constexpr int kBwdCompute = 256;                    // the compute warps' threads (8 warps)
constexpr int kBwdThreads = kBwdCompute + 32;       // and one producer warp
constexpr int kBwdMaxCluster = 8;
constexpr int kBwdDLd = kBwdBN + 8;  // bfloat16 row stride of 144 bytes (see TcFwdTile)
constexpr size_t kSmemPerBlock = 232448;  // the most shared memory a block of an H100 takes

// The backward's shared memory in either product form.  The ring's stage
// holds a step's dedx (as the form reads it), W and Delta boxes:
// * tensor cores: rne(dedx), the launch before's bfloat16 copy, a (128, 64)
//   box of 128-byte rows with the tensor copy's 128-byte swizzle (the 16-byte
//   chunk c of row r at chunk c ^ (r % 8), so the eight rows an ldmatrix
//   reads lie in eight bank groups; the pattern repeats every 1 KB, the
//   alignment of the stages): 16 KB, with W and Delta 48 KB at BK = 64;
// * float32 FMAs: dedx as stored (float32, dense), 64 KB a stage at BK = 64
//   and float32 state.
// Two stages in either form.  A third fits the tensor-core form (190 KB at
// BK = 64) and was measured (H100, PERF.md): its steps' copies had landed
// with two as with three (the compute warps waited 0.17-0.19 us a step), and
// the deeper burst of copies at a launch's start delayed its first step: three
// stages took about 4 us more a 2048-wide layer alone and 1-2% more a bunch of
// the chunk trainer's chain.
template <bool kTc, typename TW, typename TD, int BK>
struct BwdTile {
  static constexpr int kStages = 2;
  static constexpr int kAlign = kTc ? 1024 : 128;  // of the stages (the swizzle's 1 KB)
  using TX = typename std::conditional<kTc, bf16_t, float>::type;  // dedx in the ring
  static constexpr int kMT = 64 / BK;                // 128-row groups of dedy a thread holds
  static constexpr int kMaxM = kBwdSubM * kMT;       // rows of dedx a launch takes
  static constexpr int kYLd = BK + 8;                // bfloat16: an odd multiple of 16 bytes
  static constexpr int kPLd = BK + 4;
  // tensor cores: G's chunk (BK, BN): a warp takes 16 rows and kGN16 16-column tiles of it
  static constexpr int kGPerRow = 8 / (BK / 16);  // warps that share 16 rows of G
  static constexpr int kGN16 = kBwdBN / 16 >= kGPerRow ? kBwdBN / 16 / kGPerRow : 1;
  static constexpr int kGWarps = (BK / 16) * (kBwdBN / 16 / kGN16);
  // FMA: groups of threads that split a step's rows for G, each a whole (BK, BN) tile
  static constexpr int kGGroups = kTc ? 1 : 64 / BK;
  struct alignas(kAlign) Stage {  // the tensor copies' boxes
    TX d[kBwdSubM][kBwdBN];     // dedx rows of the step (above)
    TW w[BK][kBwdBN];           // W rows of the stripe, as stored
    TD dl[BK][kBwdBN];          // Delta rows of the stripe, as stored
  };
  struct TcOperands {
    bf16_t y[kMaxM][kYLd];              // rne(masked yprev stripe), (m, k)
    bf16_t wb[BK][kBwdDLd];             // rne(W chunk), (k, n)
  };
  struct FmaOperands {
    float y[kMaxM][BK];                 // masked yprev stripe, (m, k)
    float wf[BK][kBwdBN + 4];           // W chunk widened, (k, n), for dedy
  };
  struct alignas(kAlign) Smem {
    union {
      Stage ring[kStages];
      float part[kMaxM][kPLd];  // the block's partial dedy stripe, after the loop
    } u;
    typename std::conditional<kTc, TcOperands, FmaOperands>::type op;
    float g[kGGroups * BK][kBwdBN + 4];  // G's chunk (a tile a group), for the update in row order
    uint64_t full[kStages];              // a ring slot's tensor copies have landed
    uint64_t empty[kStages];             // the compute warps are done with a ring slot
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + kAlign;  // + its alignment
};

// Every stripe width, storage form and product form fits a block.
template <bool kTc, typename TW, typename TD>
constexpr bool bwd_fits() {
  return BwdTile<kTc, TW, TD, 64>::kSmemBytes <= kSmemPerBlock &&
         BwdTile<kTc, TW, TD, 32>::kSmemBytes <= kSmemPerBlock &&
         BwdTile<kTc, TW, TD, 16>::kSmemBytes <= kSmemPerBlock;
}
static_assert(bwd_fits<true, float, float>() && bwd_fits<true, float, bf16_t>() &&
                  bwd_fits<true, bf16_t, bf16_t>(),
              "stripe_bwd_kernel's shared memory, tensor cores (float32 state, sr_delta, sr_state)");
static_assert(bwd_fits<false, float, float>() && bwd_fits<false, float, bf16_t>() &&
                  bwd_fits<false, bf16_t, bf16_t>(),
              "stripe_bwd_kernel's shared memory, float32 FMAs (float32 state, sr_delta, sr_state)");

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// a barrier of the compute warps alone (named barrier 1), the producer warp not waited for
__device__ inline void bwd_compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBwdCompute) : "memory");
}

// d_tma / w_tma / l_tma: dedx, W, Delta go by tensor copies (tmd, tmw, tml),
// which the producer warp issues, else by cp.async (float32) or registers
// (bfloat16) from the compute warps.  The tensor-core form reads dedx from
// its bfloat16 copy, always by tensor copies (tmd; the copy's rows are
// padded to 16 bytes), and the float32 dedx in its bias blocks only; where
// it hands dedy on (dedy_bf != nullptr) it writes rne(dedy) beside dedy,
// rows of ld_dy_bf elements.  gridDim.x splits N (the cluster, where
// dedy != nullptr); gridDim.y - 1 rows of blocks take the stripes of BK rows
// of W, and the last row the bias: the column sums of dedx over its range.
// early (pdl.cuh): before griddepcontrol.wait, beside the mbarriers' set-up,
// the first ring steps' W (kEarlyW) and Delta (kEarlyDelta) and the yprev
// stripe (kEarlyYprev); dedx (the bias blocks' reads too) and every store
// come after it.
template <bool kTc, typename TW, typename TD, int BK>
__global__ void __launch_bounds__(kBwdThreads, 1)
stripe_bwd_kernel(const __grid_constant__ CUtensorMap tmd, const __grid_constant__ CUtensorMap tmw,
                  const __grid_constant__ CUtensorMap tml, const float* __restrict__ dedx,
                  const float* __restrict__ yprev, MaskSpec in_mask, TW* __restrict__ w,
                  TD* __restrict__ delta, float* __restrict__ b, float* __restrict__ db,
                  float* __restrict__ gout, float* __restrict__ dedy,
                  bf16_t* __restrict__ dedy_bf, int ld_dy_bf, int deriv, int M, int K, int N,
                  float mom, float A, float Bc, uint32_t sr_key, int flags, bool d_tma,
                  bool w_tma, bool l_tma, bool vec_y, bool vec_w, bool vec_dl, bool vec_g,
                  bool vec_dy, int early) {
  namespace cg = cooperative_groups;
  using T = BwdTile<kTc, TW, TD, BK>;
  constexpr int kS = T::kStages, BN = kBwdBN, kC = kBwdCompute, kSub = kBwdSubM;
  // passes of the compute threads over a (BK, BN) tile, four columns a thread
  constexpr int kQuadIters = BK * BN / 4 >= kC ? BK * BN / 4 / kC : 1;
  extern __shared__ unsigned char bwd_smem[];
  typename T::Smem& sm = *reinterpret_cast<typename T::Smem*>(
      (reinterpret_cast<uintptr_t>(bwd_smem) + T::kAlign - 1) & ~(uintptr_t)(T::kAlign - 1));
  if constexpr (kTc) {  // the swizzled boxes need their stages 1 KB-aligned in shared memory
    if ((smem_addr(&sm) & (T::kAlign - 1)) != 0) __trap();
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool first = (flags & kUpdFirst) != 0, apply = (flags & kUpdApply) != 0;
  const bool update = gout == nullptr, with_dedy = dedy != nullptr;
  const int rank = blockIdx.x, n_ranks = gridDim.x;
  const int n_chunks = (N + BN - 1) / BN, per = (n_chunks + n_ranks - 1) / n_ranks;
  const int c0 = min(n_chunks, rank * per), c1 = min(n_chunks, c0 + per);

  if (blockIdx.y == gridDim.y - 1) {  // the bias of columns c0 * BN..: dedx's rows summed in order
    grid_dep_wait();
    const int n0 = c0 * BN, n1 = min(N, c1 * BN);
    // Tensor cores: the range's rows of dedx into L2 first, every line at once, and 32 loads
    // in flight: the stripes read dedx's bfloat16 copy, so nothing else keeps the float32
    // rows there, and a column's sum, one dependent add a row, waits on its loads.  The
    // float32 stripes read float32 dedx themselves.
    constexpr int kBiasUnroll = kTc ? 32 : 8;
    if constexpr (kTc) {
      const int lines = (n1 - n0 + 31) / 32;
      for (int i = tid; i < (n1 > n0 ? M * lines : 0); i += kBwdThreads)
        prefetch_l2(dedx + (long long)(i / lines) * N + n0 + 32 * (i % lines));
    }
    for (int n = n0 + tid; n < n1; n += kBwdThreads) {
      float s = 0.0f;
#pragma unroll (kBiasUnroll)
      for (int m = 0; m < M; ++m) s += __ldg(dedx + (long long)m * N + n);
      if (update) {
        update_bias(b, db, n, s, mom, A, first, apply);
      } else {
        gout[(long long)K * N + n] = s;
      }
    }
    return;  // the whole cluster of bias blocks leaves: none of them waits on the others
  }

  const int k0 = blockIdx.y * BK;
  const int subs = (M + kSub - 1) / kSub, m16 = (M + 15) / 16 * 16;
  const int n_steps = (c1 - c0) * subs;
  const int d_rows = min(kSub, m16);  // rows of dedx's tensor copy, as the host sizes it
  const bool need_w = update || with_dedy;
  const bool any_tma = d_tma || (need_w && w_tma) || (update && l_tma);
  const bool all_tma = d_tma && (!need_w || w_tma) && (!update || l_tma);
  // step `step` is chunk c0 + step / subs, rows (step % subs) * 128..: dedx
  // always; W where the step takes it for dedy (a chunk's first rows) or
  // updates it (its last), Delta where it updates
  auto ld_w = [&](int j) { return (with_dedy && j == 0) || (update && j == subs - 1); };
  auto ld_l = [&](int j) { return update && j == subs - 1; };
  // what the plan lets this launch read before its wait
  const bool early_w = (early & kEarlyW) != 0, early_l = (early & kEarlyDelta) != 0;
  const bool early_y = (early & kEarlyYprev) != 0;

  if (any_tma && tid == 0) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (d_tma) prefetch_tensormap(&tmd);
    if (need_w && w_tma) prefetch_tensormap(&tmw);
    if (update && l_tma) prefetch_tensormap(&tml);
  }
  __syncthreads();

  if (warp == kBwdCompute / 32) {
    // the producer: one lane keeps kS steps of tensor copies in flight, each
    // into a slot the compute warps have released (the bytes are posted even
    // where a step has none, so that its phase completes).  The first kS
    // steps' W and Delta go before the wait where the plan allows: they add
    // their bytes, and the step's one arrival comes with its dedx
    auto w_early = [&](int step) { return step < kS && early_w && ld_w(step % subs) && w_tma; };
    auto l_early = [&](int step) { return step < kS && early_l && ld_l(step % subs) && l_tma; };
    if (lane == 0 && any_tma) {
      for (int step = 0; step < min(kS, n_steps); ++step) {
        const bool lw = w_early(step), ll = l_early(step);
        if (!lw && !ll) continue;
        typename T::Stage& st = sm.u.ring[step];
        const int n0 = (c0 + step / subs) * BN;
        mbar_expect_tx(&sm.full[step],
                       (lw ? (uint32_t)sizeof(st.w) : 0u) + (ll ? (uint32_t)sizeof(st.dl) : 0u));
        if (lw) tma_load_2d(&st.w[0][0], &tmw, n0, k0, &sm.full[step]);
        if (ll) tma_load_2d(&st.dl[0][0], &tml, n0, k0, &sm.full[step]);
      }
    }
    grid_dep_wait();
    if (lane == 0 && any_tma) {
      for (int step = 0; step < n_steps; ++step) {
        const int slot = step % kS, j = step % subs;
        const int n0 = (c0 + step / subs) * BN, m0 = j * kSub;
        if (step >= kS) mbar_wait(&sm.empty[slot], (step / kS - 1) & 1);
        typename T::Stage& st = sm.u.ring[slot];
        const bool lw = ld_w(j) && w_tma && !w_early(step), ll = ld_l(j) && l_tma && !l_early(step);
        const uint32_t d_bytes = (uint32_t)(d_rows * BN * sizeof(st.d[0][0]));
        mbar_arrive_expect_tx(&sm.full[slot], (d_tma ? d_bytes : 0u) +
                                                  (lw ? (uint32_t)sizeof(st.w) : 0u) +
                                                  (ll ? (uint32_t)sizeof(st.dl) : 0u));
        if (d_tma) tma_load_2d(&st.d[0][0], &tmd, n0, m0, &sm.full[slot]);
        if (lw) tma_load_2d(&st.w[0][0], &tmw, n0, k0, &sm.full[slot]);
        if (ll) tma_load_2d(&st.dl[0][0], &tml, n0, k0, &sm.full[slot]);
      }
    }
  } else {
    // the compute warps.  The operands without a tensor map, by their own
    // copies (dedx, W, Delta as `parts` asks: 1, 2, 4):
    auto load_by_hand = [&](int slot, int step, int parts) {
      typename T::Stage& st = sm.u.ring[slot];
      const int j = step % subs, n0 = (c0 + step / subs) * BN, m0 = j * kSub;
      if constexpr (!kTc) {  // the tensor-core form's copy always goes by tensor copies
        if (!d_tma && (parts & 1)) {
          const int rows_pad = min(kSub, m16 - m0);
          for (int idx = tid; idx < rows_pad * BN; idx += kC) {
            const int row = idx / BN, c = idx % BN;
            const bool in = m0 + row < M && n0 + c < N;
            cp_async4(&st.d[row][c], in ? dedx + (long long)(m0 + row) * N + n0 + c : dedx,
                      in ? 4 : 0);
          }
        }
      }
      auto by_hand = [&](auto* dst, const auto* src) {  // (BK, BN) of a W-shaped operand
        using E = typename std::remove_cv<typename std::remove_pointer<decltype(src)>::type>::type;
        for (int idx = tid; idx < BK * BN; idx += kC) {
          const int kr = idx / BN, c = idx % BN;
          const bool in = k0 + kr < K && n0 + c < N;
          if constexpr (std::is_same<E, bf16_t>::value) {  // 2-byte aligned: registers
            dst[idx] = in ? src[(long long)(k0 + kr) * N + n0 + c] : (E)0;
          } else {
            cp_async4(&dst[idx], in ? src + (long long)(k0 + kr) * N + n0 + c : src, in ? 4 : 0);
          }
        }
      };
      if (ld_w(j) && !w_tma && (parts & 2)) by_hand(&st.w[0][0], (const TW*)w);
      if (ld_l(j) && !l_tma && (parts & 4)) by_hand(&st.dl[0][0], (const TD*)delta);
    };
    // before the wait, W and Delta of the first kS - 1 steps where the plan
    // allows (uncommitted: they join step 0's group)
    const int early_parts = (early_w ? 2 : 0) | (early_l ? 4 : 0);
    if (!all_tma && early_parts != 0) {
#pragma unroll
      for (int s = 0; s < kS - 1; ++s)
        if (s < n_steps) load_by_hand(s, s, early_parts);
    }

    // the stripe of yprev, masked in float32 (and rounded for the tensor
    // cores); zeros past M (to 16 rows) and K
    auto y4 = [&](int row, int col) {  // 16 bytes at (row, col) of yprev, zeros past its edges
      if (vec_y && row < M && col + 3 < K)
        return __ldg(reinterpret_cast<const float4*>(yprev + (long long)row * K + col));
      return ld4(yprev, row, col, K, M, K, false);
    };
    constexpr int kYIters = kSub * BK / 4 / kC;  // float4 of 128 rows of the stripe a thread takes
    // the stripe's rows jj * kSub.., masked, rounded for the tensor cores and
    // stored; with `table` (mode 3) the table's words are loaded with them,
    // so that their latency is the stripe's
    auto load_sub = [&](int jj, auto table) {
      float4 yv[kYIters];
      [[maybe_unused]] uint32_t yw[kYIters];  // with `table` only
#pragma unroll
      for (int r = 0; r < kYIters; ++r) {  // the loads all in flight at once
        const int idx = tid + r * kC, row = jj * kSub + idx / (BK / 4);
        const int col = k0 + (idx % (BK / 4)) * 4;
        yv[r] = row < m16 ? y4(row, col) : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (decltype(table)::value)
          yw[r] = row < M && col < K ? mask_word(in_mask, row, col) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kYIters; ++r) {
        const int idx = tid + r * kC, row = jj * kSub + idx / (BK / 4), c = (idx % (BK / 4)) * 4;
        if (row >= m16) continue;
        float4 v = yv[r];
        if (in_mask.mode != 0 && row < M && k0 + c < K) {
          float mk[4];
          if constexpr (decltype(table)::value)
            mask4_word(in_mask, yw[r], k0 + c, K, mk);
          else
            mask4(in_mask, row, k0 + c, K, mk);
          v.x *= mk[0]; v.y *= mk[1]; v.z *= mk[2]; v.w *= mk[3];
        }
        if constexpr (kTc) {
          st_cvt4(&sm.op.y[row][c], v);
        } else {
          *reinterpret_cast<float4*>(&sm.op.y[row][c]) = v;
        }
      }
    };
    auto load_stripe = [&]() {
#pragma unroll
      for (int jj = 0; jj < T::kMT; ++jj) {
        if (n_steps == 0 || jj * kSub >= m16) continue;
        if (in_mask.mode == 3)
          load_sub(jj, std::true_type());
        else
          load_sub(jj, std::false_type());
      }
    };
    if (early_y) load_stripe();
    grid_dep_wait();
    if (!all_tma) {
#pragma unroll
      for (int s = 0; s < kS - 1; ++s) {
        if (s < n_steps) load_by_hand(s, s, 1 | (6 & ~early_parts));
        cp_async_commit();  // one group per step, empty or not: the wait counts steps
      }
    }
    if (!early_y) load_stripe();
    bwd_compute_sync();  // the stripe's rows are read by every thread

    // tensor cores: this warp's tile of G's chunk (warps below kGWarps): rows
    // gm.., cols gn.. (kGN16 * 16 of them); its A operand, rne(yprev)^T of
    // rows gm.., is the same at every step: held in registers (reloaded a
    // step only where M takes more than one step a chunk).  Its dedy: rows
    // dm.. of each 128 rows, all of the stripe's columns.
    constexpr int kGN16 = T::kGN16;
    const bool g_warp = warp < T::kGWarps;
    const int gm = (warp / (BN / 16 / kGN16)) * 16, gn = (warp % (BN / 16 / kGN16)) * 16 * kGN16;
    const int dm = warp * 16;
    uint32_t ya[kSub / 16][4];
    float gacc[2][2 * kGN16][4];  // [even / odd 16-row step][n8 tile]: two chains half as deep
    // FMA: this thread's 4 x 4 tile of G's chunk, rows fk.. of the stripe and
    // cols fn.., over its group's share of each step's rows; its dedy: rows
    // fdm * kDM.. of each 128 rows, columns kl + BK / 4 * c
    constexpr int kDM = BK / 8;
    const int fn = (tid % 16) * 4, fk = ((tid / 16) % (BK / 4)) * 4, fgrp = tid / (4 * BK);
    const int kl = tid % (BK / 4), fdm = tid / (BK / 4);
    float facc[4][4];
    // dedy: tensor cores [128-row group][n8 tile][fragment], FMA [128-row group][row][column]
    float dacc[T::kMT][BK / 8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2 * kGN16; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) gacc[i][h][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) facc[i][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < T::kMT; ++i)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dacc[i][j][c] = 0.0f;

    for (int s = 0; s < n_steps; ++s) {
      if (!all_tma) {
        const int ahead = s + kS - 1;  // its slot was released by the barrier that ended step s - 1
        if (ahead < n_steps) load_by_hand(ahead % kS, ahead, 7);
        cp_async_commit();
      }
      if (any_tma) mbar_wait(&sm.full[s % kS], (s / kS) & 1);
      if (!all_tma) {
        cp_async_wait<kS - 1>();
        bwd_compute_sync();
      }
      const typename T::Stage& st = sm.u.ring[s % kS];
      const int j = s % subs, n0 = (c0 + s / subs) * BN;
      const int rows_pad = min(kSub, m16 - j * kSub);  // this step's rows, whole m16 tiles
      const int rows = min(kSub, M - j * kSub);        // and as they are

      if constexpr (kTc) {
        // W's chunk rounded for dedy (a chunk's first rows); dedx came rounded
        if (with_dedy && j == 0) {
#pragma unroll
          for (int r = 0; r < kQuadIters; ++r) {
            const int idx = tid + r * kC, kr = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
            if (kr < BK) st_cvt4(&sm.op.wb[kr][c], widen4(&st.w[kr][c]));
          }
        }
        // G's chunk over this step's rows: rne(yprev)^T @ rne(dedx), dedx read from the ring
        if (g_warp) {
          if (s == 0 || subs > 1) {
#pragma unroll
            for (int q = 0; q < kSub / 16; ++q)
              if (q * 16 < rows_pad)
                load_a_trans(ya[q], &sm.op.y[j * kSub + q * 16][gm], T::kYLd, lane);
          }
#pragma unroll
          for (int q = 0; q < kSub / 16; ++q) {
            if (q * 16 >= rows_pad) continue;
#pragma unroll
            for (int n16 = 0; n16 < kGN16; ++n16) {
              uint32_t bb[4];
              load_b_kn_sw128(bb, &st.d[0][0], q * 16, gn + n16 * 16, lane);
              mma_bf16_16816(gacc[q & 1][2 * n16], ya[q], bb[0], bb[1]);
              mma_bf16_16816(gacc[q & 1][2 * n16 + 1], ya[q], bb[2], bb[3]);
            }
          }
          if (j == subs - 1) {
            // the chunk's G is complete: to shared memory, for the update in row order
#pragma unroll
            for (int h = 0; h < 2 * kGN16; ++h) {
              const int col = gn + h * 8 + 2 * t;
              *reinterpret_cast<float2*>(&sm.g[gm + g][col]) =
                  make_float2(gacc[0][h][0] + gacc[1][h][0], gacc[0][h][1] + gacc[1][h][1]);
              *reinterpret_cast<float2*>(&sm.g[gm + g + 8][col]) =
                  make_float2(gacc[0][h][2] + gacc[1][h][2], gacc[0][h][3] + gacc[1][h][3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) gacc[0][h][e] = gacc[1][h][e] = 0.0f;
            }
          }
        }
        if ((with_dedy && j == 0) || j == subs - 1) bwd_compute_sync();  // rne(W), G's chunk
        // dedy's rows of this warp in this step: rne(dedx) @ rne(W)^T, summed over the chunks
        if (with_dedy && dm < rows_pad) {
#pragma unroll
          for (int jj = 0; jj < T::kMT; ++jj) {
            if (jj != j) continue;
#pragma unroll
            for (int kk = 0; kk < BN; kk += 16) {
              uint32_t a[4];
              load_a_sw128(a, &st.d[0][0], dm, kk, lane);
#pragma unroll
              for (int p = 0; p < BK / 16; ++p) {
                uint32_t bb[4];
                load_b_nk(bb, &sm.op.wb[p * 16][kk], kBwdDLd, lane);
                mma_bf16_16816(dacc[jj][2 * p], a, bb[0], bb[1]);
                mma_bf16_16816(dacc[jj][2 * p + 1], a, bb[2], bb[3]);
              }
            }
          }
        }
      } else {
        // W's chunk widened for dedy, once a chunk (kept through its steps)
        if (with_dedy && j == 0) {
#pragma unroll
          for (int r = 0; r < kQuadIters; ++r) {
            const int idx = tid + r * kC, kr = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
            if (kr < BK) *reinterpret_cast<float4*>(&sm.op.wf[kr][c]) = widen4(&st.w[kr][c]);
          }
          bwd_compute_sync();
        }
        // G's chunk over this group's share of the step's rows, in row order
        const int share = (rows + T::kGGroups - 1) / T::kGGroups;
        const int r1 = min(rows, (fgrp + 1) * share);
#pragma unroll 4
        for (int m = fgrp * share; m < r1; ++m) {
          const float4 yv = *reinterpret_cast<const float4*>(&sm.op.y[j * kSub + m][fk]);
          const float4 dv = *reinterpret_cast<const float4*>(&st.d[m][fn]);
          const float yr[4] = {yv.x, yv.y, yv.z, yv.w}, dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) facc[i][c] = fmaf(yr[i], dr[c], facc[i][c]);
        }
        // dedy's rows of this thread in this step: dedx @ W^T, the chunk's n in order
        // into a partial, which is then added to the sum over the chunks
        if (with_dedy && fdm * kDM < rows) {
#pragma unroll
          for (int jj = 0; jj < T::kMT; ++jj) {
            if (jj != j) continue;
            float dp[kDM][4];
#pragma unroll
            for (int i = 0; i < kDM; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) dp[i][c] = 0.0f;
#pragma unroll 2
            for (int n = 0; n < BN; n += 4) {
              float4 wv[4];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                wv[c] = *reinterpret_cast<const float4*>(&sm.op.wf[kl + (BK / 4) * c][n]);
#pragma unroll
              for (int i = 0; i < kDM; ++i) {
                const float4 dv = *reinterpret_cast<const float4*>(&st.d[fdm * kDM + i][n]);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  float a = dp[i][c];
                  a = fmaf(dv.x, wv[c].x, a);
                  a = fmaf(dv.y, wv[c].y, a);
                  a = fmaf(dv.z, wv[c].z, a);
                  dp[i][c] = fmaf(dv.w, wv[c].w, a);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kDM; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) dacc[jj][i][c] += dp[i][c];
          }
        }
      }

      if (j == subs - 1) {
        // the chunk's G is complete: through shared memory to the update (or
        // the store) in row order, eight threads a row of the chunk: 16-byte
        // shared loads without bank conflicts and whole 128-byte rows stored
        // (the tensor-core form wrote its G above)
        if constexpr (!kTc) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            *reinterpret_cast<float4*>(&sm.g[fgrp * BK + fk + i][fn]) =
                make_float4(facc[i][0], facc[i][1], facc[i][2], facc[i][3]);
#pragma unroll
            for (int c = 0; c < 4; ++c) facc[i][c] = 0.0f;
          }
          bwd_compute_sync();
        }
#pragma unroll
        for (int r = 0; r < kQuadIters; ++r) {
          const int idx = tid + r * kC, kl4 = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
          const int kr = k0 + kl4, col = n0 + c;
          if (kl4 >= BK || kr >= K || col >= N) continue;
          float4 gv = *reinterpret_cast<const float4*>(&sm.g[kl4][c]);
#pragma unroll
          for (int q = 1; q < T::kGGroups; ++q) {  // the groups' tiles, in group order
            const float4 p = *reinterpret_cast<const float4*>(&sm.g[q * BK + kl4][c]);
            gv.x += p.x; gv.y += p.y; gv.z += p.z; gv.w += p.w;
          }
          if (!update) {
            st4(gout, kr, col, N, K, N, vec_g, gv);
            continue;
          }
          const float4 wv = widen4(&st.w[kl4][c]), dv = widen4(&st.dl[kl4][c]);
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w}, dr[4] = {dv.x, dv.y, dv.z, dv.w};
          const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
          update4(w, delta, kr, col, K, N, wr, dr, gr, mom, A, Bc, sr_key, first, apply, vec_w,
                  vec_dl);
        }
      }
      bwd_compute_sync();  // the slot and the step's operands are free for the next steps
      if (any_tma && tid == 0) mbar_arrive(&sm.empty[s % kS]);
    }
    if (!all_tma) cp_async_wait<0>();
    bwd_compute_sync();  // the ring is free: the partial stripe takes its place
    grid_dep_launch_dependents();  // the next launch's prologue overlaps the cluster sum

    if (with_dedy) {
#pragma unroll
      for (int jj = 0; jj < T::kMT; ++jj) {
        if constexpr (kTc) {
          const int row = jj * kSub + dm + g;
          if (jj * kSub + dm >= m16) continue;
#pragma unroll
          for (int n8 = 0; n8 < BK / 8; ++n8) {
            const int col = n8 * 8 + 2 * t;
            *reinterpret_cast<float2*>(&sm.u.part[row][col]) =
                make_float2(dacc[jj][n8][0], dacc[jj][n8][1]);
            *reinterpret_cast<float2*>(&sm.u.part[row + 8][col]) =
                make_float2(dacc[jj][n8][2], dacc[jj][n8][3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kDM; ++i) {
            const int row = jj * kSub + fdm * kDM + i;
#pragma unroll
            for (int c = 0; c < 4; ++c) sm.u.part[row][kl + (BK / 4) * c] = dacc[jj][i][c];
          }
        }
      }
    }
  }
  if (!with_dedy) return;

  // this block's share of dedy's rows, summed over the cluster in rank order,
  // then the derivative of the layer below on its stored activation (fetched
  // before the barrier)
  constexpr int kOutIters = T::kMaxM * BK / 4 / kC;
  const int per_r = (M + n_ranks - 1) / n_ranks, r0 = min(M, rank * per_r);
  const int r1 = min(M, r0 + per_r), n_out = tid < kC ? (r1 - r0) * (BK / 4) : 0;
  float4 yd[kOutIters];
#pragma unroll
  for (int r = 0; r < kOutIters; ++r) {
    const int idx = tid + r * kC, row = r0 + idx / (BK / 4), col = k0 + (idx % (BK / 4)) * 4;
    yd[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (deriv != kLinear && idx < n_out) {
      if (vec_y && col + 3 < K)
        yd[r] = __ldg(reinterpret_cast<const float4*>(yprev + (long long)row * K + col));
      else
        yd[r] = ld4(yprev, row, col, K, M, K, false);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial stripe is complete
#pragma unroll
  for (int r = 0; r < kOutIters; ++r) {
    const int idx = tid + r * kC;
    const int row = r0 + idx / (BK / 4), c = (idx % (BK / 4)) * 4;
    if (idx >= n_out || k0 + c >= K) continue;
    float4 p[kBwdMaxCluster];
#pragma unroll
    for (int q = 0; q < kBwdMaxCluster; ++q)
      if (q < n_ranks)
        p[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(&sm.u.part[row][c], q));
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (kTc) {
#pragma unroll
      for (int q = 0; q < kBwdMaxCluster; ++q)
        if (q < n_ranks) {
          v[0] += p[q].x; v[1] += p[q].y; v[2] += p[q].z; v[3] += p[q].w;
        }
    } else {
      // float32 products: the ranks' partials added in float64 and rounded once, so
      // that dedy does not hang on how the split associates its sum (the wide
      // trainer holds of chip_smoke.py are that sensitive, PERF.md, PR 13)
      double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int q = 0; q < kBwdMaxCluster; ++q)
        if (q < n_ranks) {
          s[0] += p[q].x; s[1] += p[q].y; s[2] += p[q].z; s[3] += p[q].w;
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = (float)s[e];
    }
    if (deriv != kLinear) {
      const float yr[4] = {yd[r].x, yd[r].y, yd[r].z, yd[r].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = deriv == kRelu ? (yr[e] > 0.0f ? v[e] : 0.0f) : yr[e] * (1.0f - yr[e]) * v[e];
    }
    st4(dedy, row, k0 + c, K, M, K, vec_dy, make_float4(v[0], v[1], v[2], v[3]));
    if constexpr (kTc) {  // the next layer's dedx, as its backward reads it
      if (dedy_bf != nullptr)
        st_copy4(dedy_bf, ld_dy_bf, row, k0 + c, K, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial stripe
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

// Per library and per device, as fwd_clusters: raises stripe_bwd_kernel<kTc,
// TW, TD, BK>'s shared memory once, and -> how many clusters of `size` blocks
// the card holds at once (cached).
template <bool kTc, typename TW, typename TD, int BK>
static cudaError_t bwd_clusters(int size, int* clusters) {
  static bool attr_set[kTcFwdMaxDevices] = {};
  static int cached[kTcFwdMaxDevices][kBwdMaxCluster + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kTcFwdMaxDevices) return cudaErrorInvalidDevice;
  const size_t smem = BwdTile<kTc, TW, TD, BK>::kSmemBytes;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(stripe_bwd_kernel<kTc, TW, TD, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (cached[dev][size] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(size, 1, 1);
    cfg.blockDim = dim3(kBwdThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, stripe_bwd_kernel<kTc, TW, TD, BK>, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;  // such a cluster cannot be placed
    cached[dev][size] = n;
  }
  *clusters = cached[dev][size];
  return cudaSuccess;
}

// How the backward splits N over the blocks of a stripe: into as many ranges
// of whole chunks as make the grid (the stripes and the row of bias blocks)
// fill the blocks the card holds at once, none of them empty; where dedy is
// summed across the split (`cluster`), at most kBwdMaxCluster and fewer where
// every cluster of the grid could not then be resident at once.  A function
// of (K, N, BK, cluster), the product form and the card alone: a
// data-parallel rank's rows (M <= 128, BK = 64) are summed as the
// single-device trainer sums them.  -> *split.
template <bool kTc, typename TW, typename TD, int BK>
static cudaError_t bwd_split(int K, int N, bool cluster, int* split) {
  const int rows = (K + BK - 1) / BK + 1, n_chunks = (N + kBwdBN - 1) / kBwdBN;
  int one = 0;
  cudaError_t err = bwd_clusters<kTc, TW, TD, BK>(1, &one);  // blocks the card holds at once
  if (err != cudaSuccess) return err;
  const int most = cluster && n_chunks > kBwdMaxCluster ? kBwdMaxCluster : n_chunks;
  int s = one / rows;
  s = s < 1 ? 1 : (s > most ? most : s);
  for (;; --s) {
    const int per = (n_chunks + s - 1) / s;
    if ((n_chunks + per - 1) / per < s) continue;  // a range would hold no chunk
    if (s == 1 || !cluster) break;
    int fit = 0;
    err = bwd_clusters<kTc, TW, TD, BK>(s, &fit);
    if (err != cudaSuccess) return err;
    if (rows <= fit) break;
  }
  *split = s;
  return cudaSuccess;
}

// The bfloat16 copies of the tensor-core backward (bf16_ld rows): the copy
// of dedx it reads (rne(dedx), written by the launch that made dedx, or by
// launch_bf16_copy), and, where nonzero, the copy of dedy it writes beside
// dedy for a backward that reads it next.
struct Bf16Copies {
  const bf16_t* dedx = nullptr;
  bf16_t* dedy = nullptr;
};

// pdl: a programmatic dependent launch that reads before its wait what
// `early` names (pdl.cuh).
template <bool kTc, typename TW, typename TD, int BK>
static cudaError_t launch_bwd_bk(const float* dedx, const Bf16Copies& copies, const float* yprev,
                                 const MaskSpec& in_mask, TW* w, TD* delta, float* b, float* db,
                                 float* gout, float* dedy, int deriv, int M, int K, int N,
                                 float mom, float A, float Bc, uint32_t sr_key, int flags,
                                 bool pdl, int early, cudaStream_t stream) {
  const bool update = gout == nullptr, need_w = update || dedy != nullptr;
  int split = 1;
  cudaError_t err = bwd_split<kTc, TW, TD, BK>(K, N, dedy != nullptr, &split);
  if (err != cudaSuccess) return err;
  // tensor maps where the rows' stride is a multiple of 16 bytes
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  if (kTc ? copies.dedx == nullptr || !aligned(copies.dedx) ||
                (copies.dedy != nullptr && (dedy == nullptr || !aligned(copies.dedy)))
          : copies.dedx != nullptr || copies.dedy != nullptr)
    return cudaErrorInvalidValue;  // tensor cores read the copy; float32 FMAs take none
  CUtensorMap tmd = {}, tmw = {}, tml = {};
  const bool d_tma = kTc || (aligned(dedx) && N % 4 == 0);
  const bool w_tma = need_w && aligned(w) && ((long long)N * (long long)sizeof(TW)) % 16 == 0;
  const bool l_tma = update && aligned(delta) && ((long long)N * (long long)sizeof(TD)) % 16 == 0;
  auto type_of = [](int bytes) {
    return bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16;
  };
  if (d_tma) {  // a rank's 32 or 64 rows copy no 128-row box of zeros
    const int d_rows = M < kBwdSubM ? (M + 15) / 16 * 16 : kBwdSubM;
    err = kTc ? tensor_map_2d(&tmd, CU_TENSOR_MAP_DATA_TYPE_UINT16, copies.dedx, M, N, 2, d_rows,
                              kBwdBN, CU_TENSOR_MAP_SWIZZLE_128B, bf16_ld(N))
              : tensor_map_2d(&tmd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dedx, M, N, 4, d_rows, kBwdBN);
    if (err != cudaSuccess) return err;
  }
  if (w_tma) {
    err = tensor_map_2d(&tmw, type_of(sizeof(TW)), w, K, N, (int)sizeof(TW), BK, kBwdBN);
    if (err != cudaSuccess) return err;
  }
  if (l_tma) {
    err = tensor_map_2d(&tml, type_of(sizeof(TD)), delta, K, N, (int)sizeof(TD), BK, kBwdBN);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (K + BK - 1) / BK + 1, 1);  // the stripes, then the bias
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = BwdTile<kTc, TW, TD, BK>::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;  // dedy is summed across the split
  cfg.numAttrs = cluster_launch_attrs(attr, dedy != nullptr ? split : 1, 1, pdl);
  return cudaLaunchKernelEx(&cfg, stripe_bwd_kernel<kTc, TW, TD, BK>, tmd, tmw, tml, dedx, yprev,
                            in_mask, w, delta, b, db, gout, dedy, copies.dedy, bf16_ld(K), deriv,
                            M, K, N, mom, A, Bc, sr_key, flags, d_tma, w_tma, l_tma,
                            vec_ok(yprev, K), vec_ok(w, N), vec_ok(delta, N), vec_ok(gout, N),
                            vec_ok(dedy, K), early);
}

// Rows of dedx the backward takes: the stripe's dedy lives in registers (32 a
// thread), so the stripe narrows as M grows (BK = 64, 32, 16 up to 128, 256,
// 512 rows).
constexpr int kBwdMaxRows = 512;
static_assert(BwdTile<true, float, float, 16>::kMaxM == kBwdMaxRows, "rows of stripe_bwd_kernel");

// The stripe's rows for M rows of dedx (0: more than the kernel takes).
inline int bwd_stripe_rows(int M) {
  return M <= kBwdSubM ? 64 : (M <= 2 * kBwdSubM ? 32 : (M <= kBwdMaxRows ? 16 : 0));
}

// The backward's plan for M rows in one product form: out[0] the split of N
// (the cluster, where dedy is summed), out[1] the stripes, out[2] their rows
// (BK).
template <bool kTc, typename TW, typename TD>
static cudaError_t bwd_plan(int M, int K, int N, bool with_dedy, int out[3]) {
  out[2] = bwd_stripe_rows(M);
  if (out[2] == 0) return cudaErrorInvalidValue;
  out[1] = (K + out[2] - 1) / out[2];
  if (out[2] == 64) return bwd_split<kTc, TW, TD, 64>(K, N, with_dedy, &out[0]);
  if (out[2] == 32) return bwd_split<kTc, TW, TD, 32>(K, N, with_dedy, &out[0]);
  return bwd_split<kTc, TW, TD, 16>(K, N, with_dedy, &out[0]);
}

template <bool kTc, typename TW, typename TD>
static cudaError_t launch_bwd_form(const float* dedx, const Bf16Copies& copies,
                                   const float* yprev, const MaskSpec& in_mask, TW* w, TD* delta,
                                   float* b, float* db, float* gout, float* dedy, int deriv, int M,
                                   int K, int N, float mom, float A, float Bc, uint32_t sr_key,
                                   int flags, bool pdl, int early, cudaStream_t stream) {
  switch (bwd_stripe_rows(M)) {
    case 64:
      return launch_bwd_bk<kTc, TW, TD, 64>(dedx, copies, yprev, in_mask, w, delta, b, db, gout,
                                            dedy, deriv, M, K, N, mom, A, Bc, sr_key, flags, pdl,
                                            early, stream);
    case 32:
      return launch_bwd_bk<kTc, TW, TD, 32>(dedx, copies, yprev, in_mask, w, delta, b, db, gout,
                                            dedy, deriv, M, K, N, mom, A, Bc, sr_key, flags, pdl,
                                            early, stream);
    case 16:
      return launch_bwd_bk<kTc, TW, TD, 16>(dedx, copies, yprev, in_mask, w, delta, b, db, gout,
                                            dedy, deriv, M, K, N, mom, A, Bc, sr_key, flags, pdl,
                                            early, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// One launch of stripe_bwd_kernel.  dedy: (M, K), or nullptr when the layer
// below needs no gradient (the first layer).  tc: the tensor-core products,
// which read dedx's bfloat16 copy (copies.dedx, (M, bf16_ld(N)), 16-byte
// aligned; and write rne(dedy) into copies.dedy, (M, bf16_ld(K)), where it is
// given), else float32 FMA ones (no copies).  gout: K*N + N floats for the
// gradient-out form (W is then only read, and delta, b and db may be
// nullptr), or nullptr for the in-place update.  At most kBwdMaxRows rows
// (else cudaErrorInvalidValue).  pdl, early: a programmatic dependent launch
// (launch_bwd_bk), either form.
template <typename TW, typename TD>
inline cudaError_t launch_bwd(const float* dedx, const Bf16Copies& copies, const float* yprev,
                              const MaskSpec& in_mask, TW* w, TD* delta, float* b, float* db,
                              float* gout, float* dedy, int deriv, int M, int K, int N, float mom,
                              float A, float Bc, uint32_t sr_key, int flags, bool tc,
                              cudaStream_t stream, bool pdl = false, int early = 0) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  return tc ? launch_bwd_form<true>(dedx, copies, yprev, in_mask, w, delta, b, db, gout, dedy,
                                    deriv, M, K, N, mom, A, Bc, sr_key, flags, pdl, early, stream)
            : launch_bwd_form<false>(dedx, copies, yprev, in_mask, w, delta, b, db, gout, dedy,
                                     deriv, M, K, N, mom, A, Bc, sr_key, flags, pdl, early,
                                     stream);
}

// dedx's bfloat16 copy for a caller that holds float32 dedx alone (the
// standalone wrappers, the data-parallel trainer): out (M, ld) = rne(x (M,
// N)), st_cvt4's rounding, zeros in columns N..ld-1.  Four columns a thread;
// bound: bytes (4 read and 2 written an element).
__global__ void __launch_bounds__(256)
bf16_copy_kernel(const float* __restrict__ x, bf16_t* __restrict__ out, int M, int N, int ld,
                 bool vec) {
  const int c4 = ld / 4;
  const long long n = (long long)M * c4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / c4), col = (int)(i % c4) * 4;
    st_copy4(out, ld, row, col, N, ld4(x, row, col, N, M, N, vec));
  }
}

// One launch of bf16_copy_kernel: out, 16-byte aligned, of bf16_ld(N) columns.
inline cudaError_t launch_bf16_copy(const float* x, bf16_t* out, int M, int N,
                                    cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0) return cudaErrorInvalidValue;
  const int ld = bf16_ld(N);
  const long long n = (long long)M * (ld / 4);
  const int blocks = (int)((n + 255) / 256 < 4 * 132 ? (n + 255) / 256 : 4 * 132);
  bf16_copy_kernel<<<blocks, 256, 0, stream>>>(x, out, M, N, ld, vec_ok(x, N));
  return cudaGetLastError();
}

}  // namespace sednn
