// The CRN's LSTM recurrence for Hopper (sm_90a): one persistent kernel a
// layer (model/crn.py:lstm_layer) runs all T steps of the layer in one
// launch, each step
//
//   G = proj[t] + h[t-1] W_hh,  i, f, o = sigmoid(G_i, G_f, G_o),  g = tanh(G_g)
//   c' = f c + i g,  h[t] = o tanh(c')
//
// G's row holds the four gates' H columns in the order i, f, g, o.
//
// Replaces no TPU kernel: the JAX package runs no recurrence.  Bound: the
// step's product, 2 B H 4H float32 operations (537 MFLOP at B = 64, H = 1024:
// 8.0 us at 67 TFLOP/s), and the dependence of every step on the whole of
// the step before.  A step as a cuBLAS product and a cell launch took 22.3 us
// in three launches (a 64-row product on 32 of 132 SMs, its split-K
// reduction, the cell).
//
// Design (the plan is ops/lstm_cell.py:lstm_plan, a function of B, H and the
// card's SMs and shared memory):
//
// - One block an SM, all co-resident (a cooperative launch; a grid that
//   cannot be resident is refused before it starts, never left to hang).  A
//   block owns `units` (U) hidden units, i.e. 4U columns of W_hh (the i, f,
//   g, o columns of each unit).  At H = 1024 and 132 SMs: 128 blocks of 8.
// - The weights stay put: each of the 8 compute warps' threads holds 128
//   floats of the block's W_hh slice in registers for all T steps (16 k's by
//   8 columns, the 8 columns being 2 units' 4 gates; a warp's lanes cover
//   512 k's, k = 512 kw + 128 j + 4 lane + kk), so no step reads a weight.
//   Where the slice does not fit (H above 512 x 8 / (U / 2), or more than 16
//   units a block), the same loop runs in passes over k and over columns and
//   reloads the registers from global memory each pass and step ("streamed");
//   the sums of a column pass are carried over the k passes in shared memory.
// - Operand traffic: with W in registers only h is read from shared memory,
//   a float4 a lane and 32 FMAs for it (8 columns x 4 k's), lanes on
//   consecutive 16-byte words (no bank conflict).  Rows go four at a time (32
//   independent sums a thread); a lane's 8 partial sums of a row are summed
//   over the warp's 32 lanes by a reduce-scatter of shuffles (9 a row), then
//   over the warps of a column group in shared memory.
// - h[t-1] comes in chunks of 16 rows, copied into a ring of shared-memory
//   stages (rows of 1024 floats) by a 1-D bulk copy (TMA; one a row in a pass
//   over k) that completes on the stage's mbarrier.  Each block keeps a
//   counter of its cell chunks done in global memory.  One warp, the copier,
//   reads every block's counter (relaxed) before the last rows of a chunk;
//   early in the next chunk one fence of its (acq_rel, gpu) both acquires
//   those reads and releases the h stores of the cell chunks finished before
//   the chunk's barrier (a chunk late: they have drained), then it stores the
//   block's counter and copies every chunk whose rows are all written into
//   the slots freed.  A chunk of step t needs only the same rows of step t-1,
//   which every block finished chunks earlier, so the grid-wide dependence
//   costs no wait while the blocks keep pace.  (A ninth warp as producer
//   would cap registers at 168 a thread, 3 warps on an SM partition, and
//   spill W.)
// - The cell: after a chunk's barrier, 16 x 2 x (column groups) threads each
//   add the partial sums with proj[t] (prefetched into registers a chunk
//   ahead) and update one unit of one row: c lives in shared memory for all T
//   steps, h goes to hs[t + 1] (the output, which the next step's copies
//   read).  No gate is written back.
// - Measured on an H100 SXM (700 W, 1,980 MHz throughout) at B = 64,
//   H = 1024: a step takes about 20 us, the FMA loop issuing at about half
//   the FFMA rate.  Taking out the sums over the lanes, the cell update or
//   the copies saves under 0.3 us each; the same loop with FADDs in place of
//   the FFMAs runs a step in 11 us, and with FFMAs that read 2 W registers
//   instead of 128 in 15 us.
//
// The cell's arithmetic is the plain version's (ops/lstm_cell.py), one
// rounding an operation: sigmoid as 1 / (1 + expf(-x)) and tanhf, as
// PyTorch's CUDA kernels compute them, and the products and the sum with
// round-to-nearest intrinsics, so that the compiler contracts nothing into a
// fused multiply-add.  The step's product is float32 FMAs (no TF32), summed
// in the order above.
//
// lstm_steps_f32 launches on `stream` and does not synchronise; it allocates
// nothing (the counters are the caller's, zeroed); it returns a CUDA error
// code (0 on success; cudaErrorInvalidValue for a plan it does not take,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident).
// A wait of 5 s in the kernel (a block that never comes) traps: a launch
// error at the next synchronisation, never a hang.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // 2 an SM partition: up to 255 registers a thread
constexpr int kThreads = 32 * kWarps;
constexpr int kCopier = kWarps - 1;  // the warp that publishes the block's counter and copies h
constexpr int kPollRegs = 8;         // block counters a lane reads: grids of up to 256 blocks
constexpr int kRows = 16;  // rows of h a ring stage holds
constexpr int kWarpK = 512;                  // k's a warp covers: 32 lanes x 4 float4s
constexpr int kStride = 1024;  // floats a row of a ring stage holds (a pass's k's, at most)
constexpr int kMaxRing = 8;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int T, B, row0, rows, H;  // steps; the batch (row stride of a step), this launch's rows; units
  int units;                // U, units a block owns
  int col_groups;           // CG: 8-column groups a pass (2 units each); 8 / CG warps along k
  int col_passes;           // U / (2 CG)
  int k_passes;             // ceil(H / k_pass), k_pass = 512 x 8 / CG
  int chunks;               // ceil(rows / kRows)
  int ring;                 // stages
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// a wait this long means a block that never comes: trap (a launch error) rather than hang
constexpr uint64_t kWatchdogNs = 5000000000ull;
__device__ __forceinline__ void watchdog(uint64_t t0) {
  if (globaltimer() - t0 > kWatchdogNs) __trap();
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity)) watchdog(t0);
}
// `bytes` (a multiple of 16) from global src (16-byte aligned) to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}
// orders this thread's generic-proxy accesses of global memory with bulk copies' (async proxy)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cell(float gi, float gf, float gg, float go, float& c, float& h) {
  const float i = sigmoid_f(gi), f = sigmoid_f(gf), g = tanhf(gg), o = sigmoid_f(go);
  c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  h = __fmul_rn(o, tanhf(c));
}

// v[0..7] summed over the warp's 32 lanes: lane l gets column 4 b4 + 2 b3 + b2 (its bits 4,
// 3, 2), by halving the columns a lane holds at each exchange, then two exchanges of sums
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (b3 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, b3 ? a[i] : a[i + 2], 8);
  float s = (b2 ? b[1] : b[0]) + __shfl_xor_sync(kFull, b2 ? b[0] : b[1], 4);
  s += __shfl_xor_sync(kFull, s, 2);
  return s + __shfl_xor_sync(kFull, s, 1);
}

// A chunk in the loop's order: rc fastest, then kp, cp and t.
struct ChunkIdx {
  int t, cp, kp, rc;
  __device__ __forceinline__ void next(const Plan& p) {
    if (++rc < p.chunks) return;
    rc = 0;
    if (++kp < p.k_passes) return;
    kp = 0;
    if (++cp < p.col_passes) return;
    cp = 0;
    ++t;
  }
};
// the least block counter chunk m needs: rows rc of h[t-1] from every block's last column pass
__device__ __forceinline__ unsigned chunk_need(const Plan& p, const ChunkIdx& c) {
  return c.t == 0 ? 0u
                  : (unsigned)(((c.t - 1) * p.col_passes + p.col_passes - 1) * p.chunks + c.rc + 1);
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_layer_kernel(const float* __restrict__ proj, const float* __restrict__ w_hh, float* hs,
                  float* __restrict__ c_io, unsigned* flags, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kMaxRing * sizeof(uint64_t));
  const int stage = kRows * kStride;
  float* red = ring + p.ring * stage;  // [2][k warps][kRows][8 CG]: partial sums of a chunk
  float* c_s = red + 2 * kRows * 8 * kWarps;  // [rows][U]
  float* acc = c_s + p.rows * p.units;         // [rows][8 CG]: a column pass's sums over k passes

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H, CG = p.col_groups, cols = 8 * CG, pair_units = 2 * CG;
  const int u0 = blockIdx.x * p.units;
  const int k_pass = kWarpK * (kWarps / CG);
  const int n_cell = kRows * pair_units;
  const long long step_h = (long long)p.B * H;
  const int total = p.T * p.col_passes * p.k_passes * p.chunks;

  if (tid == 0) {
    for (int i = 0; i < p.ring; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < p.rows * p.units; i += kThreads) {
    const int row = i / p.units, gu = u0 + i % p.units;
    c_s[i] = gu < H ? c_io[(long long)(p.row0 + row) * H + gu] : 0.0f;
  }
  // a row's floats past those copied stay 0: the k's there, whose W is 0, read them
  for (int i = tid; i < p.ring * stage; i += kThreads) ring[i] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the copies land
  __syncthreads();

  // The copier warp's state: the next chunk to copy, the least block counter seen (acquired),
  // its lanes' counters read (relaxed) before the last rows of a chunk, and the block's cell
  // chunks done, those whose h stores came before the last barrier, and those published.
  int issued = 0;
  ChunkIdx next_copy = {0, 0, 0, 0};  // chunk `issued`
  unsigned seen = 0, early[kPollRegs] = {}, done = 0, to_publish = 0, released = 0;
  auto read_early = [&]() {
#pragma unroll
    for (int i = 0; i < kPollRegs; ++i)
      early[i] = lane + 32 * i < (int)gridDim.x ? ld_relaxed(flags + lane + 32 * i) : 0xffffffffu;
  };
  // Copier warp, after a barrier: one fence acquires the counters read and releases the h
  // stores before the barrier (a chunk late, so they have drained); the block's counter moves
  // on; then every chunk whose rows are all written is copied into the free slots, up to
  // chunk `last`.
  auto sync_copy = [&](int last) {
    unsigned m = early[0];
#pragma unroll
    for (int i = 1; i < kPollRegs; ++i) m = min(m, early[i]);
    m = __reduce_min_sync(kFull, m);
    fence_acq_rel_gpu();
    if (lane == 0 && released < to_publish) st_relaxed(flags + blockIdx.x, to_publish);
    released = to_publish;
    seen = max(seen, m);
    bool fenced = false;
    for (; issued <= last && issued < total; ++issued, next_copy.next(p)) {
      const ChunkIdx c = next_copy;
      if (chunk_need(p, c) > seen) break;
      if (!fenced) fence_proxy_async_global();  // the copies after the acquire
      fenced = true;
      const int slot = issued % p.ring, r0 = c.rc * kRows, nrow = min(kRows, p.rows - r0);
      const int k0 = c.kp * k_pass, kvalid = min(k_pass, H - k0);
      const float* src = hs + c.t * step_h + (long long)(p.row0 + r0) * H + k0;
      float* dst = ring + slot * stage;
      // rows whole in global memory and as long as the stage's: one copy, else one a row
      const bool one_copy = kvalid == H && H == kStride;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[slot], (uint32_t)(nrow * kvalid * 4));
        if (one_copy) bulk_load(dst, src, (uint32_t)(nrow * H * 4), &full[slot]);
      }
      __syncwarp();
      if (!one_copy && lane < nrow)
        bulk_load(dst + lane * kStride, src + (long long)lane * H, (uint32_t)(kvalid * 4),
                  &full[slot]);
    }
  };
  if (warp == kCopier) sync_copy(p.ring - 1);  // step 0 waits for nothing

  const int cg = warp % CG, kw = warp / CG;
  const int cr = tid / pair_units, cu = tid % pair_units;  // a cell thread's row and unit
  float w[4][4][8];
  float pj[4];  // proj of the next cell chunk

  auto load_w = [&](int cp, int kp) {
    const int gu = u0 + cp * pair_units + 2 * cg;  // the first of the thread's two units
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kp * k_pass + kw * kWarpK + 128 * j + 4 * lane + kk;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float2 v = make_float2(0.0f, 0.0f);
          if (k < H && gu < H)
            v = *reinterpret_cast<const float2*>(w_hh + (long long)k * 4 * H + g * H + gu);
          w[j][kk][g] = v.x;
          w[j][kk][4 + g] = v.y;
        }
      }
  };
  auto load_proj = [&](int t, int cp, int rc) {
    const int row = rc * kRows + cr, gu = u0 + cp * pair_units + cu;
    const bool ok = tid < n_cell && row < p.rows && gu < H;
    const float* src = proj + ((long long)t * p.B + p.row0 + row) * 4 * H + gu;
#pragma unroll
    for (int g = 0; g < 4; ++g) pj[g] = ok ? src[g * H] : 0.0f;
  };

  load_proj(0, 0, 0);
  const bool resident = p.k_passes == 1 && p.col_passes == 1;
  if (resident) load_w(0, 0);
  int n = 0;
  for (int t = 0; t < p.T; ++t)
    for (int cp = 0; cp < p.col_passes; ++cp)
      for (int kp = 0; kp < p.k_passes; ++kp) {
        if (!resident) load_w(cp, kp);
        const int kvalid = min(k_pass, H - kp * k_pass);
        // a lane's k's of each float4 within a stage's row, or (past kStride, W = 0 there) the
        // row's start
        int koff[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kw * kWarpK + 128 * j + 4 * lane;
          koff[j] = k < kStride ? k : 0;
        }
        const bool last = kp == p.k_passes - 1;
        for (int rc = 0; rc < p.chunks; ++rc, ++n) {
          const int slot = n % p.ring, nrow = min(kRows, p.rows - rc * kRows);
          float* part = red + (n & 1) * kRows * 8 * kWarps;
          // Where chunk n needs the rows of the chunk just done (one chunk a step) or the one
          // before, the counter moves on before the wait for them.
          if (p.chunks == 1 && n > 0) {
            __syncthreads();
            to_publish = done;
          }
          if (warp == kCopier && p.chunks <= 2 && n > 0) sync_copy(n + p.ring - 1);
          if (warp == kCopier && issued <= n) {  // chunk n not copied yet: wait for its rows
            const uint64_t t0 = globaltimer();
            while (issued <= n) {
              read_early();
              sync_copy(n + p.ring - 1);
              if (issued <= n) {
                __nanosleep(32);
                watchdog(t0);
              }
            }
          }
          mbar_wait(&full[slot], (n / p.ring) & 1);
          const float* hst = ring + slot * stage;
          // four rows at a time: 16 k's of each by the thread's 8 columns, summed over the
          // warp's lanes into `part` (rows past nrow read stale rows of the stage: dropped)
          for (int r = 0; r < nrow; r += 4) {
            // the counters, fresh, for the copies after this chunk (their load is in flight
            // while the last rows are computed)
            if (warp == kCopier && r + 4 >= nrow) read_early();
            // the copier's fence (about 1,000 cycles), in the second group
            if (warp == kCopier && p.chunks > 2 && n > 0 && r == (nrow > 4 ? 4 : 0))
              sync_copy(n - 1 + p.ring);
            float a[4][8];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) a[q][cc] = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float4 x[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                x[q] = *reinterpret_cast<const float4*>(hst + (r + q) * kStride + koff[j]);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float xv = (&x[q].x)[kk];
#pragma unroll
                  for (int cc = 0; cc < 8; ++cc) a[q][cc] = fmaf(xv, w[j][kk][cc], a[q][cc]);
                }
            }
            float sum[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) sum[q] = warp_sum8(a[q], lane);
            if ((lane & 3) == 0) {
              const int col = cg * 8 + ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                              ((lane >> 2) & 1);
              float* dst = part + (kw * kRows + r) * cols + col;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (r + q < nrow) dst[q * cols] = sum[q];
            }
          }
          __syncthreads();  // the chunk's partial sums are in `part`; its slot is free
          to_publish = done;  // cell chunks whose h stores came before this barrier
          const int row = rc * kRows + cr, unit = cp * pair_units + cu, gu = u0 + unit;
          if (tid < n_cell && cr < nrow && gu < H) {
            const float* src = part + cr * cols + (cu >> 1) * 8 + (cu & 1) * 4;
            float s[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) s[g] = src[g];
            for (int q = 1; q < kWarps / CG; ++q)
#pragma unroll
              for (int g = 0; g < 4; ++g) s[g] += src[q * kRows * cols + g];
            if (p.k_passes > 1) {
              float* a = acc + row * cols + (cu >> 1) * 8 + (cu & 1) * 4;
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                if (kp > 0) s[g] = a[g] + s[g];
                if (!last) a[g] = s[g];
              }
            }
            if (last) {
              float& c = c_s[row * p.units + unit];
              float h;
              cell(pj[0] + s[0], pj[1] + s[1], pj[2] + s[2], pj[3] + s[3], c, h);
              hs[(t + 1) * step_h + (long long)(p.row0 + row) * H + gu] = h;
            }
          }
          if (last) {
            // the next cell chunk's proj, a chunk or more ahead of its use
            int t2 = t, cp2 = cp, rc2 = rc + 1;
            if (rc2 == p.chunks) {
              rc2 = 0;
              if (++cp2 == p.col_passes) cp2 = 0, ++t2;
            }
            if (t2 < p.T) load_proj(t2, cp2, rc2);
            done = (unsigned)((t * p.col_passes + cp) * p.chunks + rc + 1);
          }
        }
      }
  __syncthreads();
  for (int i = tid; i < p.rows * p.units; i += kThreads) {
    const int row = i / p.units, gu = u0 + i % p.units;
    if (gu < H) c_io[(long long)(p.row0 + row) * H + gu] = c_s[i];
  }
}

size_t smem_bytes(const Plan& p) {
  return kMaxRing * sizeof(uint64_t) +
         sizeof(float) * ((size_t)p.ring * kRows * kStride + 2 * kRows * 8 * kWarps +
                          (size_t)p.rows * p.units +
                          (p.k_passes > 1 ? (size_t)p.rows * 8 * p.col_groups : 0));
}

bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15u) == 0; }

}  // namespace

// The card's limits the plan (ops/lstm_cell.py:lstm_plan) is made for: SMs and the shared
// memory a block may opt in to, of the current device.
extern "C" int lstm_card_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// A layer's T steps for rows row0 .. row0 + rows - 1 of the batch: for t = 0 .. T-1, the
// gates proj[t] + hs[t] W_hh and the cell update of c into hs[t + 1].  proj (T, B, 4H) and
// w_hh (H, 4H) are read; hs (T + 1, B, H) holds the initial h in hs[0]; c (B, H) the
// initial cell, updated in place; all float32, row-major, contiguous and 16-byte aligned,
// H a multiple of 4.  flags: `grid` zeroed counters, this launch's own.  The plan is
// ops/lstm_cell.py:lstm_plan's, taken as given and only checked: that it covers the layer
// (units, k passes, blocks), that a pass's k's fit a stage's row, that `smem` holds the
// kernel's buffers and the card gives it, and that the grid can be resident.
extern "C" int lstm_steps_f32(const float* proj, const float* w_hh, float* hs, float* c,
                              unsigned* flags, int T, int B, int row0, int rows, int H, int units,
                              int col_groups, int k_passes, int col_passes, int ring, int grid,
                              int smem, void* stream) {
  if (T <= 0 || rows <= 0) return 0;
  const bool cg_ok = col_groups == 1 || col_groups == 2 || col_groups == 4 || col_groups == 8;
  if (B <= 0 || row0 < 0 || row0 + rows > B || H <= 0 || H % 4 != 0 || !cg_ok ||
      col_passes <= 0 || units != 2 * col_groups * col_passes || ring < 2 || ring > kMaxRing ||
      !aligned16(proj) || !aligned16(w_hh) || !aligned16(hs) || !aligned16(c))
    return (int)cudaErrorInvalidValue;
  const long long k_pass = kWarpK * (kWarps / col_groups);
  if (k_passes <= 0 || k_passes * k_pass < H || (k_passes - 1) * k_pass >= H ||
      (k_pass < H ? k_pass : H) > kStride || grid <= 0 || (long long)grid * units < H)
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.T = T, p.B = B, p.row0 = row0, p.rows = rows, p.H = H;
  p.units = units, p.col_groups = col_groups, p.col_passes = col_passes;
  p.k_passes = k_passes, p.chunks = (rows + kRows - 1) / kRows, p.ring = ring;
  if (smem < 0 || (size_t)smem < smem_bytes(p)) return (int)cudaErrorInvalidValue;

  static bool attr_set[kMaxDevices] = {};
  int dev = 0, sms = 0, optin = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(lstm_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  // every block resident at once, or no launch: a block waits on every other block's rows
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_layer_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < grid || grid > 32 * kPollRegs)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&proj, &w_hh, &hs, &c, &flags, &p};
  err = cudaLaunchCooperativeKernel((const void*)lstm_layer_kernel, dim3(grid), dim3(kThreads),
                                    args, (size_t)smem, (cudaStream_t)stream);
  return (int)err;
}
