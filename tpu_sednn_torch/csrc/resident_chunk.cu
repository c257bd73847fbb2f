// Whole-chunk trainer and its dropout stream for Hopper (sm_90a).
//
// Replaces tpu_sednn/ops/resident_chunk.py:_resident_kernel (kernel 3: the
// TPU kernel that trains a whole chunk in one launch with the state pinned
// in on-chip memory) and the dropout bits it draws in the kernel
// (:307-331) with their probe, the kernel of sample_resident_masks (:970;
// kernel 4).
//
// An H100 block has 227 KB of shared memory and the card 50 MB of L2, so the
// float32 state (W and Delta, 47 MB each at 1548-2048x3-129) lives in device
// memory.  What stays out of device memory instead: no gradient matrix is
// ever written, W and Delta are read once and written once per bunch in the
// backward, and masks, pre-activations and the output layer's dedx never
// exist as separate passes.  One call of resident_chunk_train enqueues, for
// every bunch i < n_real and in order on one stream, the forward launches
// (fused_mlp.cuh:f32_fwd_kernel or tc_fwd_kernel, K split within a
// thread-block cluster; the input's mask is read from the call's bit table
// while x is loaded, each hidden layer's mask drawn in the epilogue of the
// layer that feeds it, dedx in the last layer's epilogue) and the backward
// launches, last layer first:
// stripe_bwd_kernel in either product form (dedy summed inside the kernel,
// across a thread-block cluster, with the derivative in its epilogue).  With
// tensor-core products, the epilogue that writes dedx (the head's forward, or
// the backward of the layer above as dedy) also writes rne(dedx), which the
// backward's products read by tensor copies; the bias blocks sum the float32
// dedx.  Likewise the forward of each hidden layer writes rne(y) beside its
// masked activation y, and the next layer's forward reads that copy by
// tensor copies in place of rounding y (layer 0 reads the float32 input and
// its mask).  So a
// bunch of L layers is 2L launches in either product form, and the workspace
// holds no partial sums.  A single stream keeps the two orders the update
// rule needs: dedy of layer l uses W_l before its update (one kernel does
// both), and the forward of bunch i+1 sees W after bunch i.  No host
// synchronisation, no allocation.
//
// The chain overlaps its launches in both product forms (Hopper's
// programmatic dependent launch, pdl.cuh): every launch after the call's
// first may start while the one before it finishes, and loads before its
// griddepcontrol.wait the operands that launch does not write, as the plan of
// ops/resident_chunk.py:early_read_plan names them: the forward of layer
// l >= 1 its W (the forward of layer 0 follows the backward that just wrote
// W_0), every backward its W, Delta and yprev.  Only x and dedx (each with its
// bfloat16 copy) come from the launch just before.  The two forms launch the
// same chain, so one plan serves both.
//
// Bound: per bunch 2 * 128 * K*N FLOP for each product: three a layer
// (forward, gradient, dedy) but two for the first, which has no layer below
// to hand a dedy to; at 1548-2048x3-129 that is 8.27 GFLOP against 5 passes
// over W or Delta (forward read, backward read and write of both).  With
// float32 FMA products (bf16 == 0) operations-bound on an H100; with the
// tensor-core products (bf16 != 0, the TPU kernel's default bf16=True)
// bytes-bound (see fused_mlp.cuh).  Every storage form below runs with
// either.
//
// Dropout stream: Philox4x32-10 (philox.cuh) keyed on
// (seed + bunch*7919 + layer*104729) mod 2^32, counter = the element's
// (row, column) in the global bunch.  The input's masks of a call are drawn
// once, before its chain, by one launch of input_mask_bits_kernel into a
// table of keep bits (32 columns a word, one table a tile), which the layer-0
// forward and backward read: drawn in those kernels, every column tile of
// the forward and every split of the backward would draw all of x again.
// The backward never regenerates a hidden layer's mask: the stored
// activation is the masked one, and the derivative is taken on it.
//
// Variants of the TPU kernel, all through the same launches:
// * bfloat16 state with stochastic rounding (its sr_delta: Delta of the
//   weight matrices bfloat16, W float32 and stepped by the unrounded Delta';
//   its sr_state: W and Delta bfloat16, two draws an element).  The kernels
//   are templated on the storage types (fused_mlp.cuh); the stream of
//   (bunch i, layer l) is keyed seed + i*7919 + l*104729 + 1 (sr_round.cuh).
//   Biases and their momentum stay float32.  With float32 products the
//   trainer is operations-bound, so halving two or five of the passes over
//   the state does not make it faster; it halves the state's memory.
// * row tiles (its tile_rows < bunchsize, clean rule): a bunch of `accum`
//   tiles of `tile` rows each; every tile runs its own forward and backward,
//   the backward accumulating into Delta (kUpdFirst on tile 0, kUpdApply on
//   the last), so W is the pre-bunch W for every tile.  dedx carries 2/bunch,
//   the full bunch; dropout streams are keyed on the global tile index.
// * its hbm_spill needs nothing here: the state is in device memory already.
// * its bf16 products: the tensor-core forms of the two layer kernels
//   (tc_fwd_kernel, stripe_bwd_kernel's tensor-core form), one launch each a
//   layer.
// * its data-parallel form (n_dev > 1, make_dp_resident_train_chunk): a
//   rank trains its rows of every global tile and the gradient is summed
//   over the ranks before the update, so the chunk cannot be one C call: the
//   Python loop (ops/resident_chunk.py) calls dp_chunk_forward for a tile,
//   then for each layer, last first, the gradient-out backward, an
//   all-reduce and the update kernel (fused_mlp.cu).  The forward is the
//   same launches as here, at the rank's rows row0.. of the global tile: the
//   loop draws the rank's rows of a call's input masks once, by one launch
//   of input_mask_bits_kernel at row0, into a bit table that each tile's
//   layer-0 forward and gradient-out backward read; each hidden layer's mask
//   is drawn in the epilogue at row0 + r, as here.

#include "fused_mlp.cuh"

using namespace sednn;

namespace {

constexpr unsigned kBunchStride = 7919u;
constexpr unsigned kLayerStride = 104729u;
constexpr int kMaxLayers = 16;

// Offsets in floats into the trainer's workspace.  dedx ping-pongs between
// two float32 buffers (a layer's backward reads one and writes dedy, the next
// layer's dedx, into the other), and so does its bfloat16 copy, which the
// tensor-core chain writes beside it (rne(dedx), bf16_ld rows) and its
// backward reads.  The stored input of each layer l >= 1 has its bfloat16
// copy too (rne(y), bf16_ld rows), which the tensor-core chain's forward of
// layer l reads.  Each copy 16-byte aligned; the float32 chain leaves the
// copies unused.
struct Workspace {
  long long ys[kMaxLayers];     // offset of the stored input of layer l (l >= 1)
  long long ys_bf[kMaxLayers];  // offset of its bfloat16 copy (l >= 1)
  long long out, dedx_a, dedx_b, bf_a, bf_b, total;
};

// `bunch`: the rows one forward and backward work on (a row tile's).
Workspace plan_workspace(const int* sizes, int L, int bunch) {
  Workspace ws;
  long long off = 0, max_w = 0;
  ws.ys[0] = -1;
  for (int l = 1; l < L; ++l) {
    ws.ys[l] = off;
    off += (long long)bunch * sizes[l];
  }
  for (int l = 0; l <= L; ++l) max_w = sizes[l] > max_w ? sizes[l] : max_w;
  ws.out = off;
  off += (long long)bunch * sizes[L];
  ws.dedx_a = off;
  off += (long long)bunch * max_w;
  ws.dedx_b = off;
  off += (long long)bunch * max_w;
  const long long bf_floats = ((long long)bunch * bf16_ld((int)max_w) / 2 + 3) / 4 * 4;
  off = (off + 3) / 4 * 4;
  ws.bf_a = off;
  off += bf_floats;
  ws.bf_b = off;
  off += bf_floats;
  ws.ys_bf[0] = -1;
  for (int l = 1; l < L; ++l) {
    ws.ys_bf[l] = off;
    off += ((long long)bunch * bf16_ld(sizes[l]) / 2 + 3) / 4 * 4;
  }
  ws.total = off;
  return ws;
}

__global__ void mask_probe_kernel(float* __restrict__ out, int rows, int cols, MaskSpec spec) {
  const int c4 = (cols + 3) / 4;
  const long long n = (long long)rows * c4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / c4), col = (int)(i % c4) * 4;
    float m[4];
    mask4(spec, row, col, cols, m);
    for (int j = 0; j < 4 && col + j < cols; ++j) out[(long long)row * cols + col + j] = m[j];
  }
}

// The chunk trainer's input masks of a call, drawn once: for global tile gi
// < n_tiles, row r < tile and word w < words = mask_words(K),
//   out[(gi * tile + r) * words + w] bit b = the keep of column 32 w + b of
//   row row0 + r under key seed + gi * kBunchStride (mode 2's decision; 0
//   at or past K),
// which the tile's layer-0 forward and backward read (MaskSpec mode 3).
// row0: 0 for the single-device trainer; a data-parallel rank's first row of
// the global tile, so that its table holds its rows of the single-device
// masks.
// Replaces the input's share of the TPU kernel's in-kernel bits
// (tpu_sednn/ops/resident_chunk.py:315-319: the net's input mask drawn once
// a bunch).  A block takes a row at a time (a grid-stride loop over the
// rows, its tile and row within it stepped without a division), a thread a
// Philox call of the row (4 columns, one nibble), and 8 neighbouring lanes
// join their nibbles into a word by three xor shuffles: no atomics, each word
// written once by one lane, a warp's 4 words side by side.  Bound: the Philox
// calls (ceil(K / 4) a row, 20 32x32 -> 64-bit products each) on the
// integer multipliers; the table itself (4 bytes for 32 columns) is a small
// share of that time.
__global__ void input_mask_bits_kernel(uint32_t* __restrict__ out, int n_tiles, int tile,
                                       int row0, int K, unsigned seed, unsigned threshold) {
  const int words = mask_words(K), calls = 8 * words;
  const int rows = n_tiles * tile;  // the launcher checks that it fits
  int gi = blockIdx.x / tile, r = blockIdx.x % tile;
  const int gi_step = gridDim.x / tile, r_step = gridDim.x % tile;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const unsigned key = seed + (unsigned)gi * kBunchStride;
    uint32_t* row_out = out + (long long)row * words;
    // every lane of a warp takes the same trips (blockDim.x is a multiple of
    // 32), so the shuffles see all 32
    for (int t = threadIdx.x; t - (int)(threadIdx.x & 31) < calls; t += blockDim.x) {
      const int sub = t & 7;
      unsigned v = t < calls ? philox_keep4(key, threshold, row0 + r, 4 * t, K) << (4 * sub) : 0u;
      v |= __shfl_xor_sync(0xffffffffu, v, 1);
      v |= __shfl_xor_sync(0xffffffffu, v, 2);
      v |= __shfl_xor_sync(0xffffffffu, v, 4);
      if (t < calls && sub == 0) row_out[t >> 3] = v;
    }
    gi += gi_step;
    r += r_step;
    if (r >= tile) {
      r -= tile;
      ++gi;
    }
  }
}

// Launches input_mask_bits_kernel on `stream`: a row's calls in one block
// where they fit (up to 1024 threads: K <= 4096), some 16 blocks an SM.
cudaError_t launch_input_mask_bits(uint32_t* out, int n_tiles, int tile, int row0, int K,
                                   unsigned seed, unsigned threshold, cudaStream_t stream) {
  const long long rows = (long long)n_tiles * tile;
  if (n_tiles < 0 || tile <= 0 || row0 < 0 || K <= 0 || rows > 0x7FFFFFFFll ||
      (long long)row0 + tile > 0x7FFFFFFFll)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int calls = 8 * mask_words(K), threads = calls < 1024 ? (calls + 31) / 32 * 32 : 1024;
  const int blocks = (int)(rows < 132 * 16 ? rows : 132 * 16);
  input_mask_bits_kernel<<<blocks, threads, 0, stream>>>(out, n_tiles, tile, row0, K, seed,
                                                          threshold);
  return cudaGetLastError();
}

__global__ void philox_words_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* p = in + 6 * i;
  uint32_t w[4];
  philox4x32_10(p[0], p[1], p[2], p[3], p[4], p[5], w);
  for (int j = 0; j < 4; ++j) out[4 * i + j] = w[j];
}

}  // namespace

// Floats of workspace resident_chunk_train needs for tiles of `bunch` rows
// (either product form; the float32 chain leaves the bfloat16 copies'
// share unused); sizes has L + 1 entries.
extern "C" long long resident_workspace_floats(const int* sizes, int L, int bunch) {
  if (L < 1 || L > kMaxLayers) return -1;
  return plan_workspace(sizes, L, bunch).total;
}

// Words of the input-mask table resident_chunk_train reads for a call of
// n_tiles tiles (n_real * accum) of `tile` rows of width K: n_tiles * tile *
// ceil(K / 32).
extern "C" long long resident_mask_words(int n_tiles, int tile, int K) {
  if (n_tiles < 0 || tile <= 0 || K <= 0) return -1;
  return (long long)n_tiles * tile * mask_words(K);
}

namespace {

// The flags early_read_plan (ops/resident_chunk.py) gives a programmatic
// dependent launch of the chain: the forward (direction 0) or the backward
// (1) of layer l, not the call's first launch.  plan: 4 * L ints, (direction
// * L + l) * 2 + (1 for the call's first launch).
inline int early_flags(const int* plan, int L, int direction, int l) {
  return plan[(direction * L + l) * 2];
}

// The forward of one tile of `tile` rows: layer l reads x (l == 0) or y[l-1]
// and writes y[l] (the masked activation the next layer and the backward
// read; y[L-1] is the net's output), and the last layer also writes dedx =
// coef*(y - t), and with dedx_bf (the tensor-core chain's) rne(dedx) beside
// it, bf16_ld(sizes[L]) a row.  y_bf (the tensor-core chain's; nullptr: none):
// y_bf[l], l < L - 1, the copy rne(y[l]) (bf16_ld(sizes[l + 1]) a row) that
// layer l writes beside y[l] and layer l + 1 reads in place of y[l].
// Dropout: the input's mask in_mask (in both trainers the
// tile's rows of the call's bit table, mode 3), hidden layer l+1's the stream
// key0 + (l+1)*kLayerStride drawn in the epilogue of layer l at the rows
// row0.. of the global tile, so a rank of the data-parallel trainer draws
// its rows of the single-device masks.  plan_rows: the rows K's split is planned for
// (launch_fwd; 0: tile).  plan (nullptr: none): the chain's early-read flags
// (early_flags), every launch a programmatic dependent one but the call's
// first; *first: this tile's forward begins the call (cleared by its first
// launch).
template <typename TW>
cudaError_t forward_tile(const float* x, const float* t, int tile, const int* sizes, int L,
                         void* const* w, float* const* b, float* const* y,
                         bf16_t* const* y_bf, float* dedx, bf16_t* dedx_bf, int hidden,
                         int output, const MaskSpec& in_mask, unsigned key0, unsigned thr_hid,
                         float scale_hid, int row0, float coef, int plan_rows, bool tc,
                         const int* plan, bool* first, cudaStream_t stream) {
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const MaskSpec out_mask =
        (!last && thr_hid)
            ? philox_mask(key0 + (unsigned)(l + 1) * kLayerStride, thr_hid, scale_hid, row0)
            : no_mask();
    FwdCopies copies;
    if (y_bf != nullptr) {
      if (l > 0) copies.x = y_bf[l - 1];
      if (!last) copies.y = y_bf[l];
    }
    if (last) copies.dedx = dedx_bf;
    const bool pdl = plan != nullptr && !*first;
    const cudaError_t err = launch_fwd(
        l == 0 ? x : y[l - 1], (const TW*)w[l], b[l], y[l], tile, sizes[l], sizes[l + 1],
        last ? output : hidden, l == 0 ? in_mask : no_mask(), out_mask, last ? t : nullptr,
        last ? dedx : nullptr, copies, coef, tc, stream, plan_rows, pdl,
        pdl ? early_flags(plan, L, 0, l) : 0);
    if (err != cudaSuccess) return err;
    *first = false;
  }
  return cudaSuccess;
}

template <typename TW, typename TD>
int train_chunk(const float* x, const float* t, int n_real, int tile, int accum, const int* sizes,
                int L, void* const* w, void* const* d, float* const* b, float* const* db,
                float* work, uint32_t* mask_bits, int hidden, int output, unsigned thr_vis,
                unsigned thr_hid, float scale_vis, float scale_hid, unsigned seed, float mom,
                float A, float Bc, bool tc, const int* plan, cudaStream_t stream) {
  const Workspace ws = plan_workspace(sizes, L, tile);
  const float coef = 2.0f / (float)(tile * accum);
  float* ys[kMaxLayers];
  bf16_t* ys_bf[kMaxLayers];  // the tensor-core chain's copies of the hidden layers' outputs
  for (int l = 0; l < L; ++l) {
    ys[l] = work + (l == L - 1 ? ws.out : ws.ys[l + 1]);
    ys_bf[l] = l < L - 1 ? (bf16_t*)(work + ws.ys_bf[l + 1]) : nullptr;
  }
  // The input's masks of every tile of the call, drawn once into mask_bits
  // by an ordinary launch before the chain: the chain's first launch follows
  // it in stream order and every later launch starts after that one, so any
  // launch of the chain may read the table, before its wait too.
  const int words = mask_words(sizes[0]);
  if (thr_vis && n_real > 0) {
    const cudaError_t err = launch_input_mask_bits(mask_bits, n_real * accum, tile, 0, sizes[0],
                                                   seed, thr_vis, stream);
    if (err != cudaSuccess) return (int)err;
  }
  bool first = true;  // the call's first launch: no programmatic dependent launch
  for (int i = 0; i < n_real; ++i) {
    for (int j = 0; j < accum; ++j) {
      const long long gi = (long long)i * accum + j;  // global tile index
      const float* xi = x + gi * tile * sizes[0];
      const float* ti = t + gi * tile * sizes[L];
      const unsigned key0 = seed + (unsigned)gi * kBunchStride;
      const MaskSpec in_mask =
          thr_vis ? table_mask(mask_bits + gi * tile * words, words, scale_vis) : no_mask();
      const int flags = (j == 0 ? kUpdFirst : 0) | (j == accum - 1 ? kUpdApply : 0);
      float* dedx = work + ws.dedx_a;
      float* other = work + ws.dedx_b;
      // the tensor-core chain's bfloat16 copies of them, written beside each (none in float32)
      bf16_t* dedx_bf = tc ? (bf16_t*)(work + ws.bf_a) : nullptr;
      bf16_t* other_bf = tc ? (bf16_t*)(work + ws.bf_b) : nullptr;
      const cudaError_t ferr = forward_tile<TW>(xi, ti, tile, sizes, L, w, b, ys,
                                                tc ? ys_bf : nullptr, dedx, dedx_bf, hidden,
                                                output, in_mask, key0, thr_hid, scale_hid, 0,
                                                coef, 0, tc, plan, &first, stream);
      if (ferr != cudaSuccess) return (int)ferr;
      for (int l = L - 1; l >= 0; --l) {
        const float* yprev = l == 0 ? xi : work + ws.ys[l];
        const unsigned sr_key =
            seed + (unsigned)i * kBunchStride + (unsigned)l * kLayerStride + 1u;
        const bool pdl = plan != nullptr;  // a forward came first
        Bf16Copies copies;
        copies.dedx = dedx_bf;
        copies.dedy = l > 0 ? other_bf : nullptr;
        const cudaError_t err = launch_bwd(
            dedx, copies, yprev, l == 0 ? in_mask : no_mask(), (TW*)w[l], (TD*)d[l], b[l], db[l],
            nullptr, l > 0 ? other : nullptr, hidden, tile,
            sizes[l], sizes[l + 1], mom, A, Bc, sr_key, flags, tc, stream, pdl,
            pdl ? early_flags(plan, L, 1, l) : 0);
        if (err != cudaSuccess) return (int)err;
        float* tmp = dedx;
        dedx = other;
        other = tmp;
        bf16_t* tmp_bf = dedx_bf;
        dedx_bf = other_bf;
        other_bf = tmp_bf;
      }
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Trains bunches 0..n_real-1 of x (bunches of tile * accum rows, width
// sizes[0]) and t (width sizes[L]) in place on w[l], d[l] (sizes[l],
// sizes[l+1]) and b[l], db[l].  Rows at or past n_real * tile * accum are
// never read.  Storage of w and d: float32, d bfloat16 (d_bf16), or both
// bfloat16 (w_bf16 and d_bf16), bfloat16 stores stochastically rounded; b and
// db float32.  accum > 1: each bunch in `accum` row tiles of `tile` rows,
// the gradient accumulated into d and the step applied with the last tile
// (float32 storage only).  bf16 != 0: products of operands rounded to
// bfloat16 on the tensor cores, else float32 products.  In either form every
// launch after the call's first is a programmatic dependent launch (pdl.cuh)
// that reads before its wait what plan (early_read_plan(L, accum), 4 * L
// ints) allows it.  A refused launch returns its error: there is no other
// chain.
// hidden/output: 0 linear, 1 relu, 2 sigmoid.
// thr_vis/thr_hid: mask thresholds of the input and of the hidden activations
// (0 = no dropout there), scale_*: factor on kept elements.  With thr_vis the
// call first draws the input's masks of its n_real * accum tiles into
// mask_bits (resident_mask_words(n_real * accum, tile, sizes[0]) words, which
// the caller allocates; nullptr is refused) by one launch of
// input_mask_bits_kernel, and the layer-0 kernels of each tile read its rows.
// Update: delta' = mom*delta - (A*G + Bc*w) with G the gradient of
// (1/bunch)*sum((out-t)^2).
extern "C" int resident_chunk_train(const float* x, const float* t, int n_real, int tile,
                                    int accum, const int* sizes, int L, void* const* w,
                                    int w_bf16, void* const* d, int d_bf16, float* const* b,
                                    float* const* db, float* work, void* mask_bits, int hidden,
                                    int output, unsigned thr_vis, unsigned thr_hid,
                                    float scale_vis, float scale_hid, unsigned seed, float mom,
                                    float A, float Bc, int bf16, const int* plan,
                                    void* stream_) {
  if (L < 1 || L > kMaxLayers || tile <= 0 || accum <= 0 || hidden < 0 || hidden > 2 ||
      output < 0 || output > 2 || (w_bf16 && !d_bf16) || (accum > 1 && d_bf16) ||
      plan == nullptr || (thr_vis && n_real > 0 && mask_bits == nullptr))
    return (int)cudaErrorInvalidValue;
  uint32_t* bits = (uint32_t*)mask_bits;
  cudaStream_t stream = (cudaStream_t)stream_;
  const bool tc = bf16 != 0;
  if (w_bf16)
    return train_chunk<bf16_t, bf16_t>(x, t, n_real, tile, accum, sizes, L, w, d, b, db, work,
                                       bits, hidden, output, thr_vis, thr_hid, scale_vis,
                                       scale_hid, seed, mom, A, Bc, tc, plan, stream);
  if (d_bf16)
    return train_chunk<float, bf16_t>(x, t, n_real, tile, accum, sizes, L, w, d, b, db, work,
                                      bits, hidden, output, thr_vis, thr_hid, scale_vis,
                                      scale_hid, seed, mom, A, Bc, tc, plan, stream);
  return train_chunk<float, float>(x, t, n_real, tile, accum, sizes, L, w, d, b, db, work, bits,
                                   hidden, output, thr_vis, thr_hid, scale_vis, scale_hid, seed,
                                   mom, A, Bc, tc, plan, stream);
}

// The data-parallel trainer's forward of one tile: this rank's `tile` rows
// x (tile, sizes[0]) and t (tile, sizes[L]) of the global tile whose rows
// row0.. they are (global_tile rows), float32 weights w[l] and biases b[l];
// y[l] (tile, sizes[l+1]) receive the masked activations and the output, dedx
// (tile, sizes[L]) = coef * (y[L-1] - t) [* y(1-y) for a sigmoid head], coef =
// 2 / (the global bunch).  Masks as resident_chunk_train draws them for the
// global tile index gi (key0 = seed + gi * 7919), at rows row0 + r, and K
// split over the grid as for the global tile: a row's activations are the
// single-device trainer's bit for bit.  The input's mask is read from
// mask_bits (tile rows of mask_words(sizes[0]) words: the tile's rows of the
// table input_mask_bits_u32 draws at row0, mode 3); with thr_vis a nullptr
// is refused.  Every launch is an ordinary one, and the tensor-core form
// rounds each layer's float32 input (no bfloat16 copies: the layer kernels'
// own sums, as fused_linear_act's).  The gradient-out backward
// and the update of each layer are fused_mlp.cu's; the sum between them is
// the caller's.
extern "C" int dp_chunk_forward(const float* x, const float* t, int tile, int global_tile,
                                const int* sizes, int L, void* const* w, float* const* b,
                                float* const* y, float* dedx, int hidden, int output,
                                unsigned thr_vis, unsigned thr_hid, float scale_vis,
                                float scale_hid, const void* mask_bits, unsigned key0, int row0,
                                float coef, int bf16, void* stream) {
  if (L < 1 || L > kMaxLayers || tile <= 0 || global_tile < tile || row0 < 0 || hidden < 0 ||
      hidden > 2 || output < 0 || output > 2 || (thr_vis && mask_bits == nullptr))
    return (int)cudaErrorInvalidValue;
  const MaskSpec in_mask =
      thr_vis ? table_mask((const uint32_t*)mask_bits, mask_words(sizes[0]), scale_vis)
              : no_mask();
  bool first = true;
  const cudaError_t err = forward_tile<float>(
      x, t, tile, sizes, L, w, b, y, nullptr, dedx, nullptr, hidden, output, in_mask, key0,
      thr_hid, scale_hid, row0, coef, global_tile, bf16 != 0, nullptr, &first,
      (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// out (rows, cols) = the 0/1 mask (times scale) of rows row0..row0+rows-1 of
// the global bunch under `key`: the device function the trainer's kernels call.
extern "C" int philox_mask_f32(float* out, int rows, int cols, int row0, unsigned key,
                               unsigned threshold, float scale, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n = (long long)rows * ((cols + 3) / 4);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  mask_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      out, rows, cols, philox_mask(key, threshold, scale, row0));
  return (int)cudaGetLastError();
}

// out (n_tiles, tile, ceil(K / 32) words) = the input-mask table
// resident_chunk_train draws for a call of n_tiles tiles under `seed` (the
// tile gi's under key seed + gi * 7919) and threshold, at the rows row0.. of
// each global tile (0: the single-device trainer's table; a data-parallel
// rank's first row: its rows of that table): one launch of
// input_mask_bits_kernel.
extern "C" int input_mask_bits_u32(void* out, int n_tiles, int tile, int row0, int K,
                                   unsigned seed, unsigned threshold, void* stream) {
  return (int)launch_input_mask_bits((uint32_t*)out, n_tiles, tile, row0, K, seed, threshold,
                                     (cudaStream_t)stream);
}

// out[4*i..] = philox4x32_10(counter = in[6*i..6*i+3], key = in[6*i+4..6*i+5]):
// the raw generator, for the known-answer vectors.
extern "C" int philox_words_u32(const uint32_t* in, uint32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  philox_words_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
