// C interface of the fused MLP layer kernels (kernels 1 and 2) for Hopper
// (sm_90a); the device code, its bound and its design are in fused_mlp.cuh.
//
// Replaces tpu_sednn/ops/fused_mlp.py:fused_linear_act (_fwd_kernel) and
// :fused_bwd_update (_bwd_kernel); the gradient-out backward and the update
// kernel are the two halves kernel 2 is split into where the data-parallel
// chunk trainer sums the gradient between them (the all-reduce of
// tpu_sednn/ops/resident_chunk.py:_allreduce).  Every function launches on `stream`,
// does not synchronise, allocates nothing and returns cudaGetLastError()
// (0 on success).

#include "fused_mlp.cuh"

using namespace sednn;

namespace {

// ld: the operand's width (its columns); a mode-3 table has mask_words(ld)
// words a row.
MaskSpec make_mask(int mode, const float* ptr, int ld, unsigned key, unsigned threshold,
                   float scale, int row0 = 0) {
  if (mode == 3) return table_mask((const uint32_t*)ptr, mask_words(ld), scale);
  MaskSpec s = no_mask();
  s.mode = mode;
  s.ptr = ptr;
  s.ld = ld;
  s.key = key;
  s.threshold = threshold;
  s.scale = scale;
  s.row0 = row0;
  return s;
}

// The tensor-core backward's operand for a caller that holds float32 dedx
// alone: with tc, rne(dedx) into dedx_bf by one launch of bf16_copy_kernel,
// which copies->dedx then names; without, nothing.
cudaError_t cast_dedx(const float* dedx, void* dedx_bf, int M, int N, bool tc, Bf16Copies* copies,
                      cudaStream_t stream) {
  if (!tc || M <= 0 || N <= 0) return cudaSuccess;
  if (dedx_bf == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = launch_bf16_copy(dedx, (bf16_t*)dedx_bf, M, N, stream);
  if (err != cudaSuccess) return err;
  copies->dedx = (const bf16_t*)dedx_bf;
  return cudaSuccess;
}

}  // namespace

// y (M, N) = act(mask_in(x) (M, K) @ w (K, N) + b) * mask_out.  act: 0 linear,
// 1 relu, 2 sigmoid.  Mask modes: 0 none, 1 a 0/1 float tensor (in: (M, K),
// out: (M, N)), 2 Philox from (key, threshold), 3 (in only) a packed table of
// keep bits at in_ptr, (M, ceil(K / 32)) 32-bit words (philox.cuh); kept
// elements times scale.
// w_bf16 != 0: w is bfloat16 storage, widened as it is loaded; x, b and y are
// float32.  bf16 != 0: the tensor-core form, products of operands rounded to
// bfloat16 (to nearest even) summed in float32; else float32 products.
// Either is one launch.
extern "C" int fused_linear_act_f32(const float* x, const void* w, int w_bf16, const float* b,
                                    float* y, int M, int K, int N, int act, int in_mode,
                                    const float* in_ptr, unsigned in_key, unsigned in_thr,
                                    float in_scale, int out_mode, const float* out_ptr,
                                    unsigned out_key, unsigned out_thr, float out_scale,
                                    int bf16, void* stream) {
  if (act < 0 || act > 2 || in_mode < 0 || in_mode > 3 || out_mode < 0 || out_mode > 2)
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale);
  const MaskSpec om = make_mask(out_mode, out_ptr, N, out_key, out_thr, out_scale);
  const cudaError_t err =
      w_bf16 ? launch_fwd(x, (const bf16_t*)w, b, y, M, K, N, act, im, om, nullptr, nullptr,
                          FwdCopies{}, 0.0f, bf16 != 0, (cudaStream_t)stream)
             : launch_fwd(x, (const float*)w, b, y, M, K, N, act, im, om, nullptr, nullptr,
                          FwdCopies{}, 0.0f, bf16 != 0, (cudaStream_t)stream);
  return (int)err;
}

// The tensor-core forward with its bfloat16 copies (FwdCopies; each
// bf16_ld(width) a row, 16-byte aligned, or nullptr): y (M, N) = act(x (M, K)
// @ w (K, N) + b), x read from its copy x_bf (rne(x)) where it is given, else
// rounded from float32 x; rne(y) into y_bf; with targ, dedx = coef * (y -
// targ) [* y (1 - y) for a sigmoid head] and rne(dedx) into dedx_bf.  No
// masks.  What the chunk trainer launches for a hidden layer or its head,
// standing alone, so that the form that reads x's copy can be held against
// the one that rounds x.
extern "C" int fused_tc_fwd_copies(const float* x, const void* x_bf, const void* w, int w_bf16,
                                   const float* b, float* y, void* y_bf, int M, int K, int N,
                                   int act, const float* targ, float* dedx, void* dedx_bf,
                                   float coef, void* stream) {
  if (act < 0 || act > 2 || (targ == nullptr) != (dedx == nullptr))
    return (int)cudaErrorInvalidValue;
  const FwdCopies copies{(const bf16_t*)x_bf, (bf16_t*)y_bf, (bf16_t*)dedx_bf};
  const cudaError_t err =
      w_bf16 ? launch_fwd(x, (const bf16_t*)w, b, y, M, K, N, act, no_mask(), no_mask(), targ,
                          dedx, copies, coef, true, (cudaStream_t)stream)
             : launch_fwd(x, (const float*)w, b, y, M, K, N, act, no_mask(), no_mask(), targ,
                          dedx, copies, coef, true, (cudaStream_t)stream);
  return (int)err;
}

// The float32 forward's plan for (M, K, N) with float32 W, K split as for
// plan_rows rows (0: M): out[0] the chunk length, out[1] the chunks (the
// blocks of a cluster), out[2] the grid's blocks, out[3] the blocks the card
// holds at once, out[4] the clusters.  On the current device; 0 or a CUDA error.
extern "C" int fused_f32_fwd_plan(int M, int K, int N, int plan_rows, int* out) {
  return (int)f32_fwd_plan<float>(M, K, N, plan_rows, out);
}

// The backward's plan for (M, K, N), float32 state, with or without dedy, in
// the product form bf16 names: out[0] the split of N over a stripe's blocks
// (a cluster where dedy is summed), out[1] the stripes, out[2] a stripe's
// rows.  On the current device; 0 or a CUDA error (cudaErrorInvalidValue
// above the rows the kernel takes).
extern "C" int fused_bwd_plan(int M, int K, int N, int with_dedy, int bf16, int* out) {
  return (int)(bf16 ? bwd_plan<true, float, float>(M, K, N, with_dedy != 0, out)
                    : bwd_plan<false, float, float>(M, K, N, with_dedy != 0, out));
}

// The dynamic shared memory a block of each stripe-and-cluster kernel asks
// for, in bytes: out[0], out[1] tc_fwd_kernel with 128- and 64-column slices
// (float32 W, float32 x); out[2..4] stripe_bwd_kernel's tensor-core form with
// stripes of 64, 32, 16 rows (float32 W and Delta); out[5..7] its float32
// form alike; out[8] f32_fwd_kernel (float32 W); out[9], out[10] what the
// layout of tc_fwd_kernel reading x's bfloat16 copy takes, 128- and
// 64-column slices (it asks for out[0], out[1]: tc_fwd_smem_bytes).  Whether
// two such blocks can share an SM follows from these.
extern "C" void fused_tc_smem_bytes(int* out) {
  out[0] = tc_fwd_smem_bytes<float, 128>();
  out[1] = tc_fwd_smem_bytes<float, 64>();
  out[2] = (int)BwdTile<true, float, float, 64>::kSmemBytes;
  out[3] = (int)BwdTile<true, float, float, 32>::kSmemBytes;
  out[4] = (int)BwdTile<true, float, float, 16>::kSmemBytes;
  out[5] = (int)BwdTile<false, float, float, 64>::kSmemBytes;
  out[6] = (int)BwdTile<false, float, float, 32>::kSmemBytes;
  out[7] = (int)BwdTile<false, float, float, 16>::kSmemBytes;
  out[8] = (int)F32FwdTile<float>::kSmemBytes;
  out[9] = TcFwdTile<float, 128, bf16_t>::kSmemBytes;
  out[10] = TcFwdTile<float, 64, bf16_t>::kSmemBytes;
}

// In place: delta' = mom*delta - (A*G + Bc*w), w' = w + delta', G = yprev^T @ dedx;
// db' = mom*db - A*sum_rows(dedx), b' = b + db'.  dedy (M, K) = dedx @ w^T with
// w BEFORE the update, times the derivative `deriv` (0 none, 1 relu, 2 sigmoid)
// evaluated on yprev; pass dedy == nullptr to skip it.
// Storage of w and delta: float32 both (w_bf16 == d_bf16 == 0), delta
// bfloat16 (d_bf16), or both bfloat16; bfloat16 stores are stochastically
// rounded with the stream sr_key (sr_round.cuh).  b and db are float32.
// bf16 != 0: the tensor-core form (G and dedy from operands rounded to
// bfloat16, the update on the unrounded w), else float32 products; either is
// one launch of stripe_bwd_kernel, at most kBwdMaxRows (512) rows.  The
// tensor-core form reads dedx's bfloat16 copy: it is written first into
// dedx_bf (M rows of bf16_ld(N) bfloat16, 16-byte aligned, the caller's) by
// one launch of bf16_copy_kernel.
extern "C" int fused_bwd_update_f32(const float* dedx, void* dedx_bf, const float* yprev, void* w,
                                    int w_bf16, void* delta, int d_bf16, unsigned sr_key,
                                    float* b, float* db, float* dedy, int M, int K, int N,
                                    float mom, float A, float Bc, int in_mode,
                                    const float* in_ptr, unsigned in_key, unsigned in_thr,
                                    float in_scale, int deriv, int bf16, void* stream) {
  if (in_mode < 0 || in_mode > 3 || deriv < 0 || deriv > 2 || (w_bf16 && !d_bf16))
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale);
  const int flags = kUpdFirst | kUpdApply;
  const bool tc = bf16 != 0;
  cudaStream_t s = (cudaStream_t)stream;
  Bf16Copies copies;
  cudaError_t err = cast_dedx(dedx, dedx_bf, M, N, tc, &copies, s);
  if (err != cudaSuccess) return (int)err;
  if (w_bf16)
    err = launch_bwd(dedx, copies, yprev, im, (bf16_t*)w, (bf16_t*)delta, b, db, nullptr, dedy,
                     deriv, M, K, N, mom, A, Bc, sr_key, flags, tc, s);
  else if (d_bf16)
    err = launch_bwd(dedx, copies, yprev, im, (float*)w, (bf16_t*)delta, b, db, nullptr, dedy,
                     deriv, M, K, N, mom, A, Bc, sr_key, flags, tc, s);
  else
    err = launch_bwd(dedx, copies, yprev, im, (float*)w, (float*)delta, b, db, nullptr, dedy,
                     deriv, M, K, N, mom, A, Bc, sr_key, flags, tc, s);
  return (int)err;
}

// The gradient-out form of fused_bwd_update_f32 (the data-parallel
// trainer's): g (K*N + N floats) = G = yprev^T @ dedx row-major, then gb =
// sum_rows(dedx); dedy as above from w, which is only read (float32; not at
// all without dedy).  The input mask draws rows in_row0.. of its stream (this
// rank's rows of the global bunch).  Nothing is updated.  dedx_bf as above.
extern "C" int fused_bwd_grad_out_f32(const float* dedx, void* dedx_bf, const float* yprev,
                                      const float* w, float* g, float* dedy, int M, int K, int N,
                                      int in_mode, const float* in_ptr, unsigned in_key,
                                      unsigned in_thr, float in_scale, int in_row0, int deriv,
                                      int bf16, void* stream) {
  if (in_mode < 0 || in_mode > 3 || deriv < 0 || deriv > 2 || g == nullptr)
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale, in_row0);
  cudaStream_t s = (cudaStream_t)stream;
  Bf16Copies copies;
  const cudaError_t err = cast_dedx(dedx, dedx_bf, M, N, bf16 != 0, &copies, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd(dedx, copies, yprev, im, (float*)w, (float*)nullptr, nullptr, nullptr, g,
                         dedy, deriv, M, K, N, 0.0f, 0.0f, 0.0f, 0u, 0, bf16 != 0, s);
}

// The update from a given gradient g (K*N floats of G, then N of gb):
// delta' = mom*delta - (A*G + Bc*w) with kUpdFirst (1) in flags, else delta -
// A*G; w' = w + delta' with kUpdApply (2); db and b alike.  w float32; delta
// float32 or bfloat16 (d_bf16: stored with stochastic rounding from stream
// sr_key, w takes the unrounded step); b and db float32.  In place.
extern "C" int dp_update_f32(float* w, void* delta, int d_bf16, float* b, float* db,
                             const float* g, int K, int N, float mom, float A, float Bc,
                             unsigned sr_key, int flags, void* stream) {
  if (flags < 0 || flags > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d_bf16)
    return (int)launch_update(w, (bf16_t*)delta, b, db, g, K, N, mom, A, Bc, sr_key, flags, s);
  return (int)launch_update(w, (float*)delta, b, db, g, K, N, mom, A, Bc, sr_key, flags, s);
}
