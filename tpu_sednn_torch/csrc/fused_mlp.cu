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

}  // namespace

// y (M, N) = act(mask_in(x) (M, K) @ w (K, N) + b) * mask_out.  act: 0 linear,
// 1 relu, 2 sigmoid.  Mask modes: 0 none, 1 a 0/1 float tensor (in: (M, K),
// out: (M, N)), 2 Philox from (key, threshold), 3 (in only) a packed table of
// keep bits at in_ptr, (M, ceil(K / 32)) 32-bit words (philox.cuh); kept
// elements times scale.
// w_bf16 != 0: w is bfloat16 storage, widened as it is loaded; x, b and y are
// float32.  bf16 != 0: the tensor-core form, products of operands rounded to
// bfloat16 (to nearest even) summed in float32; else float32 products.
// Either is one launch.  launched[2] += the launches of tc_fwd_kernel and
// f32_fwd_kernel.
extern "C" int fused_linear_act_f32(const float* x, const void* w, int w_bf16, const float* b,
                                    float* y, int M, int K, int N, int act, int in_mode,
                                    const float* in_ptr, unsigned in_key, unsigned in_thr,
                                    float in_scale, int out_mode, const float* out_ptr,
                                    unsigned out_key, unsigned out_thr, float out_scale,
                                    int bf16, int* launched, void* stream) {
  if (act < 0 || act > 2 || in_mode < 0 || in_mode > 3 || out_mode < 0 || out_mode > 2)
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale);
  const MaskSpec om = make_mask(out_mode, out_ptr, N, out_key, out_thr, out_scale);
  FwdLaunched done;
  const cudaError_t err =
      w_bf16 ? launch_fwd(x, (const bf16_t*)w, b, y, M, K, N, act, im, om, nullptr, nullptr, 0.0f,
                          bf16 != 0, &done, (cudaStream_t)stream)
             : launch_fwd(x, (const float*)w, b, y, M, K, N, act, im, om, nullptr, nullptr, 0.0f,
                          bf16 != 0, &done, (cudaStream_t)stream);
  launched[0] += done.tc;
  launched[1] += done.f32;
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
// (float32 W); out[2..4] stripe_bwd_kernel's tensor-core form with stripes of
// 64, 32, 16 rows (float32 W and Delta); out[5..7] its float32 form alike;
// out[8] f32_fwd_kernel (float32 W).  Whether two such blocks can share an SM
// follows from these.
extern "C" void fused_tc_smem_bytes(int* out) {
  out[0] = (int)sizeof(TcFwdTile<float, 128>::Smem) + 128;
  out[1] = (int)sizeof(TcFwdTile<float, 64>::Smem) + 128;
  out[2] = (int)sizeof(BwdTile<true, float, float, 64>::Smem) + 128;
  out[3] = (int)sizeof(BwdTile<true, float, float, 32>::Smem) + 128;
  out[4] = (int)sizeof(BwdTile<true, float, float, 16>::Smem) + 128;
  out[5] = (int)sizeof(BwdTile<false, float, float, 64>::Smem) + 128;
  out[6] = (int)sizeof(BwdTile<false, float, float, 32>::Smem) + 128;
  out[7] = (int)sizeof(BwdTile<false, float, float, 16>::Smem) + 128;
  out[8] = (int)F32FwdTile<float>::kSmemBytes;
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
// one launch of stripe_bwd_kernel, at most kBwdMaxRows (512) rows.
// launched[2] += the launches of its tensor-core and its float32 form.
extern "C" int fused_bwd_update_f32(const float* dedx, const float* yprev, void* w, int w_bf16,
                                    void* delta, int d_bf16, unsigned sr_key, float* b,
                                    float* db, float* dedy, int M, int K, int N,
                                    float mom, float A, float Bc, int in_mode,
                                    const float* in_ptr, unsigned in_key, unsigned in_thr,
                                    float in_scale, int deriv, int bf16, int* launched,
                                    void* stream) {
  if (in_mode < 0 || in_mode > 3 || deriv < 0 || deriv > 2 || (w_bf16 && !d_bf16))
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale);
  const int flags = kUpdFirst | kUpdApply;
  const bool tc = bf16 != 0;
  cudaStream_t s = (cudaStream_t)stream;
  BwdLaunched done;
  cudaError_t err;
  if (w_bf16)
    err = launch_bwd(dedx, yprev, im, (bf16_t*)w, (bf16_t*)delta, b, db, nullptr, dedy,
                     deriv, M, K, N, mom, A, Bc, sr_key, flags, tc, &done, s);
  else if (d_bf16)
    err = launch_bwd(dedx, yprev, im, (float*)w, (bf16_t*)delta, b, db, nullptr, dedy,
                     deriv, M, K, N, mom, A, Bc, sr_key, flags, tc, &done, s);
  else
    err = launch_bwd(dedx, yprev, im, (float*)w, (float*)delta, b, db, nullptr, dedy,
                     deriv, M, K, N, mom, A, Bc, sr_key, flags, tc, &done, s);
  launched[0] += done.tc;
  launched[1] += done.f32;
  return (int)err;
}

// The gradient-out form of fused_bwd_update_f32 (the data-parallel
// trainer's): g (K*N + N floats) = G = yprev^T @ dedx row-major, then gb =
// sum_rows(dedx); dedy as above from w, which is only read (float32; not at
// all without dedy).  The input mask draws rows in_row0.. of its stream (this
// rank's rows of the global bunch).  Nothing is updated.  launched as above.
extern "C" int fused_bwd_grad_out_f32(const float* dedx, const float* yprev, const float* w,
                                      float* g, float* dedy, int M, int K, int N,
                                      int in_mode, const float* in_ptr, unsigned in_key,
                                      unsigned in_thr, float in_scale, int in_row0, int deriv,
                                      int bf16, int* launched, void* stream) {
  if (in_mode < 0 || in_mode > 3 || deriv < 0 || deriv > 2 || g == nullptr)
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale, in_row0);
  BwdLaunched done;
  const cudaError_t err =
      launch_bwd(dedx, yprev, im, (float*)w, (float*)nullptr, nullptr, nullptr, g, dedy,
                 deriv, M, K, N, 0.0f, 0.0f, 0.0f, 0u, 0, bf16 != 0, &done, (cudaStream_t)stream);
  launched[0] += done.tc;
  launched[1] += done.f32;
  return (int)err;
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
