// C interface of the fused MLP layer kernels (kernels 1 and 2) for Hopper
// (sm_90a); the device code, its bound and its design are in fused_mlp.cuh.
//
// Replaces tpu_sednn/ops/fused_mlp.py:fused_linear_act (_fwd_kernel) and
// :fused_bwd_update (_bwd_kernel).  Every function launches on `stream`,
// does not synchronise, allocates nothing and returns cudaGetLastError()
// (0 on success).

#include "fused_mlp.cuh"

using namespace sednn;

namespace {

MaskSpec make_mask(int mode, const float* ptr, int ld, unsigned key, unsigned threshold,
                   float scale) {
  MaskSpec s = no_mask();
  s.mode = mode;
  s.ptr = ptr;
  s.ld = ld;
  s.key = key;
  s.threshold = threshold;
  s.scale = scale;
  return s;
}

}  // namespace

// y (M, N) = act(mask_in(x) (M, K) @ w (K, N) + b) * mask_out.  act: 0 linear,
// 1 relu, 2 sigmoid.  Mask modes: 0 none, 1 a 0/1 float tensor (in: (M, K),
// out: (M, N)), 2 Philox from (key, threshold); kept elements times scale.
// part: scratch of fused_fwd_scratch_floats(M, K, N, bf16) floats.  w_bf16 !=
// 0: w is bfloat16 storage, widened as it is loaded; x, b and y are float32.
// bf16 != 0: the tensor-core form, products of operands rounded to bfloat16
// (to nearest even) summed in float32; else float32 products.
extern "C" int fused_linear_act_f32(const float* x, const void* w, int w_bf16, const float* b,
                                    float* y, int M, int K, int N, int act, int in_mode,
                                    const float* in_ptr, unsigned in_key, unsigned in_thr,
                                    float in_scale, int out_mode, const float* out_ptr,
                                    unsigned out_key, unsigned out_thr, float out_scale,
                                    float* part, int bf16, void* stream) {
  if (act < 0 || act > 2 || in_mode < 0 || in_mode > 2 || out_mode < 0 || out_mode > 2)
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale);
  const MaskSpec om = make_mask(out_mode, out_ptr, N, out_key, out_thr, out_scale);
  if (w_bf16)
    return (int)launch_fwd(x, (const bf16_t*)w, b, y, M, K, N, act, im, om, nullptr, nullptr,
                           0.0f, part, bf16 != 0, (cudaStream_t)stream);
  return (int)launch_fwd(x, (const float*)w, b, y, M, K, N, act, im, om, nullptr, nullptr, 0.0f,
                         part, bf16 != 0, (cudaStream_t)stream);
}

// Scratch floats fused_linear_act_f32 needs in `part` (0: pass nullptr).
extern "C" long long fused_fwd_scratch_floats(int M, int K, int N, int bf16) {
  return fwd_scratch_floats(M, K, N, bf16 != 0);
}

// Scratch floats fused_bwd_update_f32 needs in `part` for its dedy output.
extern "C" long long fused_bwd_scratch_floats(int M, int K, int N) {
  return (long long)bwd_n_tiles(N) * M * K;
}

// In place: delta' = mom*delta - (A*G + Bc*w), w' = w + delta', G = yprev^T @ dedx;
// db' = mom*db - A*sum_rows(dedx), b' = b + db'.  dedy (M, K) = dedx @ w^T with
// w BEFORE the update, times the derivative `deriv` (0 none, 1 relu, 2 sigmoid)
// evaluated on yprev; pass part == dedy == nullptr to skip it.  Storage of w
// and delta: float32 both (w_bf16 == d_bf16 == 0), delta bfloat16 (d_bf16),
// or both bfloat16; bfloat16 stores are stochastically rounded with the
// stream sr_key (sr_round.cuh).  b and db are float32.  bf16 != 0: the
// tensor-core form (G and dedy from operands rounded to bfloat16, the update
// on the unrounded w), else float32 products.
extern "C" int fused_bwd_update_f32(const float* dedx, const float* yprev, void* w, int w_bf16,
                                    void* delta, int d_bf16, unsigned sr_key, float* b,
                                    float* db, float* part, float* dedy, int M, int K, int N,
                                    float mom, float A, float Bc, int in_mode,
                                    const float* in_ptr, unsigned in_key, unsigned in_thr,
                                    float in_scale, int deriv, int bf16, void* stream) {
  if (in_mode < 0 || in_mode > 2 || deriv < 0 || deriv > 2 ||
      (part == nullptr) != (dedy == nullptr) || (w_bf16 && !d_bf16))
    return (int)cudaErrorInvalidValue;
  const MaskSpec im = make_mask(in_mode, in_ptr, K, in_key, in_thr, in_scale);
  const int flags = kUpdFirst | kUpdApply;
  const bool tc = bf16 != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_bf16)
    return (int)launch_bwd(dedx, yprev, im, (bf16_t*)w, (bf16_t*)delta, b, db, part, dedy, deriv,
                           M, K, N, mom, A, Bc, sr_key, flags, tc, s);
  if (d_bf16)
    return (int)launch_bwd(dedx, yprev, im, (float*)w, (bf16_t*)delta, b, db, part, dedy, deriv,
                           M, K, N, mom, A, Bc, sr_key, flags, tc, s);
  return (int)launch_bwd(dedx, yprev, im, (float*)w, (float*)delta, b, db, part, dedy, deriv, M,
                         K, N, mom, A, Bc, sr_key, flags, tc, s);
}
