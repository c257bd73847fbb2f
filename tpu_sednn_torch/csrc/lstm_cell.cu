// The CRN's LSTM recurrence for Hopper (sm_90a): a layer's steps enqueued by
// one C call (model/crn.py:lstm_layer), each step the cuBLAS product of
// h[t-1] with W_hh added onto the step's input projection, then one launch
// of the cell kernel.
//
// Replaces no TPU kernel: the JAX package runs no recurrence.  The cell
// kernel was added so that a step is the product and one launch where plain
// torch takes about seven, and the loop is in C because a step's device
// work (about 23 us at B = 64, H = 1024) is less than what a Python loop of
// the same two launches costs the host (35-50 us a step on an H100's host,
// varying from machine to machine: a layer's 799 steps took 35-48 ms against
// 29 ms from C, and the decode's rate spread by 5% between runs):
//
//   i, f, o = sigmoid(G_i, G_f, G_o),  g = tanh(G_g)
//   c' = f c + i g,  h = o tanh(c')
//
// G (B, 4H) float32, its row holding the four gates' H columns in the order
// i, f, g, o; c (B, H) is updated in place; h (B, H) is written.  A thread
// of the cell kernel takes four neighbouring units of one row: a 16-byte
// load of each gate and of c, a 16-byte store of c and of h (scalar accesses
// where H % 4 != 0 or a pointer is not 16-byte aligned).
//
// The arithmetic is the plain version's (ops/lstm_cell.py), one rounding an
// operation: sigmoid as 1 / (1 + expf(-x)) and tanhf, as PyTorch's CUDA
// kernels compute them, and the products and the sum with round-to-nearest
// intrinsics, so that the compiler contracts nothing into a fused
// multiply-add.  The step's product is cublasSgemm on a handle of this
// library's own, in CUBLAS_DEFAULT_MATH (float32, no TF32).
//
// Bound of the cell: bytes.  A step at B = 64, H = 1024 reads 1,048,576 +
// 262,144 bytes and writes 2 x 262,144: 1.84 MB, 0.55 us at 3.35 TB/s,
// against 20 operations an element; a launch's own cost is of the same order.
//
// lstm_steps_f32 launches on `stream` and does not synchronise; it allocates
// nothing but the cuBLAS handle (on a device's first call); it returns
// cudaGetLastError() (0 on success), or 1000 plus a cuBLAS status.

#include <cublas_v2.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cell(float gi, float gf, float gg, float go, float& c, float& h) {
  const float i = sigmoid_f(gi), f = sigmoid_f(gf), g = tanhf(gg), o = sigmoid_f(go);
  c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  h = __fmul_rn(o, tanhf(c));
}

__global__ void __launch_bounds__(256)
lstm_cell_kernel(const float* __restrict__ gates, float* __restrict__ c, float* __restrict__ h,
                 int B, int H, bool vec) {
  const int q = (H + 3) / 4;
  const long long n = (long long)B * q;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = (int)(i / q), col = (int)(i % q) * 4;
  const float* g = gates + (long long)row * 4 * H + col;
  float* cr = c + (long long)row * H + col;
  float* hr = h + (long long)row * H + col;
  if (vec) {
    const float4 vi = *reinterpret_cast<const float4*>(g);
    const float4 vf = *reinterpret_cast<const float4*>(g + H);
    const float4 vg = *reinterpret_cast<const float4*>(g + 2 * H);
    const float4 vo = *reinterpret_cast<const float4*>(g + 3 * H);
    float4 vc = *reinterpret_cast<const float4*>(cr), vh;
    cell(vi.x, vf.x, vg.x, vo.x, vc.x, vh.x);
    cell(vi.y, vf.y, vg.y, vo.y, vc.y, vh.y);
    cell(vi.z, vf.z, vg.z, vo.z, vc.z, vh.z);
    cell(vi.w, vf.w, vg.w, vo.w, vc.w, vh.w);
    *reinterpret_cast<float4*>(cr) = vc;
    *reinterpret_cast<float4*>(hr) = vh;
  } else {
    for (int j = 0; j < 4 && col + j < H; ++j) {
      float cj = cr[j], hj;
      cell(g[j], g[H + j], g[2 * H + j], g[3 * H + j], cj, hj);
      cr[j] = cj;
      hr[j] = hj;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int launch_cell(const float* gates, float* c, float* h, int B, int H, cudaStream_t stream) {
  const bool vec = H % 4 == 0 && aligned16(gates) && aligned16(c) && aligned16(h);
  const long long n = (long long)B * ((H + 3) / 4);
  lstm_cell_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(gates, c, h, B, H, vec);
  return (int)cudaGetLastError();
}

constexpr int kMaxDevices = 64;

// this library's cuBLAS handle of the current device, made on first use
int blas_handle(cublasHandle_t* out) {
  static cublasHandle_t handles[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (handles[dev] == nullptr) {
    const cublasStatus_t st = cublasCreate(&handles[dev]);
    if (st != CUBLAS_STATUS_SUCCESS) return 1000 + (int)st;
  }
  *out = handles[dev];
  return 0;
}

}  // namespace

// A layer's T steps: for t = 0 .. T-1, proj[t] (B, 4H) += hs[t] (B, H) W_hh
// (H, 4H), then the cell update of c (B, H) by proj[t] into hs[t + 1].  proj
// (T, B, 4H), hs (T + 1, B, H) with hs[0] the initial h, all float32,
// row-major and contiguous.
extern "C" int lstm_steps_f32(float* proj, const float* w_hh, float* hs, float* c, int T, int B,
                              int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  cublasHandle_t blas = nullptr;
  int rc = blas_handle(&blas);
  if (rc != 0) return rc;
  cublasStatus_t st = cublasSetStream(blas, (cudaStream_t)stream);
  if (st == CUBLAS_STATUS_SUCCESS) st = cublasSetMathMode(blas, CUBLAS_DEFAULT_MATH);
  if (st != CUBLAS_STATUS_SUCCESS) return 1000 + (int)st;
  const float one = 1.0f;
  const long long g_step = (long long)B * 4 * H, h_step = (long long)B * H;
  for (int t = 0; t < T; ++t) {
    float* g = proj + t * g_step;
    const float* h_prev = hs + t * h_step;
    // row-major (B, 4H) += (B, H) (H, 4H) is column-major (4H, B) += (4H, H) (H, B)
    st = cublasSgemm(blas, CUBLAS_OP_N, CUBLAS_OP_N, 4 * H, B, H, &one, w_hh, 4 * H, h_prev, H,
                     &one, g, 4 * H);
    if (st != CUBLAS_STATUS_SUCCESS) return 1000 + (int)st;
    rc = launch_cell(g, c, hs + (t + 1) * h_step, B, H, (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return 0;
}
