// Sum of the data-parallel ranks' gradients on the card they share, for
// Hopper (sm_90a).
//
// Replaces the sum of tpu_sednn/ops/resident_chunk.py:_allreduce (:223-260):
// the TPU kernel adds the chips' gradient blocks in its own body (a
// recursive-doubling butterfly over remote copies), so every chip holds the
// same bits.  Ranks with a card each sum with NCCL; ranks that share one card
// (one process each, which NCCL refuses) sum here: each rank exports a
// staging buffer of its own with CUDA IPC (rank_sum_export) and maps every
// other rank's (rank_sum_open), and rank_sum_f32 reads the n ranks' buffers
// and writes their sum, added in rank order, so every rank computes the same
// bits.  The host only orders the ranks (ops/rank_sum.py: a barrier between
// the staging copies and the sums).
//
// Bound: bytes, (n + 1) * 4 bytes an element (n buffers read, the sum
// written): 2048 x 2048 + 2048 floats of 2 ranks, 50 MB, 0.015 ms at
// 3.35 TB/s.  float4 loads where every pointer is 16-byte aligned.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxRanks = 16;

struct Sources {
  const float* p[kMaxRanks];
};

// N sources: every load of an element is issued before its additions, and
// the sources' pointers are read from the parameters at fixed indices.
template <int N>
__global__ void __launch_bounds__(256)
rank_sum_kernel(Sources src, float* __restrict__ out, long long n4, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    float4 v[N];
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = reinterpret_cast<const float4*>(src.p[r])[i];
    float4 acc = v[0];
#pragma unroll
    for (int r = 1; r < N; ++r) {
      acc.x += v[r].x;
      acc.y += v[r].y;
      acc.z += v[r].z;
      acc.w += v[r].w;
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float v[N];
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = src.p[r][i];
    float acc = v[0];
#pragma unroll
    for (int r = 1; r < N; ++r) acc += v[r];
    out[i] = acc;
  }
}

using Launch = void (*)(const Sources&, float*, long long, long long, int, cudaStream_t);

template <int N>
void launch(const Sources& src, float* out, long long n4, long long n, int blocks,
            cudaStream_t stream) {
  rank_sum_kernel<N><<<blocks, 256, 0, stream>>>(src, out, n4, n);
}

constexpr Launch kLaunch[kMaxRanks] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,  launch<7>,  launch<8>,
    launch<9>,  launch<10>, launch<11>, launch<12>, launch<13>, launch<14>, launch<15>, launch<16>};

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

}  // namespace

// out[i] = ((src[0][i] + src[1][i]) + src[2][i]) + ... for i < n, float32,
// n_src in [1, 16].  out may be one of the sources.  Launches on `stream`,
// does not synchronise; returns cudaGetLastError().
extern "C" int rank_sum_f32(const float* const* src, int n_src, float* out, long long n,
                            void* stream) {
  if (n_src < 1 || n_src > kMaxRanks || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Sources s{};
  bool vec = aligned16(out);
  for (int r = 0; r < n_src; ++r) {
    s.p[r] = src[r];
    vec = vec && aligned16(src[r]);
  }
  const long long n4 = vec ? n / 4 : 0;
  const long long work = n4 + (n - 4 * n4);
  const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256 : 132 * 16);
  kLaunch[n_src - 1](s, out, n4, n, blocks, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Bytes of a CUDA IPC memory handle.
extern "C" int rank_sum_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// A staging buffer of `bytes` on the current card, and its IPC handle for
// the other ranks' processes (rank_sum_handle_bytes() bytes into `handle`).
extern "C" int rank_sum_export(long long bytes, void** ptr, unsigned char* handle) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return (int)err;
  }
  std::memcpy(handle, &h, sizeof h);
  return 0;
}

// Maps another process's staging buffer (its handle) into this one.
extern "C" int rank_sum_open(const unsigned char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Unmaps a buffer rank_sum_open mapped.
extern "C" int rank_sum_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// Frees a buffer rank_sum_export allocated (once no other rank maps it).
extern "C" int rank_sum_free(void* ptr) { return (int)cudaFree(ptr); }
