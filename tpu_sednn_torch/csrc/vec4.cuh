// 4-wide loads and stores of a row-major (nrows, ncols) operand, masked at
// the ragged edges, for float32 storage and for bfloat16 storage.  bfloat16
// is storage only: uint16_t bit patterns, widened to float32 in registers
// (exact: the pattern is the float32's top half).  `vec` says whether a
// thread's four elements may go as one vector access (vec_ok); else, and at
// the right edge, they go one by one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sednn {

typedef uint16_t bf16_t;

__device__ inline float widen(bf16_t h) { return __uint_as_float((uint32_t)h << 16); }
__device__ inline float widen(float f) { return f; }

__device__ inline float4 ld4(const float* __restrict__ p, int row, int col, int ld, int nrows,
                             int ncols, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < nrows && col < ncols) {
    const float* q = p + (long long)row * ld + col;
    if (vec && col + 3 < ncols) {
      v = *reinterpret_cast<const float4*>(q);
    } else {
      v.x = q[0];
      if (col + 1 < ncols) v.y = q[1];
      if (col + 2 < ncols) v.z = q[2];
      if (col + 3 < ncols) v.w = q[3];
    }
  }
  return v;
}

__device__ inline void st4(float* __restrict__ p, int row, int col, int ld, int nrows, int ncols,
                           bool vec, float4 v) {
  if (row < nrows && col < ncols) {
    float* q = p + (long long)row * ld + col;
    if (vec && col + 3 < ncols) {
      *reinterpret_cast<float4*>(q) = v;
    } else {
      q[0] = v.x;
      if (col + 1 < ncols) q[1] = v.y;
      if (col + 2 < ncols) q[2] = v.z;
      if (col + 3 < ncols) q[3] = v.w;
    }
  }
}

inline bool vec_ok(const float* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && ld % 4 == 0;
}

__device__ inline float4 ld4(const bf16_t* __restrict__ p, int row, int col, int ld, int nrows,
                             int ncols, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < nrows && col < ncols) {
    const bf16_t* q = p + (long long)row * ld + col;
    if (vec && col + 3 < ncols) {
      const uint2 r = *reinterpret_cast<const uint2*>(q);
      v.x = __uint_as_float(r.x << 16);
      v.y = __uint_as_float(r.x & 0xFFFF0000u);
      v.z = __uint_as_float(r.y << 16);
      v.w = __uint_as_float(r.y & 0xFFFF0000u);
    } else {
      v.x = widen(q[0]);
      if (col + 1 < ncols) v.y = widen(q[1]);
      if (col + 2 < ncols) v.z = widen(q[2]);
      if (col + 3 < ncols) v.w = widen(q[3]);
    }
  }
  return v;
}

__device__ inline void st4(bf16_t* __restrict__ p, int row, int col, int ld, int nrows, int ncols,
                           bool vec, const bf16_t h[4]) {
  if (row < nrows && col < ncols) {
    bf16_t* q = p + (long long)row * ld + col;
    if (vec && col + 3 < ncols) {
      uint2 r;
      r.x = (uint32_t)h[0] | ((uint32_t)h[1] << 16);
      r.y = (uint32_t)h[2] | ((uint32_t)h[3] << 16);
      *reinterpret_cast<uint2*>(q) = r;
    } else {
      q[0] = h[0];
      if (col + 1 < ncols) q[1] = h[1];
      if (col + 2 < ncols) q[2] = h[2];
      if (col + 3 < ncols) q[3] = h[3];
    }
  }
}

// Four bfloat16 values are 8 bytes: a vector access needs the base 8-byte
// aligned and a row stride that is a multiple of 4 elements.  An odd stride
// (N = 257, 129) leaves a row's start 2-byte aligned only: scalar accesses.
inline bool vec_ok(const bf16_t* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0 && ld % 4 == 0;
}

}  // namespace sednn
