// Tensor-core building blocks for the bfloat16-product forms of the fused
// layer kernels (fused_mlp.cuh): round-to-nearest-even narrowing, staging of
// rounded operands into shared memory, ldmatrix and mma.sync wrappers.
//
// Replaces the bf16=True branch of tpu_sednn/ops/fused_mlp.py:_dot: both
// operands of a product rounded to bfloat16 (astype(jnp.bfloat16): to
// nearest, ties to even), the products summed in float32.  A product of two
// bfloat16 values is exact in float32, so the kernels and their plain
// versions see the same operands bit for bit and differ only in how the
// float32 sums are accumulated.
//
// The one instruction is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (one warp: D (16x8) += A (16x16) @ B (16x8)).  Fragments, with g = lane / 4
// and t = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//   A: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols), a2 (row g,
//      cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C, D: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// Two bfloat16 values share a 32-bit register, the lower column (or row of B)
// in the low half.  ldmatrix.x4 loads four 8x8 bfloat16 matrices from shared
// memory, lanes 8i..8i+7 giving the row addresses of matrix i (16-byte
// aligned); a thread receives (row g, cols 2t, 2t+1) of each, or with .trans
// (rows 2t, 2t+1, col g): the transpose, for an operand stored the other way
// round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec4.cuh"

namespace sednn {

// float32 -> bfloat16 bits, to nearest, ties to even (NaN stays a quiet NaN);
// the same function as torch's .to(torch.bfloat16) and jnp's astype.
__device__ inline bf16_t rne_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (bf16_t)((u >> 16) | 0x0040u);
  return (bf16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// Four float32 values rounded and stored as four bfloat16 at p (8-byte aligned).
__device__ inline void st_rne4(bf16_t* p, float4 v) {
  uint2 r;
  r.x = (uint32_t)rne_bf16(v.x) | ((uint32_t)rne_bf16(v.y) << 16);
  r.y = (uint32_t)rne_bf16(v.z) | ((uint32_t)rne_bf16(v.w) << 16);
  *reinterpret_cast<uint2*>(p) = r;
}

// The same rounding by the hardware's paired conversion (cvt.rn.bf16x2.f32,
// one instruction for two values): the same bits as st_rne4 for every value
// but a NaN, which becomes the canonical quiet NaN.
__device__ inline void st_cvt4(bf16_t* p, float4 v) {
  uint32_t lo, hi;  // the lower column in the low half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(lo) : "f"(v.y), "f"(v.x));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(v.w), "f"(v.z));
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void ldmatrix_x4(uint32_t r[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(uint32_t r[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[0..3] += A (a[0..3]) @ B (b0, b1), float32 accumulation.
__device__ inline void mma_bf16_16816(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loaders for a 16x16 A tile or two 16x8 B tiles whose top-left
// element is `p` in a bfloat16 array of row stride `ld` (elements; ld * 2
// bytes a multiple of 16).  Which of the four 8x8 matrices a lane addresses:
// mi = lane / 8, its row r = lane % 8.
//
// A stored as it is multiplied (rows = the product's rows, contraction along
// a row): matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15) -> a0..a3.
__device__ inline void load_a(uint32_t a[4], const bf16_t* p, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, p + (r + (mi & 1) * 8) * ld + (mi >> 1) * 8);
}

// A stored transposed (rows = the contraction, the product's rows along a
// row): the same four matrices read with .trans.
__device__ inline void load_a_trans(uint32_t a[4], const bf16_t* p, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a, p + (r + (mi >> 1) * 8) * ld + (mi & 1) * 8);
}

// B stored row-major as (contraction k, output column n), n along a row: two
// n8 tiles, n 0-7 -> (b[0], b[1]) and n 8-15 -> (b[2], b[3]), with .trans.
__device__ inline void load_b_kn(uint32_t b[4], const bf16_t* p, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, p + (r + (mi & 1) * 8) * ld + (mi >> 1) * 8);
}

// B stored as (output column n, contraction k), k along a row (the "col"
// layout mma takes as it is): n 0-7 -> (b[0], b[1]), n 8-15 -> (b[2], b[3]).
__device__ inline void load_b_nk(uint32_t b[4], const bf16_t* p, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, p + (r + (mi >> 1) * 8) * ld + (mi & 1) * 8);
}

// The same loaders for a tile of 64-element (128-byte) rows stored with the
// tensor copy's 128-byte swizzle, the tile 1 KB-aligned: the 16-byte chunk
// c / 8 of row r lies at chunk (c / 8) ^ (r % 8), so the eight rows of an 8x8
// matrix lie in eight bank groups.  (r0, c0): the top-left element of the
// 16x16 tile, c0 a multiple of 8.
__device__ inline const bf16_t* sw128(const bf16_t* tile, int r, int c) {
  return tile + r * 64 + ((((c >> 3) ^ r) & 7) << 3);
}

// A stored as it is multiplied (load_a), from a swizzled tile.
__device__ inline void load_a_sw128(uint32_t a[4], const bf16_t* tile, int r0, int c0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, sw128(tile, r0 + r + (mi & 1) * 8, c0 + (mi >> 1) * 8));
}

// The same for a tile of 32-element (64-byte) rows stored with the tensor
// copy's 64-byte swizzle, the tile 512-byte aligned: the 16-byte chunk c / 8
// of row r lies at chunk (c / 8) ^ ((r / 2) % 4), so that the eight rows of
// an 8x8 matrix (four pairs of rows, each pair one 128-byte line) lie in
// eight bank groups.
__device__ inline const bf16_t* sw64(const bf16_t* tile, int r, int c) {
  return tile + r * 32 + ((((c >> 3) ^ (r >> 1)) & 3) << 3);
}

// A stored as it is multiplied (load_a), from a tile of 64-byte rows swizzled so.
__device__ inline void load_a_sw64(uint32_t a[4], const bf16_t* tile, int r0, int c0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, sw64(tile, r0 + r + (mi & 1) * 8, c0 + (mi >> 1) * 8));
}

// B stored as (k, n) (load_b_kn), from a swizzled tile.
__device__ inline void load_b_kn_sw128(uint32_t b[4], const bf16_t* tile, int r0, int c0,
                                       int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, sw128(tile, r0 + r + (mi & 1) * 8, c0 + (mi >> 1) * 8));
}

}  // namespace sednn
