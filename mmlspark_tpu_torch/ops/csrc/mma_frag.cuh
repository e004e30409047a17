// Fragment loads and bf16 packing for mma.sync.m16n8k16 over tiles stored
// row-major in shared memory, built on mma_sync.cuh's primitives (whose
// comments give the fragment layouts). Shared by the flash forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace mma_sync {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// (lo, hi) rounded to bf16, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// T(x * s) for both halves of a bf16x2 register (x * s is exact in f32)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float lo = __uint_as_float(x << 16) * s;
  const float hi = __uint_as_float(x & 0xffff0000u) * s;
  return pack_bf16(lo, hi);
}

// `t` points at a tile in shared memory with row stride ld.
// A (16 x 16) at rows m0, cols k0 of a row-major bf16 tile
__device__ __forceinline__ void lda(uint32_t a[4], const bf16* t, int ld,
                                    int m0, int k0) {
  const int l = lane_id();
  ldsm_x4(a, t + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
// A at (m0, k0) of the transpose of a row-major bf16 tile: A(m, k) = t[k][m]
__device__ __forceinline__ void lda_t(uint32_t a[4], const bf16* t, int ld,
                                      int m0, int k0) {
  const int l = lane_id();
  ldsm_x4_t(a, t + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 +
                   ((l >> 3) & 1) * 8);
}
// B (16 x 8) of n-tiles n0 and n0 + 8 at depth k0, where B(k, n) = t[n][k]
__device__ __forceinline__ void ldb_nk(uint32_t b[2][2], const bf16* t,
                                       int ld, int n0, int k0) {
  const int l = lane_id();
  uint32_t r[4];
  ldsm_x4(r, t + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 +
                 ((l >> 3) & 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}
// B of n-tiles n0 and n0 + 8 at depth k0, where B(k, n) = t[k][n]
__device__ __forceinline__ void ldb_kn(uint32_t b[2][2], const bf16* t,
                                       int ld, int n0, int k0) {
  const int l = lane_id();
  uint32_t r[4];
  ldsm_x4_t(r, t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 +
                   (l >> 4) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}
// B of the one n-tile n0, where B(k, n) = t[k][n]
__device__ __forceinline__ void ldb_kn1(uint32_t b[2], const bf16* t, int ld,
                                        int n0, int k0) {
  const int l = lane_id();
  ldsm_x2_t(b, t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0);
}

}  // namespace mma_sync
