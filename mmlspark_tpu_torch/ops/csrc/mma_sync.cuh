// Warp-level tensor-core and async-copy primitives for sm_80+ (used on
// sm_90a by flash_attention_bwd.cu): ldmatrix, mma.sync m16n8k16 bf16 with
// f32 accumulation, cp.async with zero-fill, and the block's dynamic
// shared memory. Every wrapper is one PTX instruction; the fragment
// layouts they imply are written out where flash_attention_bwd.cu uses
// them.
#pragma once
#include <stdint.h>

namespace mma_sync {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the block's dynamic shared memory, 16-byte aligned
__device__ __forceinline__ char* dyn_smem() {
  extern __shared__ __align__(16) char smem_[];
  return smem_;
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane l gets r[i] = (row l/4, cols 2(l%4), 2(l%4)+1) of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed: lane l gets (rows 2(l%4), 2(l%4)+1,
// col l/4) of matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two matrices, transposed; lanes 0..15 give the addresses
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a . b over one 16x8x16 tile, bf16 in, f32 accumulate. With
// g = lane / 4 and c = 2 (lane % 4): a[0] = A(g, c..c+1), a[1] =
// A(g+8, c..c+1), a[2] = A(g, c+8..c+9), a[3] = A(g+8, c+8..c+9);
// b[0] = B(c..c+1, g), b[1] = B(c+8..c+9, g); d[0..1] = D(g, c..c+1),
// d[2..3] = D(g+8, c..c+1). The lower half of a register holds the lower
// column (A) or row (B).
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b (a fresh accumulator)
__device__ __forceinline__ void mma_bf16_zero(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma_bf16(d, a, b);
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid
// (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma_sync
