// GBDT (node, feature, bin) histograms for Hopper (sm_90a).
//
// WHAT IT COMPUTES
//   hist[n, f, b] = sum over rows r of [node[r] == n] * stat[r] * [bins[r, f] == b]
// for stat in {grad, hess, count}: the contract of
// mmlspark_tpu_torch/ops/histogram.py::node_feature_histograms. Rows whose
// node lies outside [0, m) are inactive and add nothing. `cnt` may be null,
// meaning every row counts 1.
//
// WHICH TPU KERNELS IT REPLACES
//   mmlspark_tpu/ops/histogram_pallas.py::_hist_kernel (direct route) and
//   ::_hist_kernel_joint (joint-key radix route), the two routes the main
//   path takes through pallas_hist/kernel_route. On the TPU they are MXU
//   formulations (one-hot matmuls) of this one function, chosen by v5e
//   measurements; on Hopper one scatter kernel stands for both.
//   ::_hist_kernel_planes (precomputed-planes route) is hist_planes_kernel
//   below, with its own contract.
//
// PRECISION
//   The kernel follows the f32 contract of the reference's _xla_hist:
//   grad/hess are accumulated in f32 with no bf16 rounding (the TPU
//   kernels round their operands to bf16). Per-bin counts are integers
//   below 2^24 at 8M rows and come out exact; grad/hess sums differ from
//   run to run in their last bits because atomics add in no fixed order.
//
// WHAT BOUNDS IT
//   Memory: each call reads n*F bytes of bins plus 16 B per row of
//   node/grad/hess/count: ~0.40 GB at 8M rows x 32 features, ~0.12 ms at
//   3.35 TB/s. What really holds it back is shared-memory atomic
//   contention: three atomics per (row, feature).
//
// DESIGN
//   hist_smem_kernel: a block owns a group of `fg` features and a strided
//   share of the rows. It zeroes a private 3 x m x fg x B f32 histogram in
//   shared memory, walks its rows (node/grad/hess/count loaded once per
//   row, coalesced; the row's fg bin bytes come through L1), adds with
//   shared-memory atomics, then flushes the non-zero cells into the global
//   output with global atomics. The wrapper sizes fg so the block stays at
//   12 KB where it can (measured fastest, see histogram_cuda.py); a single
//   feature may take up to the card's opt-in limit (232,448 B on the
//   H100: m=64, B=256 is 196,608 B).
//   hist_global_kernel: for an m*B too large for shared memory, the same
//   walk adds straight into global memory.
//   Tensor-core (one-hot wgmma) and TMA-fed designs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hist_smem_kernel(const uint8_t* __restrict__ bins,
                 const int32_t* __restrict__ node,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 const float* __restrict__ cnt,
                 float* __restrict__ hg, float* __restrict__ hh,
                 float* __restrict__ hc,
                 long long n, int F, int m, int B, int fg) {
  extern __shared__ float sh[];  // [3][m][fg][B]
  const int f0 = blockIdx.x * fg;
  const int nf = min(fg, F - f0);
  const int span = m * fg * B;
  float* sg = sh;
  float* sh_h = sh + span;
  float* sc = sh + 2 * span;
  for (int i = threadIdx.x; i < 3 * span; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long r = (long long)blockIdx.y * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int nd = node[r];
    if (nd < 0 || nd >= m) continue;
    const float g = grad[r];
    const float h = hess[r];
    const float c = cnt ? cnt[r] : 1.f;
    const uint8_t* row = bins + r * F + f0;
    const int base = nd * fg * B;
    for (int j = 0; j < nf; ++j) {
      const int b = row[j];
      if (b >= B) continue;  // out-of-range bin ids are dropped, never written
      const int idx = base + j * B + b;
      atomicAdd(sg + idx, g);
      atomicAdd(sh_h + idx, h);
      atomicAdd(sc + idx, c);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int b = i % B;
    const int j = (i / B) % fg;
    const int nd = i / (B * fg);
    if (j >= nf) continue;
    const float vg = sg[i], vh = sh_h[i], vc = sc[i];
    if (vg == 0.f && vh == 0.f && vc == 0.f) continue;
    const long long o = ((long long)nd * F + f0 + j) * B + b;
    atomicAdd(hg + o, vg);
    atomicAdd(hh + o, vh);
    atomicAdd(hc + o, vc);
  }
}

__global__ void __launch_bounds__(kThreads)
hist_global_kernel(const uint8_t* __restrict__ bins,
                   const int32_t* __restrict__ node,
                   const float* __restrict__ grad,
                   const float* __restrict__ hess,
                   const float* __restrict__ cnt,
                   float* __restrict__ hg, float* __restrict__ hh,
                   float* __restrict__ hc,
                   long long n, int F, int m, int B) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int nd = node[r];
    if (nd < 0 || nd >= m) continue;
    const float g = grad[r];
    const float h = hess[r];
    const float c = cnt ? cnt[r] : 1.f;
    const uint8_t* row = bins + r * F;
    const long long base = (long long)nd * F * B;
    for (int f = 0; f < F; ++f) {
      const int b = row[f];
      if (b >= B) continue;
      const long long o = base + (long long)f * B + b;
      atomicAdd(hg + o, g);
      atomicAdd(hh + o, h);
      atomicAdd(hc + o, c);
    }
  }
}

// ---------------------------------------------------------------- planes
// hist_planes_kernel: port of histogram_pallas.py::_hist_kernel_planes.
//
// WHAT IT COMPUTES
//   The same (m, F, B) histograms, with the lo digit of the joint key
//   node*B + bin read from a per-fit plan instead of the bins:
//     hi(r) = node[r] * W + bins[r, f] / LO             (W = B / LO)
//     H_s[f, hi, lo] = sum_r bf16(s_r) * [hi(r) == hi] * plan[f, r, lo]
//   for s in {grad, hess, count}; plan is (F, n, LO) int8, the one-hot of
//   bin % LO (build_hist_plan). grad, hess and count are rounded to bf16
//   (round to nearest even) before the product, as the TPU kernel rounds
//   its matmul operands; accumulation is f32. A kernel that recomputed
//   bin % LO from the bins would compute another function: this one reads
//   lo from the plan, so a plan of other bins gives other histograms.
//
// WHAT BOUNDS IT
//   Memory: each active (row, feature) reads LO plan bytes besides its bin
//   byte: F*n*(1+LO) + 16n bytes, ~4.5 GB at 8M x 32 with LO = 16, i.e.
//   ~1.33 ms at 3.35 TB/s when every row is active. On the TPU the plan
//   saved vector work; here it only adds bytes, so this route cannot beat
//   hist_smem_kernel (whose bound is ~0.06-0.09 ms) and stays opt-in.
//
// DESIGN
//   hist_smem_kernel's: a block owns fg features and a strided share of
//   the rows, keeps a private 3 x m x fg x B f32 histogram in shared
//   memory (hi*LO + lo == bin within a node), and flushes it with global
//   atomics. Per active row: node and stats loaded once, then per feature
//   its bin byte and its LO plan bytes as LO/16 16-byte streaming loads
//   (consecutive rows of a warp read consecutive 16-byte chunks), and one
//   shared-memory atomic per statistic for every non-zero plan byte.
//   Two choices measured on the H100 (PERF.md): a byte-by-byte test of
//   the LO plan bytes made it instruction-bound (~7-9.5 ms at 8M x 32
//   x 64 bins), so __ffs jumps from one non-zero byte to the next; and
//   __launch_bounds__(kThreads, 8) holds it to 32 registers, so 8 blocks
//   fit an SM, as the launch geometry assumes, with no spills.
//   Tensor cores (the TPU's (3*m*W, T) @ (T, LO) per feature as bf16
//   mma.sync) and TMA are later work.
template <int LO>
__global__ void __launch_bounds__(kThreads, 8)
hist_planes_kernel(const int8_t* __restrict__ plan,
                   const uint8_t* __restrict__ bins,
                   const int32_t* __restrict__ node,
                   const float* __restrict__ grad,
                   const float* __restrict__ hess,
                   const float* __restrict__ cnt,
                   float* __restrict__ hg, float* __restrict__ hh,
                   float* __restrict__ hc,
                   long long n, int F, int m, int B, int fg) {
  extern __shared__ float sh[];  // [3][m][fg][B]
  const int f0 = blockIdx.x * fg;
  const int nf = min(fg, F - f0);
  const int span = m * fg * B;
  float* sg = sh;
  float* sh_h = sh + span;
  float* sc = sh + 2 * span;
  for (int i = threadIdx.x; i < 3 * span; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long r = (long long)blockIdx.y * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int nd = node[r];
    if (nd < 0 || nd >= m) continue;
    const float g = __bfloat162float(__float2bfloat16_rn(grad[r]));
    const float h = __bfloat162float(__float2bfloat16_rn(hess[r]));
    const float c =
        cnt ? __bfloat162float(__float2bfloat16_rn(cnt[r])) : 1.f;
    const uint8_t* row = bins + r * F + f0;
    for (int j = 0; j < nf; ++j) {
      const int b = row[j];
      if (b >= B) continue;  // out-of-range bin ids are dropped
      const uint4* p = reinterpret_cast<const uint4*>(
          plan + ((long long)(f0 + j) * n + r) * LO);
      const int base = (nd * fg + j) * B + (b / LO) * LO;
#pragma unroll
      for (int v = 0; v < LO / 16; ++v) {
        const uint4 q = __ldcs(p + v);
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          // visit only the non-zero plan bytes (adding 0 * s is exact):
          // __ffs finds the lowest set bit, so its byte is the next one
          for (uint32_t word = words[w]; word != 0u;) {
            const int k = (__ffs(word) - 1) >> 3;
            const float s = (float)(int8_t)(word >> (8 * k));
            word &= ~(0xffu << (8 * k));
            const int idx = base + v * 16 + w * 4 + k;
            atomicAdd(sg + idx, g * s);
            atomicAdd(sh_h + idx, h * s);
            atomicAdd(sc + idx, c * s);
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int b = i % B;
    const int j = (i / B) % fg;
    const int nd = i / (B * fg);
    if (j >= nf) continue;
    const float vg = sg[i], vh = sh_h[i], vc = sc[i];
    if (vg == 0.f && vh == 0.f && vc == 0.f) continue;
    const long long o = ((long long)nd * F + f0 + j) * B + b;
    atomicAdd(hg + o, vg);
    atomicAdd(hh + o, vh);
    atomicAdd(hc + o, vc);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on `device`.
int hist_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Outputs must be zeroed by the caller. Returns a cudaError_t (0 = launched).
int hist_smem_launch(const void* bins, const void* node, const void* grad,
                     const void* hess, const void* cnt, void* hg, void* hh,
                     void* hc, long long n, int F, int m, int B, int fg,
                     int row_blocks, void* stream) {
  const size_t smem = 3ull * m * fg * B * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      hist_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((F + fg - 1) / fg, row_blocks);
  hist_smem_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int32_t*)node, (const float*)grad,
      (const float*)hess, (const float*)cnt, (float*)hg, (float*)hh,
      (float*)hc, n, F, m, B, fg);
  return (int)cudaGetLastError();
}

int hist_global_launch(const void* bins, const void* node, const void* grad,
                       const void* hess, const void* cnt, void* hg, void* hh,
                       void* hc, long long n, int F, int m, int B,
                       int blocks, void* stream) {
  hist_global_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int32_t*)node, (const float*)grad,
      (const float*)hess, (const float*)cnt, (float*)hg, (float*)hh,
      (float*)hc, n, F, m, B);
  return (int)cudaGetLastError();
}

// plan: (F, n, LO) int8, 16-byte aligned; LO in {16, 64} and LO | B.
// Outputs must be zeroed by the caller. Returns a cudaError_t (0 =
// launched), cudaErrorInvalidValue for an LO the kernel is not built for.
int hist_planes_launch(const void* plan, const void* bins, const void* node,
                       const void* grad, const void* hess, const void* cnt,
                       void* hg, void* hh, void* hc, long long n, int F,
                       int m, int B, int LO, int fg, int row_blocks,
                       void* stream) {
  const size_t smem = 3ull * m * fg * B * sizeof(float);
  const dim3 grid((F + fg - 1) / fg, row_blocks);
  cudaError_t e;
#define HIST_PLANES_LAUNCH(lo)                                               \
  e = cudaFuncSetAttribute(hist_planes_kernel<lo>,                           \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                           (int)smem);                                       \
  if (e != cudaSuccess) return (int)e;                                       \
  hist_planes_kernel<lo><<<grid, kThreads, smem, (cudaStream_t)stream>>>(    \
      (const int8_t*)plan, (const uint8_t*)bins, (const int32_t*)node,       \
      (const float*)grad, (const float*)hess, (const float*)cnt, (float*)hg, \
      (float*)hh, (float*)hc, n, F, m, B, fg);
  if (LO == 16) {
    HIST_PLANES_LAUNCH(16)
  } else if (LO == 64) {
    HIST_PLANES_LAUNCH(64)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef HIST_PLANES_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
