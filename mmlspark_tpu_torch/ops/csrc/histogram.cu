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
//   measurements; on Hopper one scatter kernel stands for both. The
//   precomputed-planes route (_hist_kernel_planes) is not ported yet.
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

}  // extern "C"
