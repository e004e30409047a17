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
//   path takes through pallas_hist/kernel_route, and the reference's
//   _xla_hist (ops/histogram.py), which takes the levels past M_MAX. On
//   the TPU they are MXU formulations (one-hot matmuls) of this one
//   function, chosen by v5e measurements; on Hopper one scatter kernel,
//   hist_tile_kernel, stands for all three at every m * B.
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
//   Memory: each call reads 4 B of node per row and, for the active rows,
//   F bytes of bins and 8-12 B of grad/hess/count: ~0.32-0.40 GB at 8M
//   rows x 32 features, ~0.1 ms at 3.35 TB/s. Three shared-memory atomics
//   per active (row, feature) are the work: 768M a call at 8M x 32.
//
// DESIGN (hist_tile_kernel)
//   A block owns a tile of mt nodes x ft features, `copies` copies of its
//   3 x mt x B x FP f32 histograms in shared memory (FP = ft rounded up to
//   a multiple of 32, so feature f of a (node, bin) lies in bank f % 32),
//   and a strided share of the rows. A pure-Python planner
//   (histogram_cuda.plan_tiles) picks the tile from (n, F, m, B, the
//   card's shared memory, its SMs): all F features where they fit beside
//   the level's nodes (node and stats are then read once a call: 196,608
//   B of histograms at m = 8, F = 32, B = 64), the nodes split over tiles
//   only where they do not (each node tile reads every row's node and the
//   stats and bins of its own nodes' rows: m = 128, B = 256 takes 64
//   tiles).
//   - A warp loads the nodes of kWindows windows of 32 rows at once and
//     queues the rows of its tile's nodes in shared memory: a tile of few
//     nodes skips most rows at the cost of their node load alone.
//   - While 32 rows are queued, its lanes add one each: the row's stats,
//     its tile's bins in 16-byte loads (bytes where F is not a multiple
//     of 16), rotated in registers so that lane l takes feature
//     (t + l) % 32 at step t. Every step's 32 atomics then fall in 32
//     distinct features of the lanes' rows, hence 32 distinct banks and no
//     two on one address.
//   - Without cnt, counts are integer atomics (one instruction; a float
//     shared-memory atomic is a compare-and-swap loop on this card, which
//     is what bounds the kernel: three adds per active (row, feature)).
//   - Where the tile leaves room, warp w adds into copy w % copies; the
//     block flushes the copies' sum once, non-zero cells only, with global
//     atomics.
//   Tensor-core (one-hot wgmma) and TMA-fed designs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // hist_planes_kernel
constexpr int kMaxThreads = 1024;  // hist_tile_kernel, any multiple of 32
constexpr int kWindows = 4;        // 32-row windows a warp loads at once
// rows a warp can queue: fewer than 32 left over, and kWindows windows
constexpr int kQueue = 32 * (kWindows + 1);

// w (32 bytes) rotated left by k bytes: byte t of the result is byte
// (t + k) % 32 of w
__device__ __forceinline__ void rotate_bytes(uint32_t w[8], int k) {
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {  // by (k / 4) words, one bit a pass
    const bool on = (k >> 2) & s;
    uint32_t r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = on ? w[(i + s) & 7] : w[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = r[i];
  }
  const int sh = 8 * (k & 3);        // then by k % 4 bytes
  const uint32_t w0 = w[0];
#pragma unroll
  for (int i = 0; i < 7; ++i) w[i] = __funnelshift_r(w[i], w[i + 1], sh);
  w[7] = __funnelshift_r(w[7], w0, sh);
}

// kCnt: count sums cnt[r] in f32; otherwise every row counts 1, summed as
// an integer in shared memory (exact, and an integer atomic is one
// instruction where a float one is a compare-and-swap loop)
template <bool kCnt>
struct TileRows {
  const uint8_t* __restrict__ bins;
  const int32_t* __restrict__ node;
  const float* __restrict__ grad;
  const float* __restrict__ hess;
  const float* __restrict__ cnt;
  int F, B, n0, f0, nf, FP;
  bool vec;        // the row's 32-byte chunks are 16-byte aligned

  // row r (of this tile) into the block's histograms at h (one copy;
  // statistic s at h + s * span). Lane l takes feature (t + l) % 32 of
  // each 32-feature chunk at step t, so a warp's 32 lanes add into 32
  // distinct features, hence distinct banks, at every step.
  __device__ __forceinline__ void add(int r, float* h, int span) const {
    const int lane = threadIdx.x & 31;
    const float g = grad[r], hs = hess[r];
    const float c = kCnt ? cnt[r] : 1.f;
    const int base = (node[r] - n0) * B * FP;
    const uint8_t* row = bins + (long long)r * F + f0;
    for (int f32 = 0; f32 < nf; f32 += 32) {
      uint32_t w[8];
      if (vec && f32 + 32 <= nf) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + f32));
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + f32 + 16));
        w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
        w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          w[i] = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (f32 + 4 * i + e < nf)
              w[i] |= (uint32_t)__ldg(row + f32 + 4 * i + e) << (8 * e);
        }
      }
      rotate_bytes(w, lane);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int f = f32 + ((t + lane) & 31);
        const int b = (w[t >> 2] >> (8 * (t & 3))) & 0xff;
        if (f >= nf || b >= B) continue;  // out-of-range bins are dropped
        const int idx = base + b * FP + f;
        atomicAdd(h + idx, g);
        atomicAdd(h + span + idx, hs);
        if constexpr (kCnt)
          atomicAdd(h + 2 * span + idx, c);
        else
          atomicAdd(reinterpret_cast<unsigned*>(h + 2 * span) + idx, 1u);
      }
    }
  }
};

template <bool kCnt>
__global__ void __launch_bounds__(kMaxThreads)
hist_tile_kernel(const uint8_t* __restrict__ bins,
                 const int32_t* __restrict__ node,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 const float* __restrict__ cnt, float* __restrict__ hg,
                 float* __restrict__ hh, float* __restrict__ hc, long long n,
                 int F, int m, int B, int mt, int ft, int copies,
                 int n_ftiles, int vec) {
  // [3][copies][mt][B][FP] f32, FP = ft rounded up to 32 (feature f of a
  // (node, bin) in bank f % 32), then a queue of kQueue rows per warp
  extern __shared__ float sh[];
  const int FP = 32 * ((ft + 31) / 32);
  const int n0 = (blockIdx.x / n_ftiles) * mt;
  const int f0 = (blockIdx.x % n_ftiles) * ft;
  const int nm = min(mt, m - n0), nf = min(ft, F - f0);
  const int cell = mt * B * FP;       // one copy of one statistic
  const int span = copies * cell;     // one statistic
  for (int i = threadIdx.x; i < 3 * span; i += blockDim.x) sh[i] = 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* q = reinterpret_cast<int*>(sh + 3 * span) + kQueue * warp;
  float* const h = sh + (warp % copies) * cell;
  const TileRows<kCnt> rows = {bins, node, grad, hess, cnt,
                               F,    B,    n0,   f0,   nf, FP, vec != 0};
  __syncthreads();

  // A warp walks windows of 32 rows, kWindows windows' nodes loaded at
  // once, and queues the rows of this tile's nodes; while 32 are queued
  // (or, at the end, any), its lanes add one each. A tile of few nodes
  // skips most rows at the cost of their node load, and every add runs
  // 32 lanes wide. One call site of add: its unrolled body is large.
  int qn = 0;                                       // rows queued
  const long long wstride = (long long)gridDim.y * blockDim.x;
  long long w0 = (long long)blockIdx.y * blockDim.x + 32 * warp;
  for (bool done = w0 >= n; true;) {
    if (!done) {
      int nd[kWindows];
#pragma unroll
      for (int u = 0; u < kWindows; ++u) {
        const long long r = w0 + u * wstride + lane;
        nd[u] = r < n ? node[r] - n0 : -1;   // inactive rows are -1
      }
#pragma unroll
      for (int u = 0; u < kWindows; ++u) {
        const bool in = (unsigned)nd[u] < (unsigned)nm;
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        if (in)
          q[qn + __popc(mask & ((1u << lane) - 1))] =
              (int)(w0 + u * wstride) + lane;
        qn += __popc(mask);
      }
      w0 += kWindows * wstride;
      done = w0 >= n;
    }
    __syncwarp();
    while (qn >= 32 || (done && qn > 0)) {  // the last rows queued
      const int take = min(qn, 32);
      if (lane < take) rows.add(q[qn - take + lane], h, span);
      qn -= take;
      __syncwarp();
    }
    if (done) break;
  }
  __syncthreads();

  // the copies summed, each non-zero cell added once into the output
  float* sg = sh;
  float* sh_h = sh + span;
  float* sc = sh + 2 * span;
  for (int i = threadIdx.x; i < nm * nf * B; i += blockDim.x) {
    const int j = i % nf;
    const int b = (i / nf) % B;
    const int nd = i / (B * nf);
    const int src = (nd * B + b) * FP + j;
    float vg = 0.f, vh = 0.f, vc = 0.f;
    for (int k = 0; k < copies; ++k) {
      vg += sg[k * cell + src];
      vh += sh_h[k * cell + src];
      vc += kCnt ? sc[k * cell + src]
                 : (float)reinterpret_cast<const unsigned*>(sc)[k * cell +
                                                                 src];
    }
    if (vg == 0.f && vh == 0.f && vc == 0.f) continue;
    const long long o = ((long long)(n0 + nd) * F + f0 + j) * B + b;
    atomicAdd(hg + o, vg);
    atomicAdd(hh + o, vh);
    atomicAdd(hc + o, vc);
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
//   hist_tile_kernel (whose bound is ~0.06-0.09 ms) and stays opt-in.
//
// DESIGN
//   A block owns fg features and a strided share of the rows, keeps a
//   private 3 x m x fg x B f32 histogram in shared memory (hi*LO + lo ==
//   bin within a node), and flushes it with global
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

// The shared memory of `device`: the most one block may opt in to, and
// the most one SM holds. Returns a cudaError_t.
int hist_card_smem(int device, int* per_block, int* per_sm) {
  cudaError_t e = cudaDeviceGetAttribute(
      per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
}

// The tiled kernel: a grid of (node tiles x feature tiles, row_blocks)
// blocks of `threads` threads (a multiple of 32), each tile mt nodes x ft
// features with `copies` copies of its histograms; n < 2^31. vec: F and
// ft are multiples of 16 and the bins 16-byte aligned. cnt may be null
// (every row counts 1). Outputs must be zeroed by the caller. Returns a
// cudaError_t (0 = launched).
int hist_tile_launch(const void* bins, const void* node, const void* grad,
                     const void* hess, const void* cnt, void* hg, void* hh,
                     void* hc, long long n, int F, int m, int B, int mt,
                     int ft, int copies, int threads, int row_blocks,
                     int vec, void* stream) {
  const size_t smem =
      (3ull * copies * mt * B * (32 * ((ft + 31) / 32)) +
       (threads / 32) * kQueue) * sizeof(float);
  const int n_ftiles = (F + ft - 1) / ft;
  const dim3 grid(((m + mt - 1) / mt) * n_ftiles, row_blocks);
  const void* fn = cnt ? reinterpret_cast<const void*>(hist_tile_kernel<true>)
                       : reinterpret_cast<const void*>(hist_tile_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (cnt)
    hist_tile_kernel<true><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)bins, (const int32_t*)node, (const float*)grad,
        (const float*)hess, (const float*)cnt, (float*)hg, (float*)hh,
        (float*)hc, n, F, m, B, mt, ft, copies, n_ftiles, vec);
  else
    hist_tile_kernel<false><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)bins, (const int32_t*)node, (const float*)grad,
        (const float*)hess, nullptr, (float*)hg, (float*)hh, (float*)hc, n,
        F, m, B, mt, ft, copies, n_ftiles, vec);
  return (int)cudaGetLastError();
}

// How many blocks of hist_tile_kernel<cnt != 0> with `threads` threads
// and `smem` bytes of shared memory fit one SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
int hist_tile_occupancy(int cnt, int threads, int smem,
                        int* blocks_per_sm) {
  const void* fn = cnt ? reinterpret_cast<const void*>(hist_tile_kernel<true>)
                       : reinterpret_cast<const void*>(hist_tile_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads, smem);
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
