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
//   run to run in their last bits because atomics add in no fixed order:
//   a block's warps share copies, and blocks flush with global atomics.
//
// THE FIXED-ORDER FORM (hist_tile_kernel<kCnt, true>, and
// hist_planes_kernel with qg set)
//   Checkpointed GBDT fits need histograms that are a pure function of
//   their inputs, so that a killed and resumed fit equals an uninterrupted
//   one bit for bit. Here every statistic is added as a 64-bit integer:
//   q = rint(s * 2^(k - e)), with 2^e above the largest |s| of the call
//   and k = 62 - bit_length(n), so no sum of n terms can overflow. Integer
//   adds are exact, so their order cannot change the result, and the same
//   shared-memory copies and global atomics serve. The wrapper turns the
//   sums back into f32 (histogram_cuda.hist_tiled_fixed). Each term is off
//   by at most 2^(e - k - 1) (2^-40 of the largest |grad| at 8M rows), far
//   below what the f32 sums of the atomic form lose; the planes form rounds
//   its f32 register totals (one per warp, item and row block, summed in a
//   fixed order) the same way.
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

#include <type_traits>

#include "mma_sync.cuh"

namespace {

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
// instruction where a float one is a compare-and-swap loop).
// kFixed: the fixed-order form. Each statistic is added as a 64-bit
// integer, q = rint(stat * scale) with a power-of-two scale per statistic
// (the wrapper picks it from the largest |stat|, so no sum can overflow):
// integer adds give one result in any order, so the shared-memory copies
// and the flush's global atomics stay as they are and the histograms are a
// pure function of the inputs. A row without cnt counts 1.
template <bool kCnt, bool kFixed>
struct TileRows {
  using Acc = typename std::conditional<kFixed, unsigned long long,
                                        float>::type;
  const uint8_t* __restrict__ bins;
  const int32_t* __restrict__ node;
  const float* __restrict__ grad;
  const float* __restrict__ hess;
  const float* __restrict__ cnt;
  int F, B, n0, f0, nf, FP;
  bool vec;        // the row's 32-byte chunks are 16-byte aligned
  float s_g, s_h, s_c;  // kFixed: the statistics' scales

  // row r (of this tile) into the block's histograms at h (one copy;
  // statistic s at h + s * span). Lane l takes feature (t + l) % 32 of
  // each 32-feature chunk at step t, so a warp's 32 lanes add into 32
  // distinct features, hence distinct banks, at every step.
  __device__ __forceinline__ void add(int r, Acc* h, int span) const {
    const int lane = threadIdx.x & 31;
    const float g = grad[r], hs = hess[r];
    const float c = kCnt ? cnt[r] : 1.f;
    // kFixed: the integers; stat * scale is exact (a power of two), and
    // rounding it to an integer is the only loss
    const unsigned long long qg =
        kFixed ? (unsigned long long)__float2ll_rn(g * s_g) : 0ull;
    const unsigned long long qh =
        kFixed ? (unsigned long long)__float2ll_rn(hs * s_h) : 0ull;
    const unsigned long long qc =
        kFixed && kCnt ? (unsigned long long)__float2ll_rn(c * s_c) : 0ull;
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
        if constexpr (kFixed) {
          atomicAdd(h + idx, qg);
          atomicAdd(h + span + idx, qh);
          if constexpr (kCnt)
            atomicAdd(h + 2 * span + idx, qc);
          else  // the cell's low word: counts below 2^31 never carry
            atomicAdd(reinterpret_cast<unsigned*>(h + 2 * span + idx), 1u);
        } else {
          atomicAdd(h + idx, g);
          atomicAdd(h + span + idx, hs);
          if constexpr (kCnt)
            atomicAdd(h + 2 * span + idx, c);
          else
            atomicAdd(reinterpret_cast<unsigned*>(h + 2 * span) + idx, 1u);
        }
      }
    }
  }
};

// hg, hh, hc: (m, F, B) f32 outputs, or (kFixed) u64 ones; scale: the
// three statistics' scales (kFixed), else null
template <bool kCnt, bool kFixed>
__global__ void __launch_bounds__(kMaxThreads)
hist_tile_kernel(const uint8_t* __restrict__ bins,
                 const int32_t* __restrict__ node,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 const float* __restrict__ cnt, void* __restrict__ hg,
                 void* __restrict__ hh, void* __restrict__ hc,
                 const float* __restrict__ scale, long long n,
                 int F, int m, int B, int mt, int ft, int copies,
                 int n_ftiles, int vec) {
  using Acc = typename TileRows<kCnt, kFixed>::Acc;
  // [3][copies][mt][B][FP] Acc, FP = ft rounded up to 32 (feature f of a
  // (node, bin) in bank f % 32), then a queue of kQueue rows per warp
  Acc* sh = reinterpret_cast<Acc*>(mma_sync::dyn_smem());
  const int FP = 32 * ((ft + 31) / 32);
  const int n0 = (blockIdx.x / n_ftiles) * mt;
  const int f0 = (blockIdx.x % n_ftiles) * ft;
  const int nm = min(mt, m - n0), nf = min(ft, F - f0);
  const int cell = mt * B * FP;       // one copy of one statistic
  const int span = copies * cell;     // one statistic
  for (int i = threadIdx.x; i < 3 * span; i += blockDim.x) sh[i] = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* q = reinterpret_cast<int*>(sh + 3 * span) + kQueue * warp;
  Acc* const h = sh + (warp % copies) * cell;
  const TileRows<kCnt, kFixed> rows = {
      bins, node, grad, hess, cnt, F, B, n0, f0, nf, FP, vec != 0,
      kFixed ? scale[0] : 0.f, kFixed ? scale[1] : 0.f,
      kFixed ? scale[2] : 0.f};
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
  const Acc* sg = sh;
  const Acc* sh_h = sh + span;
  const Acc* sc = sh + 2 * span;
  for (int i = threadIdx.x; i < nm * nf * B; i += blockDim.x) {
    const int j = i % nf;
    const int b = (i / nf) % B;
    const int nd = i / (B * nf);
    const int src = (nd * B + b) * FP + j;
    const long long o = ((long long)(n0 + nd) * F + f0 + j) * B + b;
    if constexpr (kFixed) {
      unsigned long long vg = 0, vh = 0, vc = 0;
      for (int k = 0; k < copies; ++k) {
        vg += sg[k * cell + src];
        vh += sh_h[k * cell + src];
        vc += sc[k * cell + src];
      }
      if (vg == 0 && vh == 0 && vc == 0) continue;
      atomicAdd(static_cast<unsigned long long*>(hg) + o, vg);
      atomicAdd(static_cast<unsigned long long*>(hh) + o, vh);
      atomicAdd(static_cast<unsigned long long*>(hc) + o, vc);
    } else {
      float vg = 0.f, vh = 0.f, vc = 0.f;
      for (int k = 0; k < copies; ++k) {
        vg += sg[k * cell + src];
        vh += sh_h[k * cell + src];
        vc += kCnt ? sc[k * cell + src]
                   : (float)reinterpret_cast<const unsigned*>(sc)[k * cell +
                                                                   src];
      }
      if (vg == 0.f && vh == 0.f && vc == 0.f) continue;
      atomicAdd(static_cast<float*>(hg) + o, vg);
      atomicAdd(static_cast<float*>(hh) + o, vh);
      atomicAdd(static_cast<float*>(hc) + o, vc);
    }
  }
}

// ---------------------------------------------------------------- planes
// hist_planes_kernel<LO, HT>: port of
// histogram_pallas.py::_hist_kernel_planes.
//
// WHAT IT COMPUTES
//   The same (m, F, B) histograms, with the lo digit of the joint key
//   node*B + bin read from a per-fit plan instead of the bins:
//     hi(r) = node[r] * W + bins[r, f] / LO             (W = B / LO)
//     H_s[f, hi, lo] = sum_r bf16(s_r) * [hi(r) == hi] * plan[f, r, lo]
//   for s in {grad, hess, count}; plan is (F, n, LO) int8, the one-hot of
//   bin % LO (build_hist_plan), and any int8 value v in it is the factor
//   v. grad, hess and count are rounded to bf16 (round to nearest even)
//   before the product, as the TPU kernel rounds its matmul operands;
//   accumulation is f32. Rows that are inactive, whose node lies outside
//   [0, m) or whose bin is >= B add nothing. The kernel reads lo from the
//   plan and never from the bins, so a plan of other bins gives other
//   histograms.
//
// WHAT BOUNDS IT
//   Memory: the plan is F*n*LO bytes, 4.1 GB at 8M x 32 with LO = 16. At
//   LO = 16 a row's plan is half of a 32-byte sector, so with a random
//   share of the rows active the kernel still reads nearly every sector:
//   ~1.0-1.3 ms at 3.35 TB/s at m = 1-4. The dense product is 3*n_hi x LO
//   multiply-adds per (row, feature), ~0.3 ms at the bf16 peak at m = 4;
//   the int8 -> bf16 conversion and the one-hot masks around it cost more
//   issue slots than the mma itself, so at HT = 2 (m = 4 at B = 64, B =
//   256) the instructions, not the bytes, bound it (PERF.md). On the TPU
//   the plan saved vector work; here it only adds bytes, so this route
//   cannot beat hist_tile_kernel and stays opt-in.
//
// DESIGN
//   The TPU kernel's product, per feature and tile of rows, on the tensor
//   cores: mma.sync.m16n8k16 bf16 -> f32 with the operands swapped,
//     D (LO x 3*8*HT) += plan^T (LO x 16 rows) . U^T (16 rows x 3*8*HT),
//   U^T[r, (s*HT + ht)*8 + g] = bf16(stat_s(r)) where hi(r) == 8*ht + g,
//   else 0 (HT = ceil(n_hi / 8) h-tiles of 8, n_hi = m*W <= 32). The plan
//   is A because its tile is row-major (row, lo) in shared memory: one
//   ldmatrix.x4.trans (int8 pairs as b16) hands each lane the bytes of A's
//   fragments for two 16-row steps, rows 2q, 2q+1 (+8) at lo 2g, 2g+1. M
//   is permuted so those two bytes are the fragment's rows g and g+8 (lo =
//   16t + 2g + j for chunk t); K is the rows in order. int8 -> bf16 is
//   exact in three ops a pair, two LOP3 and one HADD2 (bytes b -> (128 +
//   (b&127)) - (128 or 256)), with the constants in registers (ptxas gives
//   a LOP3 one immediate). U^T is built in registers: the B fragment's
//   column g is one h, so a lane compares its 4 rows' hi bytes with h
//   once per (feature, step) ((hi ^ h) + 0x7f in each byte; prmt spreads
//   bit 7 to 16-bit masks) and clears the packed bf16 stats of the rows
//   that differ, for the three statistics. Every product is exact in f32:
//   an int8 value and a bf16 value each have 8 significant bits.
//   - A block owns fg features (an item is a feature's 16-wide lo chunk;
//     LO = 64 has four) and walks tiles of kRows rows, grid-strided. The
//     tile's plan segments plan[f, r0:r0+kRows, :] (kRows*LO contiguous
//     bytes each), its bins rows and its node and stats move into a
//     kStages-deep shared-memory ring by 16-byte cp.async (zero-filled past
//     n). LO = 64 rows are XOR-swizzled by 16-byte chunk so ldmatrix's
//     eight rows hit eight bank groups.
//   - One barrier a tile: after it the block refills the ring, writes the
//     next tile's tables (each row's hi byte per feature, node*W + bin/LO
//     with 0x40 set where the row adds nothing; the rows' packed bf16
//     stats; both in the lanes' row order, double-buffered) and runs this
//     tile's products, so the tables of one tile are built while the
//     products of another run.
//   - A fresh accumulator per tile: an mma truncates its accumulator
//     input toward zero, so a tile's four steps chain through one and the
//     tile's sum is added to the warp's running f32 totals in registers
//     with ordinary adds. Counts are integer sums below 2^24, exact.
//   - No shared-memory atomics: a warp owns its items' totals, and writes
//     them once at the end, non-zero cells only, with global atomics.
//   - A warp takes 4 / HT items (1 past HT = 2), so its totals stay at 48
//     registers and two blocks of 8 warps fit an SM at HT <= 2.
using mma_sync::cp_async16_n;
using mma_sync::prmt;

constexpr int kPlanesThreads = 256;                 // 8 warps
constexpr int kRows = 64;          // rows a tile: four 16-row mma steps
constexpr int kStages = 3;         // cp.async ring depth
// planes_load gives each thread one 16-byte chunk of a feature's tile
static_assert(kPlanesThreads % (kRows * 4) == 0, "a tile's LO = 64 chunks");

__host__ __device__ constexpr int planes_items_per_warp(int ht) {
  return ht == 1 ? 4 : ht == 2 ? 2 : 1;
}

struct PlanesArgs {
  const int8_t* plan;
  const uint8_t* bins;
  const int32_t* node;
  const float* grad;
  const float* hess;
  const float* cnt;  // null: every row counts 1
  float* hg;
  float* hh;
  float* hc;
  // the fixed-order form (null otherwise): (m, F, B) u64 fixed-point
  // outputs in place of hg/hh/hc, and the statistics' three scales
  unsigned long long* qg;
  unsigned long long* qh;
  unsigned long long* qc;
  const float* scale;
  long long n;
  int F, m, B, W, n_hi, fg;
  int bins_stage;    // bytes of a stage's bins rows (a multiple of 16)
  int stage_bytes;   // one stage: plan, bins, node, grad, hess, cnt
};

// The int8 -> bf16 constants, in registers: m7 = 0x007f007f, m8 =
// 0x00800080, p = 0x43004300 (bf16 128), q = 0xc300c300 (bf16 -128).
struct Int8Cvt {
  uint32_t m7, m8, p, q;
};

// bytes 0 and 2 of w (int8 values, two plan rows at one lo) as bf16x2,
// exactly: 0x4300 | (b & 0x7f) is 128 + (b & 127), and subtracting 128
// (b >= 0) or 256 (b < 0) leaves the int8 value b in one exact add
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w,
                                                     const Int8Cvt& k) {
  constexpr int kAndOr = (0xf0 & 0xcc) | 0xaa;  // (a & b) | c
  return mma_sync::fma_bf16x2(mma_sync::lop3<kAndOr>(w, k.m7, k.p),
                              0x3f803f80u,
                              mma_sync::lop3<kAndOr>(w, k.m8, k.q));
}

// the tile's chunk c of plan row r sits at chunk c ^ swizzle(r): for LO =
// 64 (four chunks a row) the eight rows of an ldmatrix then hit eight
// bank groups; LO = 16 rows are 16 bytes apart and need none
template <int LO>
__device__ __forceinline__ int plan_swizzle(int r) {
  return LO == 64 ? (r >> 1) & 3 : 0;
}

// issue the copies of tile `tile` into the ring stage at `stage`
template <int LO>
__device__ __forceinline__ void planes_load(const PlanesArgs& a,
                                            char* stage, long long tile,
                                            int f0) {
  constexpr int C = LO / 16;                  // 16-byte chunks a row
  constexpr int kPerFeature = kRows * C;      // chunks a feature, 64 or 256
  const int tid = threadIdx.x;
  const long long r0 = tile * kRows;
  const int rows = (int)min((long long)kRows, a.n - r0);
  // plan: thread tid takes chunk tid % kPerFeature of features
  // tid / kPerFeature, + kPlanesThreads / kPerFeature, ...
  {
    const int pos = tid % kPerFeature, c = pos % C, r = pos / C;
    const bool row_ok = r < rows;
    const int8_t* src =
        a.plan + ((long long)f0 * a.n + r0 + r) * LO + 16 * c;
    int8_t* dst = reinterpret_cast<int8_t*>(stage) + r * LO +
                  16 * (c ^ plan_swizzle<LO>(r));
    const long long src_step = (long long)a.n * LO;
    for (int fl = tid / kPerFeature; fl < a.fg;
         fl += kPlanesThreads / kPerFeature) {
      const bool ok = row_ok && f0 + fl < a.F;
      mma_sync::cp_async16(dst + fl * kRows * LO,
                           ok ? src + fl * src_step : a.plan, ok);
    }
  }
  // bins: whole rows, from the 16-byte boundary at or before row r0
  uint8_t* sbins = reinterpret_cast<uint8_t*>(stage + a.fg * kRows * LO);
  const long long b0 = (r0 * a.F) & ~15ll;
  const long long b1 = (r0 + rows) * a.F, total = a.n * a.F;
  for (int i = tid; i < (int)((b1 - b0 + 15) / 16); i += kPlanesThreads) {
    const long long at = b0 + 16ll * i;
    cp_async16_n(sbins + 16 * i, a.bins + at,
                 (int)min(16ll, total - at));
  }
  // node, grad, hess, cnt: kRows each, 4 rows a chunk
  if (tid < 4 * (kRows / 4)) {
    const int col = tid / (kRows / 4), k = tid % (kRows / 4);
    const void* base = col == 0   ? (const void*)a.node
                       : col == 1 ? (const void*)a.grad
                       : col == 2 ? (const void*)a.hess
                                  : (const void*)a.cnt;
    if (base != nullptr) {
      const int valid = max(0, min(16, 4 * (rows - 4 * k)));
      const char* src = reinterpret_cast<const char*>(base) + 4 * r0;
      cp_async16_n(stage + a.fg * kRows * LO + a.bins_stage +
                       col * 4 * kRows + 16 * k,
                   valid ? src + 16 * k : src, valid);
    }
  }
}

// bf16(x) of two rows, the first in the lower half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the tile's tables, in the lanes' row order: a lane (g, q) takes rows
// 2q, 2q+1, 2q+8, 2q+9 of each 16-row step, and byte e of word
// [step * 4 + q] holds row {2q, 2q+1, 2q+8, 2q+9}[e].
//   hiT[fl * kRows / 4 + 4 * step + q]: hi of those rows at local feature
//     fl, bit 6 set where the row adds nothing (valid hi < 32, and every
//     byte stays below 0x80);
//   statT[(step * 4 + q) * 6 + 2 * s + {0, 1}]: bf16 stat s of rows
//     (2q, 2q+1) and (2q+8, 2q+9), packed.
template <int LO>
__device__ __forceinline__ void planes_prep(const PlanesArgs& a,
                                            const char* stage,
                                            long long tile, int f0,
                                            uint32_t* hiT, uint32_t* statT) {
  constexpr int kShift = LO == 16 ? 4 : 6;
  constexpr uint32_t kLow = LO == 16 ? 0x0f0f0f0fu : 0x03030303u;
  const long long r0 = tile * kRows;
  const int rows = (int)min((long long)kRows, a.n - r0);
  const uint8_t* sbins =
      reinterpret_cast<const uint8_t*>(stage + a.fg * kRows * LO);
  const char* srow = stage + a.fg * kRows * LO + a.bins_stage;
  const int32_t* snode = reinterpret_cast<const int32_t*>(srow);
  const float* sgrad = reinterpret_cast<const float*>(srow + 4 * kRows);
  const float* shess = reinterpret_cast<const float*>(srow + 8 * kRows);
  const float* scnt = reinterpret_cast<const float*>(srow + 12 * kRows);
  const long long b0 = (r0 * a.F) & ~15ll;
  constexpr int kSq = (kRows / 16) * 4;       // (step, q) pairs, 16
  const int hi_units = kSq * (a.fg / 4);      // x 4 features a word
  // byte x + (0x40 - W) has bit 6 set iff x >= W, i.e. bin >= B (x < 16)
  const uint32_t ge = (uint32_t)(0x40 - a.W) * 0x01010101u;
  for (int u = threadIdx.x; u < hi_units + kSq; u += kPlanesThreads) {
    const int sq = u < hi_units ? u % kSq : u - hi_units;
    const int q = sq % 4, step = sq / 4;
    int rr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rr[e] = 16 * step + 2 * q + (e & 1) + 8 * (e >> 1);
    if (u < hi_units) {
      const int j = u / kSq;                  // the word: features 4j..
      uint32_t nw = 0, w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rr[e];
        const int nd = snode[r];
        const bool ok = r < rows && nd >= 0 && nd < a.m;
        nw |= (ok ? (uint32_t)(nd * a.W) : 0x40u) << (8 * e);
        const uint8_t* p = sbins + ((r0 + r) * a.F + f0 + 4 * j - b0);
        if ((a.F & 3) == 0) {
          w[e] = *reinterpret_cast<const uint32_t*>(p);
        } else {
          w[e] = 0;
          for (int k = 0; k < 4; ++k)
            if (f0 + 4 * j + k < a.F) w[e] |= (uint32_t)p[k] << (8 * k);
        }
      }
      // 4 rows x 4 features -> 4 words of one feature's 4 rows
      const uint32_t t0 = prmt(w[0], w[1], 0x5140);
      const uint32_t t1 = prmt(w[0], w[1], 0x7362);
      const uint32_t t2 = prmt(w[2], w[3], 0x5140);
      const uint32_t t3 = prmt(w[2], w[3], 0x7362);
      const uint32_t fw[4] = {prmt(t0, t2, 0x5410), prmt(t0, t2, 0x7632),
                              prmt(t1, t3, 0x5410), prmt(t1, t3, 0x7632)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t x = (fw[k] >> kShift) & kLow;
        hiT[(4 * j + k) * (kRows / 4) + sq] =
            (x + nw) | ((x + ge) & 0x40404040u);
      }
    } else {
      float st[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rr[e];
        st[0][e] = sgrad[r];
        st[1][e] = shess[r];
        st[2][e] = a.cnt ? scnt[r] : 1.f;
      }
      uint32_t* out = statT + sq * 6;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        out[2 * s] = pack2(st[s][0], st[s][1]);
        out[2 * s + 1] = pack2(st[s][2], st[s][3]);
      }
    }
  }
}

template <int LO, int HT>
__global__ void __launch_bounds__(kPlanesThreads, HT <= 2 ? 2 : 1)
hist_planes_kernel(const PlanesArgs a) {
  constexpr int IPW = planes_items_per_warp(HT);
  constexpr int C = LO / 16;                  // items a feature
  char* smem = mma_sync::dyn_smem();
  // two sets of tables: the next tile's are written while this one's
  // are read
  uint32_t* tables =
      reinterpret_cast<uint32_t*>(smem + kStages * a.stage_bytes);
  const int table_words = a.fg * kRows / 4 + 6 * kRows / 4;
  const int f0 = blockIdx.x * a.fg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long n_tiles = (a.n + kRows - 1) / kRows;
  const long long stride = gridDim.y;
  // the conversion's constants, in registers (a.B >> 16 is 0: B <= 256)
  const uint32_t zero = (uint32_t)a.B >> 16;
  const Int8Cvt cvt = {0x007f007fu | zero, 0x00800080u | zero,
                       0x43004300u | zero, 0xc300c300u | zero};

  float tot[IPW][HT][3][4];
#pragma unroll
  for (int k = 0; k < IPW; ++k)
#pragma unroll
    for (int h = 0; h < HT; ++h)
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[k][h][s][e] = 0.f;
  // h of this lane's B-fragment column in each h-tile, in every byte
  uint32_t hcol[HT];
#pragma unroll
  for (int h = 0; h < HT; ++h) hcol[h] = (uint32_t)(8 * h + g) * 0x01010101u;

  // The ring: tile `it` of this block sits in stage it % kStages. In
  // iteration it the block waits for tile it + 1, refills the stage of
  // tile it - 1 with tile it + kStages - 1, writes tile it + 1's tables
  // and runs tile it's products: one barrier a tile, and the tables of
  // one tile are written while the products of the last run.
  const long long tile0 = blockIdx.y;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (tile0 + s * stride < n_tiles)
      planes_load<LO>(a, smem + s * a.stage_bytes, tile0 + s * stride, f0);
    mma_sync::cp_async_commit();
  }
  mma_sync::cp_async_wait<kStages - 2>();
  __syncthreads();
  if (tile0 < n_tiles)
    planes_prep<LO>(a, smem, tile0, f0, tables, tables + a.fg * kRows / 4);
  for (int it = 0; tile0 + it * stride < n_tiles; ++it) {
    const long long tile = tile0 + it * stride;
    mma_sync::cp_async_wait<kStages - 3>();
    __syncthreads();  // tile + 1 landed, tile's tables written, tile - 1
                      // done with
    const long long ahead = tile + (kStages - 1) * stride;
    if (ahead < n_tiles)
      planes_load<LO>(
          a, smem + ((it + kStages - 1) % kStages) * a.stage_bytes, ahead,
          f0);
    mma_sync::cp_async_commit();
    if (tile + stride < n_tiles) {
      uint32_t* next = tables + ((it + 1) & 1) * table_words;
      planes_prep<LO>(a, smem + ((it + 1) % kStages) * a.stage_bytes,
                      tile + stride, f0, next, next + a.fg * kRows / 4);
    }
    const char* stage = smem + (it % kStages) * a.stage_bytes;
    const uint32_t* hiT = tables + (it & 1) * table_words;
    const uint32_t* statT = hiT + a.fg * kRows / 4;

#pragma unroll
    for (int k = 0; k < IPW; ++k) {
      const int item = warp * IPW + k;
      const int fl = item / C, t = item % C;
      if (fl >= a.fg || f0 + fl >= a.F) continue;  // warp-uniform
      float d[HT][3][4];
#pragma unroll
      for (int h = 0; h < HT; ++h)
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[h][s][e] = 0.f;
      const int8_t* pl =
          reinterpret_cast<const int8_t*>(stage) + fl * kRows * LO;
#pragma unroll
      for (int p = 0; p < kRows / 32; ++p) {
        // matrices 0-3: rows 32p + 8i .. +7; lane l addresses row 32p + l
        const int r = 32 * p + lane;
        uint32_t R[4];
        mma_sync::ldsm_x4_t(R, pl + r * LO + 16 * (t ^ plan_swizzle<LO>(r)));
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const int step = 2 * p + sub;
          // A(M, K): M = g -> lo 16t + 2g, M = g + 8 -> lo 16t + 2g + 1;
          // K = row: R[2 sub] holds rows 2q, 2q+1, R[2 sub + 1] rows +8
          const uint32_t af[4] = {
              int8x2_to_bf16x2(R[2 * sub], cvt),
              int8x2_to_bf16x2(R[2 * sub] >> 8, cvt),
              int8x2_to_bf16x2(R[2 * sub + 1], cvt),
              int8x2_to_bf16x2(R[2 * sub + 1] >> 8, cvt)};
          const uint32_t hi4 = hiT[fl * (kRows / 4) + 4 * step + q];
          const uint2* st =
              reinterpret_cast<const uint2*>(statT + (step * 4 + q) * 6);
          const uint2 sv[3] = {st[0], st[1], st[2]};
#pragma unroll
          for (int h = 0; h < HT; ++h) {
            // bytes below 0x80 differ from this lane's h by x; x + 0x7f
            // has bit 7 set iff x != 0, i.e. the row is not at h
            const uint32_t ne = (hi4 ^ hcol[h]) + 0x7f7f7f7fu;
            const uint32_t m0 = prmt(ne, ne, 0x9988);  // rows 2q, 2q+1
            const uint32_t m1 = prmt(ne, ne, 0xbbaa);  // rows 2q+8, 2q+9
#pragma unroll
            for (int s = 0; s < 3; ++s) {
              const uint32_t bf[2] = {sv[s].x & ~m0, sv[s].y & ~m1};
              mma_sync::mma_bf16(d[h][s], af, bf);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < HT; ++h)
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[k][h][s][e] += d[h][s][e];
    }
  }
  mma_sync::cp_async_wait<0>();

  // D(M, N): d[e] at M = g + 8 (e >> 1), N = 2q + (e & 1); M -> lo, N -> h.
  // The fixed-order form adds each total as the integer rint(total *
  // scale): the warp's totals are summed in a fixed order, and integer
  // adds across row blocks give one result in any order.
  float* outs[3] = {a.hg, a.hh, a.hc};
  unsigned long long* qouts[3] = {a.qg, a.qh, a.qc};
  const bool fixed = a.qg != nullptr;
  const float qscale[3] = {fixed ? a.scale[0] : 0.f,
                           fixed ? a.scale[1] : 0.f,
                           fixed ? a.scale[2] : 0.f};
#pragma unroll
  for (int k = 0; k < IPW; ++k) {
    const int item = warp * IPW + k;
    const int fl = item / C, t = item % C;
    if (fl >= a.fg || f0 + fl >= a.F) continue;
#pragma unroll
    for (int h = 0; h < HT; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = 8 * h + 2 * q + (e & 1);
        if (hh >= a.n_hi) continue;
        const int nd = hh / a.W;
        const int bin = (hh - nd * a.W) * LO + 16 * t + 2 * g + (e >> 1);
        const long long o = ((long long)nd * a.F + f0 + fl) * a.B + bin;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          if (tot[k][h][s][e] == 0.f) continue;
          if (fixed)
            atomicAdd(qouts[s] + o, (unsigned long long)__float2ll_rn(
                                        tot[k][h][s][e] * qscale[s]));
          else
            atomicAdd(outs[s] + o, tot[k][h][s][e]);
        }
      }
  }
}

// hist_tile_kernel<cnt, fixed> as a function pointer
static const void* tile_fn(bool cnt, bool fixed) {
  if (fixed)
    return cnt ? reinterpret_cast<const void*>(hist_tile_kernel<true, true>)
               : reinterpret_cast<const void*>(hist_tile_kernel<false, true>);
  return cnt ? reinterpret_cast<const void*>(hist_tile_kernel<true, false>)
             : reinterpret_cast<const void*>(hist_tile_kernel<false, false>);
}

// Shared memory of a tiled block: 3 statistics x copies x mt x B x FP
// cells of 4 bytes (8 in the fixed-order form), then the warps' queues.
// `histogram_cuda.tile_smem` is the same formula.
static size_t tile_smem(int mt, int ft, int B, int copies, int threads,
                        bool fixed) {
  return 3ull * copies * mt * B * (32 * ((ft + 31) / 32)) *
             (fixed ? 8 : 4) +
         (threads / 32) * kQueue * sizeof(int);
}

template <bool kFixed>
static int tile_launch(const void* bins, const void* node, const void* grad,
                       const void* hess, const void* cnt, void* hg, void* hh,
                       void* hc, const void* scale, long long n, int F,
                       int m, int B, int mt, int ft, int copies, int threads,
                       int row_blocks, int vec, void* stream) {
  const size_t smem = tile_smem(mt, ft, B, copies, threads, kFixed);
  const int n_ftiles = (F + ft - 1) / ft;
  const dim3 grid(((m + mt - 1) / mt) * n_ftiles, row_blocks);
  cudaError_t e = cudaFuncSetAttribute(
      tile_fn(cnt != nullptr, kFixed),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cnt)
    hist_tile_kernel<true, kFixed><<<grid, threads, smem, st>>>(
        (const uint8_t*)bins, (const int32_t*)node, (const float*)grad,
        (const float*)hess, (const float*)cnt, hg, hh, hc,
        (const float*)scale, n, F, m, B, mt, ft, copies, n_ftiles, vec);
  else
    hist_tile_kernel<false, kFixed><<<grid, threads, smem, st>>>(
        (const uint8_t*)bins, (const int32_t*)node, (const float*)grad,
        (const float*)hess, nullptr, hg, hh, hc, (const float*)scale, n, F,
        m, B, mt, ft, copies, n_ftiles, vec);
  return (int)cudaGetLastError();
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
// (every row counts 1). Outputs (m, F, B) f32 must be zeroed by the
// caller. Returns a cudaError_t (0 = launched).
int hist_tile_launch(const void* bins, const void* node, const void* grad,
                     const void* hess, const void* cnt, void* hg, void* hh,
                     void* hc, long long n, int F, int m, int B, int mt,
                     int ft, int copies, int threads, int row_blocks,
                     int vec, void* stream) {
  return tile_launch<false>(bins, node, grad, hess, cnt, hg, hh, hc,
                            nullptr, n, F, m, B, mt, ft, copies, threads,
                            row_blocks, vec, stream);
}

// The fixed-order form of the same launch: outputs are (m, F, B) u64
// fixed-point sums, zeroed by the caller; `scale` holds three f32 powers
// of two on the device (grad, hess, count), the factor each statistic is
// rounded to an integer at. Returns a cudaError_t.
int hist_tile_fixed_launch(const void* bins, const void* node,
                           const void* grad, const void* hess,
                           const void* cnt, void* qg, void* qh, void* qc,
                           const void* scale, long long n, int F, int m,
                           int B, int mt, int ft, int copies, int threads,
                           int row_blocks, int vec, void* stream) {
  return tile_launch<true>(bins, node, grad, hess, cnt, qg, qh, qc, scale,
                           n, F, m, B, mt, ft, copies, threads, row_blocks,
                           vec, stream);
}

// How many blocks of hist_tile_kernel<cnt != 0, fixed != 0> with
// `threads` threads and `smem` bytes of shared memory fit one SM of the
// current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns
// a cudaError_t.
int hist_tile_occupancy(int cnt, int fixed, int threads, int smem,
                        int* blocks_per_sm) {
  const void* fn = tile_fn(cnt != 0, fixed != 0);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads, smem);
}

// Shared memory of a hist_planes_kernel block of fg features: kStages
// stages of (fg x kRows x LO plan bytes, the tile's bins rows, node and
// three stats), then two sets of hi and stats tables. `histogram_cuda.
// planes_smem` is the same formula.
static void planes_geometry(int F, int LO, int fg, int* bins_stage,
                            int* stage_bytes, int* smem) {
  *bins_stage = ((kRows * F + fg + 32 + 15) / 16) * 16;
  *stage_bytes = fg * kRows * LO + *bins_stage + 16 * kRows;
  *smem = kStages * *stage_bytes + 2 * (fg * kRows + 6 * kRows);
}

// hist_planes_kernel<LO, HT>, instantiated for LO = 16 at HT 1-4 and
// LO = 64 at HT 1-2 (m * B / LO <= 16 there), else null
static const void* planes_fn(int lo, int ht) {
  if (lo == 16) {
    switch (ht) {
      case 1: return reinterpret_cast<const void*>(hist_planes_kernel<16, 1>);
      case 2: return reinterpret_cast<const void*>(hist_planes_kernel<16, 2>);
      case 3: return reinterpret_cast<const void*>(hist_planes_kernel<16, 3>);
      case 4: return reinterpret_cast<const void*>(hist_planes_kernel<16, 4>);
    }
  } else if (lo == 64) {
    switch (ht) {
      case 1: return reinterpret_cast<const void*>(hist_planes_kernel<64, 1>);
      case 2: return reinterpret_cast<const void*>(hist_planes_kernel<64, 2>);
    }
  }
  return nullptr;
}

// launch hist_planes_kernel<LO, ht> for `a` (its dimensions, operands
// and outputs set); cudaErrorInvalidValue for arguments it does not take
static int planes_launch(PlanesArgs a, int LO, int ht, int row_blocks,
                         void* stream) {
  const void* fn = planes_fn(LO, ht);
  if (fn == nullptr || a.B % LO != 0 || a.fg < 4 || a.fg % 4 != 0)
    return (int)cudaErrorInvalidValue;
  a.W = a.B / LO;
  a.n_hi = a.m * a.W;
  if (a.n_hi > 8 * ht) return (int)cudaErrorInvalidValue;
  int smem;
  planes_geometry(a.F, LO, a.fg, &a.bins_stage, &a.stage_bytes, &smem);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.F + a.fg - 1) / a.fg, row_blocks);
  const cudaStream_t st = (cudaStream_t)stream;
#define HIST_PLANES_LAUNCH(lo, ht)                                      \
  hist_planes_kernel<lo, ht><<<grid, kPlanesThreads, smem, st>>>(a)
  if (LO == 16 && ht == 1) HIST_PLANES_LAUNCH(16, 1);
  if (LO == 16 && ht == 2) HIST_PLANES_LAUNCH(16, 2);
  if (LO == 16 && ht == 3) HIST_PLANES_LAUNCH(16, 3);
  if (LO == 16 && ht == 4) HIST_PLANES_LAUNCH(16, 4);
  if (LO == 64 && ht == 1) HIST_PLANES_LAUNCH(64, 1);
  if (LO == 64 && ht == 2) HIST_PLANES_LAUNCH(64, 2);
#undef HIST_PLANES_LAUNCH
  return (int)cudaGetLastError();
}

// The planes kernel: a grid of (ceil(F / fg) feature groups, row_blocks)
// blocks of kPlanesThreads threads. plan: (F, n, LO) int8; every operand
// 16-byte aligned; LO in {16, 64} with LO | B; ht h-tiles of 8 with
// m * B / LO <= 8 * ht <= 32; fg a multiple of 4. cnt may be null (every
// row counts 1). Outputs must be zeroed by the caller. Returns a
// cudaError_t (0 = launched), cudaErrorInvalidValue for arguments the
// kernel does not take.
int hist_planes_launch(const void* plan, const void* bins, const void* node,
                       const void* grad, const void* hess, const void* cnt,
                       void* hg, void* hh, void* hc, long long n, int F,
                       int m, int B, int LO, int ht, int fg, int row_blocks,
                       void* stream) {
  const PlanesArgs a = {(const int8_t*)plan, (const uint8_t*)bins,
                        (const int32_t*)node, (const float*)grad,
                        (const float*)hess, (const float*)cnt, (float*)hg,
                        (float*)hh, (float*)hc, nullptr, nullptr, nullptr,
                        nullptr, n, F, m, B, 0, 0, fg, 0, 0};
  return planes_launch(a, LO, ht, row_blocks, stream);
}

// The fixed-order form of the same launch: outputs are (m, F, B) u64
// fixed-point sums, zeroed by the caller, and `scale` holds three f32
// powers of two on the device (grad, hess, count).
int hist_planes_fixed_launch(const void* plan, const void* bins,
                             const void* node, const void* grad,
                             const void* hess, const void* cnt, void* qg,
                             void* qh, void* qc, const void* scale,
                             long long n, int F, int m, int B, int LO,
                             int ht, int fg, int row_blocks, void* stream) {
  const PlanesArgs a = {(const int8_t*)plan, (const uint8_t*)bins,
                        (const int32_t*)node, (const float*)grad,
                        (const float*)hess, (const float*)cnt, nullptr,
                        nullptr, nullptr, (unsigned long long*)qg,
                        (unsigned long long*)qh, (unsigned long long*)qc,
                        (const float*)scale, n, F, m, B, 0, 0, fg, 0, 0};
  return planes_launch(a, LO, ht, row_blocks, stream);
}

// The shared memory of a planes block (F features, digit LO, fg features
// a block) and how many such blocks of hist_planes_kernel<LO, ht> fit one SM
// of the current device. Returns a cudaError_t.
int hist_planes_occupancy(int ht, int F, int LO, int fg, int* smem,
                          int* blocks_per_sm) {
  const void* fn = planes_fn(LO, ht);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int bins_stage, stage_bytes;
  planes_geometry(F, LO, fg, &bins_stage, &stage_bytes, smem);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kPlanesThreads, *smem);
}

}  // extern "C"
