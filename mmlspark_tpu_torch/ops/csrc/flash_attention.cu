// Flash-attention forward for Hopper (sm_90a).
//
// WHAT IT COMPUTES
//   For each head h and query row i (q, k, v in the public (S, H, D) layout,
//   read through their strides; Sk may differ from Sq), with the blocks'
//   global positions q_off + i and k_off + j:
//     s[i, j] = (q[i] * scale) . k[j]           scores, f32
//     s[i, j] = -1e30 where j >= Sk, or causal and q_off + i < k_off + j
//               (top-left aligned when Sq != Sk and the offsets are 0)
//   and, with m_i the row max and l_i = sum_j exp(s[i, j] - m_i), one of two
//   forms (a template flag, as the reference's `normalize`):
//   normalized (kNorm = true; offsets 0):
//     o[i]    = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)   in q's type
//     lse[i]  = m_i + log(max(l_i, 1e-30))                         f32
//     the contract of flash_attention.py::_flash_forward_lse_plain;
//   stats (kNorm = false), one (q shard, kv shard) pair of ring attention:
//     acc[i]  = sum_j exp(s[i, j] - m_i) v[j]   unnormalized, f32
//     m[i], l[i]                                 f32
//     the contract of flash_attention.py::_flash_stats_plain.
//
// WHICH TPU KERNEL IT REPLACES
//   mmlspark_tpu/ops/flash_attention.py::_flash_kernel (:87) in both forms:
//   normalized, as _flash_forward_lse launches it (pallas_call :417), and
//   stats (normalize=False, q_offset/k_offset from SMEM), as
//   _flash_stats_forward launches it (pallas_call :373).
//   The TPU walks a sequential k grid axis carrying (m, l, acc) in VMEM
//   scratch; here one block owns a (64 query rows, head) tile and loops over
//   the k tiles itself, so nothing carries between blocks. The reference's
//   moveaxis and block padding copies are gone: tiles are read through the
//   strides and the ragged edges are masked.
//
// ROUNDING POINTS (kept from the reference)
//   q is scaled in its own type (q * T(scale), rounded to T, :122); scores,
//   the softmax and both accumulators are f32; p is rounded to v's type
//   before the PV product (:158) while l sums the unrounded p. For f32 the
//   roundings are the identity.
//
// MASKING AND SKIPPING (kept from the reference, :103-152)
//   Masked scores are -1e30, not -inf. A k tile wholly above the global
//   diagonal (k_off + k0 > q_off + q0 + 63) is skipped; a tile needing no
//   mask (every key < Sk and, causal, every key at or below every row of the
//   block) takes the maskless branch. A masked entry of a row that has seen
//   a visible key contributes exp(-1e30 - m) = 0. On the normalized path
//   every row sees one (causal row i sees key 0). In the stats form a row
//   may see none: when every tile of its block is skipped (a kv shard wholly
//   after the q shard) it keeps its initial acc = 0, l = 0, m = -1e30. When
//   a computed tile masks all of its keys (offsets off the 64-key grid):
//   - the bf16 kernel takes 0 in place of such a row's max in the exponent,
//     so its p = exp(-1e30) = 0 and the row ends acc = 0, l = 0, m = -1e30,
//     as in the plain version;
//   - the f32 kernel leaves p unmasked: the row carries finite garbage
//     (p = 1 on masked keys) until a visible key resets it through
//     alpha = 0, and a row that never sees one ends flagged by m == -1e30,
//     which the ring merge weighs with exp(-1e30 - m_new) = 0.
//   Every output stays finite. Rows past Sq are computed on zeros and never
//   written.
//
// WHAT BOUNDS IT
//   Operations: 4 * Sq * Sk * D * H FLOPs (half of that causal) against
//   ~256 MB of q/k/v/o at S=16384, H=8, D=128 in f32 -- 16.4 ms at the
//   H100's 67 TFLOP/s f32 rate, 1.11 ms at its 989 TFLOP/s bf16 tensor-core
//   rate, against 0.08 ms for the bytes.
//
// TWO DESIGNS, BY DTYPE CODE
//   bf16 (code 1) runs both products on the tensor cores: flash_fwd_mma.
//   f32 (code 0) stays on the CUDA cores in f32 FMAs (flash_fwd_f32): TF32
//   keeps 10 mantissa bits and cannot meet the f32 limit.
//
// THE TENSOR-CORE KERNEL (bf16)
//   Block: 128 threads, 4 warps; warp w owns query rows 16w..16w+15 of the
//   block's 64, so a row's max and sum reduce over the 4 lanes of a quad
//   (shuffles 1 and 2) and no warp waits on another between the products.
//   Tiles of 64 keys. Products: mma.sync.m16n8k16, bf16 in, f32 accumulate
//   (mma_frag.cuh); wgmma with TMA is later work (ROADMAP Queue 2 K2b).
//   - q * T(scale), rounded to bf16, is loaded once and held in registers
//     as the A fragments of S = q.K^T for the whole loop (D/4 registers).
//   - K and V tiles stream through shared memory with cp.async in two
//     stages (the next tile loads while this one computes), zero-filled
//     past Sk, stored row-major in bf16 with 8 elements of padding per row
//     (rows 16 bytes apart mod 128: ldmatrix's 8-row phases hit 8 distinct
//     bank groups). K is read with ldmatrix, V with ldmatrix.trans. q is
//     staged in the second stage's K buffer before the loop.
//   - S (16 rows x 64 keys a warp, 32 f32 a thread) accumulates each
//     16-deep chunk in the tensor core. The product of two bf16 values is
//     exact in f32, so S differs from the plain version's only in the
//     order of its f32 sums. The mask runs on boundary tiles only.
//   - Online softmax in f32: p = 2^(s log2(e) - m log2(e)) (one FMA and
//     one exp2 each), alpha = 2^((m_old - m_new) log2(e)); l sums the
//     unrounded p; p is rounded to bf16 against the tile's running max.
//   - P never leaves the registers: the f32 accumulator of two m16n8 score
//     tiles, packed in bf16 pairs, is the A fragment of one m16n8k16 of
//     the PV product. O (D/2 f32 a thread) is rescaled by alpha each tile.
//   - Causal: the q blocks with the most key tiles launch first, so the
//     grid's tail is short.
//   Shared memory: 4 tiles of 64 x (D + 8) bf16, 69,632 B at D=128.
//
// THE F32 KERNEL (code 0)
//   Block: 128 threads = 16 row groups of 8 lanes; a group owns 4 query
//   rows. Tile: 64 query rows x 64 keys: shared memory holds q^T (D x 64),
//   k^T (D x 64), v (64 x D) and p (64 x 64) in f32, 112 KB at D=128, so
//   two blocks fit one SM. Lane c of a group holds keys {4c..4c+3,
//   32+4c..32+4c+3} of its rows' scores (conflict-free float4 reads of
//   k^T) and columns {4(c+8j)..} of the accumulator, so D is split across
//   the lanes and no thread holds a whole row. Row maxima and sums are
//   reduced over the 8 lanes with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_frag.cuh"

namespace {

using namespace mma_sync;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr float kMask = -1e30f;
// threads per block, both kernels: 16 row groups of 8 lanes (f32), 4 warps
// of 16 query rows (bf16)
constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// f32 (code 0): the CUDA-core kernel

constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = 8;       // keys per thread in a score tile

// 16 bytes as four floats
__device__ __forceinline__ void unpack(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// the key index within the tile of slot j of lane c
__device__ __forceinline__ int key_of(int c, int j) {
  return (j < 4 ? 4 * c : 32 + 4 * c) + (j & 3);
}

// kNorm: o is the normalized output and r0 the lse; otherwise o is the
// accumulator, r0 the row max m and r1 the row sum l
template <int D, bool kNorm>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ r0, float* __restrict__ r1, int Sq, int Sk,
              long long q_ss, long long q_hs, long long k_ss, long long k_hs,
              long long v_ss, long long v_hs, long long o_ss, long long o_hs,
              float scale, int causal, int q_off, int k_off) {
  constexpr int kVec = 4;                  // floats per 16-byte load
  constexpr int kChunks = D / kVec;        // 16-byte loads per row
  constexpr int kCols = D / 4;             // float4 columns of a row
  constexpr int kJJ = (kCols + 7) / 8;     // float4 columns per lane

  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kBQ], q * scale
  float* Kt = Qt + D * kBQ;                     // [D][kBK]
  float* Vs = Kt + D * kBK;                     // [kBK][D]
  float* Ps = Vs + kBK * D;                     // [kBQ][kBK]

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x;
  const int rg = t >> 3;  // rows 4rg .. 4rg+3 of the block
  const int c = t & 7;    // lane within the row group

  // q tile, scaled, transposed; a warp covers 32 rows of one chunk so the
  // transposing stores are conflict-free
  for (int idx = t; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx % kBQ, ch = idx / kBQ;
    float f[kVec] = {};
    if (q0 + r < Sq)
      unpack(*reinterpret_cast<const uint4*>(q + (q0 + r) * q_ss + h * q_hs +
                                             ch * kVec),
             f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) Qt[(ch * kVec + e) * kBQ + r] = f[e] * scale;
  }

  float m_i[kRows], l_i[kRows];
  float4 acc[kRows][kJJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kMask;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kJJ; ++jj) acc[i][jj] = make_float4(0, 0, 0, 0);
  }

  const int n_k = (Sk + kBK - 1) / kBK;
  // global q position minus global k position at local (0, 0): causal
  // keeps local (i, j) with i + delta >= j
  const int delta = q_off - k_off;
  // causal: tiles wholly above the global diagonal of this block are
  // skipped; none is left when the kv shard lies wholly after the block
  int kb_end = n_k;
  if (causal) {
    const int last = q0 + kBQ - 1 + delta;  // the block's last visible key
    kb_end = last < 0 ? 0 : min(n_k, last / kBK + 1);
  }
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's k^T, v and p are consumed
    for (int idx = t; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx % kBK, ch = idx / kBK;
      float f[kVec] = {};
      if (k0 + r < Sk)
        unpack(*reinterpret_cast<const uint4*>(k + (k0 + r) * k_ss + h * k_hs +
                                               ch * kVec),
               f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) Kt[(ch * kVec + e) * kBK + r] = f[e];
    }
    for (int idx = t; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx % kChunks;
      float f[kVec] = {};
      if (k0 + r < Sk)
        unpack(*reinterpret_cast<const uint4*>(v + (k0 + r) * v_ss + h * v_hs +
                                               ch * kVec),
               f);
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(Vs + r * D + ch * kVec + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    __syncthreads();

    // scores: 4 rows x 8 keys per thread
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(Qt + d * kBQ + 4 * rg);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * kBK + 4 * c);
      const float4 kc =
          *reinterpret_cast<const float4*>(Kt + d * kBK + 32 + 4 * c);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[kKeys] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    const bool full =
        (k0 + kBK <= Sk) && (!causal || k0 + kBK - 1 <= q0 + delta);
    if (!full) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int kpos = k0 + key_of(c, j);
          const int qpos = q0 + 4 * rg + i;
          const bool valid = kpos < Sk && (!causal || qpos + delta >= kpos);
          if (!valid) s[i][j] = kMask;
        }
    }

    // online softmax; l is kept per lane and summed over the group at the end
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mb = s[i][0];
#pragma unroll
      for (int j = 1; j < kKeys; ++j) mb = fmaxf(mb, s[i][j]);
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 4));
      const float mn = fmaxf(m_i[i], mb);
      const float alpha = expf(m_i[i] - mn);
      float ps = 0.f, pr[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        pr[j] = p;
      }
      l_i[i] = l_i[i] * alpha + ps;
      m_i[i] = mn;
#pragma unroll
      for (int jj = 0; jj < kJJ; ++jj) {
        acc[i][jj].x *= alpha;
        acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha;
        acc[i][jj].w *= alpha;
      }
      float* prow = Ps + (4 * rg + i) * kBK;
      *reinterpret_cast<float4*>(prow + 4 * c) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
      *reinterpret_cast<float4*>(prow + 32 + 4 * c) =
          make_float4(pr[4], pr[5], pr[6], pr[7]);
    }
    __syncthreads();

    // acc += p . v: 4 rows x kJJ float4 columns per thread
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (4 * rg + i) * kBK + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jj = 0; jj < kJJ; ++jj) {
          const int col = c + 8 * jj;
          if (kCols % 8 != 0 && col >= kCols) continue;
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (kk + e) * D + 4 * col);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float pe = e == 0 ? p4[i].x
                           : e == 1 ? p4[i].y
                           : e == 2 ? p4[i].z
                                    : p4[i].w;
            acc[i][jj].x = fmaf(pe, vv.x, acc[i][jj].x);
            acc[i][jj].y = fmaf(pe, vv.y, acc[i][jj].y);
            acc[i][jj].z = fmaf(pe, vv.z, acc[i][jj].z);
            acc[i][jj].w = fmaf(pe, vv.w, acc[i][jj].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + 4 * rg + i;
    if (row >= Sq) continue;
    const long long r = h * (long long)Sq + row;
    auto* orow = o + row * o_ss + h * o_hs;
    if constexpr (kNorm) {
      const float den = fmaxf(l, 1e-30f);
      if (c == 0) r0[r] = m_i[i] + logf(den);
#pragma unroll
      for (int jj = 0; jj < kJJ; ++jj) {
        const int col = c + 8 * jj;
        if (kCols % 8 != 0 && col >= kCols) continue;
        orow[4 * col] = acc[i][jj].x / den;
        orow[4 * col + 1] = acc[i][jj].y / den;
        orow[4 * col + 2] = acc[i][jj].z / den;
        orow[4 * col + 3] = acc[i][jj].w / den;
      }
    } else {
      if (c == 0) {
        r0[r] = m_i[i];
        r1[r] = l;
      }
#pragma unroll
      for (int jj = 0; jj < kJJ; ++jj) {
        const int col = c + 8 * jj;
        if (kCols % 8 != 0 && col >= kCols) continue;
        orow[4 * col] = acc[i][jj].x;
        orow[4 * col + 1] = acc[i][jj].y;
        orow[4 * col + 2] = acc[i][jj].z;
        orow[4 * col + 3] = acc[i][jj].w;
      }
    }
  }
}

template <int D>
constexpr size_t f32_smem() {
  return sizeof(float) * (size_t)(D * kBQ + D * kBK + kBK * D + kBQ * kBK);
}

// ---------------------------------------------------------------------------
// bf16 (code 1): the tensor-core kernel

constexpr float kLog2e = 1.4426950408889634f;

// padded row stride of a [64][D] bf16 tile, in elements
template <int D>
__host__ __device__ constexpr int ld_h() { return D + 8; }

// K and V, two stages each (q is staged in the second K buffer)
template <int D>
constexpr size_t mma_smem() {
  return (size_t)4 * kBK * ld_h<D>() * sizeof(bf16);
}

// rows [r0, r0 + 64) of an (S, H, D) bf16 tensor (x already at its head)
// into a [64][D + 8] tile, asynchronously; rows past n are zeros
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* __restrict__ x,
                                        int r0, int n, long long ss) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool in = r0 + r < n;
    cp_async16(dst + r * ld_h<D>() + ch * 8,
               in ? x + (r0 + r) * ss + ch * 8 : x, in);
  }
}

// kNorm: o is the normalized output in bf16 and r0 the lse; otherwise o is
// the f32 accumulator, r0 the row max m and r1 the row sum l
template <int D, bool kNorm>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v,
              std::conditional_t<kNorm, bf16, float>* __restrict__ o,
              float* __restrict__ r0, float* __restrict__ r1, int Sq, int Sk,
              long long q_ss, long long q_hs, long long k_ss, long long k_hs,
              long long v_ss, long long v_hs, long long o_ss, long long o_hs,
              float scale, int causal, int q_off, int k_off) {
  constexpr int LD = ld_h<D>();
  constexpr int kKT = D / 16;  // 16-deep chunks of s = q.K^T
  constexpr int kNT = D / 8;   // n-tiles of the accumulator
  bf16* KV = reinterpret_cast<bf16*>(dyn_smem());  // 2 stages x {K, V}

  const int h = blockIdx.y;
  // the longest causal rows first: the last query tile has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  const int m0 = 16 * (threadIdx.x >> 5);  // the warp's rows
  const bf16* kh = k + h * k_hs;
  const bf16* vh = v + h * v_hs;

  const int n_k = (Sk + kBK - 1) / kBK;
  // global q position minus global k position at local (0, 0): causal
  // keeps local (i, j) with i + delta >= j
  const int delta = q_off - k_off;
  // causal: tiles wholly above the global diagonal of this block are
  // skipped; none is left when the kv shard lies wholly after the block
  int kb_end = n_k;
  if (causal) {
    const int last = q0 + kBQ - 1 + delta;  // the block's last visible key
    kb_end = last < 0 ? 0 : min(n_k, last / kBK + 1);
  }

  // rows m0 + g (i = 0) and m0 + g + 8 (i = 1): the running max, this
  // thread's part of the running sum and of the accumulator, whose n-tile
  // j holds columns 8j + c, 8j + c + 1 of both rows (mma_sync.cuh)
  float m_i[2] = {kMask, kMask}, l_i[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  uint32_t qa[kKT][4];  // A fragments of T(q * T(scale)), rows m0..m0+15
  if (kb_end > 0) {
    bf16* Qs = KV + 2 * kBK * LD;  // the second stage's K, until the loop
    cp_tile<D>(Qs, q + h * q_hs, q0, Sq, q_ss);
    cp_tile<D>(KV, kh, 0, Sk, k_ss);
    cp_tile<D>(KV + kBK * LD, vh, 0, Sk, v_ss);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      lda(qa[kt], Qs, LD, m0, 16 * kt);
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kt][i] = scale_bf16x2(qa[kt][i], scale_t);
    }
    __syncthreads();  // every warp holds its q: the second stage is free
  }

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    const bf16* Ks = KV + (kb & 1) * 2 * kBK * LD;
    const bf16* Vs = Ks + kBK * LD;
    if (kb + 1 < kb_end) {  // the next tile into the other stage
      bf16* nxt = KV + ((kb + 1) & 1) * 2 * kBK * LD;
      cp_tile<D>(nxt, kh, k0 + kBK, Sk, k_ss);
      cp_tile<D>(nxt + kBK * LD, vh, k0 + kBK, Sk, v_ss);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile is in

    // s: the warp's 16 rows x 64 keys, n-tile j = keys 8j..8j+7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[2][2];
        ldb_nk(b, Ks, LD, 8 * j, 16 * kt);
        mma_bf16(s[j], qa[kt], b[0]);
        mma_bf16(s[j + 1], qa[kt], b[1]);
      }
    }
    const bool full =
        (k0 + kBK <= Sk) && (!causal || k0 + kBK - 1 <= q0 + delta);
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + c + (e & 1);
          const int row = q0 + m0 + g + 8 * (e >> 1);
          if (key >= Sk || (causal && row + delta < key)) s[j][e] = kMask;
        }
    }

    // online softmax. A row whose max is still the mask (no visible key
    // yet) takes 0 in place of its max in the exponent: its p are then
    // 2^(-1e30 log2 e) = 0, not 1.
    float alpha[2], mb2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mb = fmaxf(s[0][2 * i], s[0][2 * i + 1]);
#pragma unroll
      for (int j = 1; j < 8; ++j)
        mb = fmaxf(mb, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float mn = fmaxf(m_i[i], mb);
      alpha[i] = exp2f((m_i[i] - mn) * kLog2e);
      m_i[i] = mn;
      mb2[i] = mn == kMask ? 0.f : mn * kLog2e;
    }
    // p in f32 into l; rounded to bf16, the score tiles 2t and 2t + 1 are
    // the A fragment of keys 16t..16t+15 for the PV product
    uint32_t pa[4][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* sv = s[2 * t + hf] + 2 * i;
          const float p0 = exp2f(fmaf(sv[0], kLog2e, -mb2[i]));
          const float p1 = exp2f(fmaf(sv[1], kLog2e, -mb2[i]));
          ps[i] += p0;
          ps[i] += p1;
          pa[t][2 * hf + i] = pack_bf16(p0, p1);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + ps[i];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[2][2];
        ldb_kn(b, Vs, LD, 8 * j, 16 * t);
        mma_bf16(acc[j], pa[t], b[0]);
        mma_bf16(acc[j + 1], pa[t], b[1]);
      }
    }
    __syncthreads();  // this stage is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + m0 + g + 8 * i;
    if (row >= Sq) continue;
    const long long r = h * (long long)Sq + row;
    if constexpr (kNorm) {
      const float den = fmaxf(l, 1e-30f);
      if ((lane & 3) == 0) r0[r] = m_i[i] + logf(den);
      bf16* out = o + row * o_ss + h * o_hs + c;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    } else {
      if ((lane & 3) == 0) {
        r0[r] = m_i[i];
        r1[r] = l;
      }
      float* out = o + row * o_ss + h * o_hs + c;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// the kernel of (dtype code, D, form) and its dynamic shared memory
template <int kCode, int D, bool kNorm>
const void* kernel_of(size_t* smem) {
  if constexpr (kCode == 0) {
    *smem = f32_smem<D>();
    return reinterpret_cast<const void*>(flash_fwd_f32<D, kNorm>);
  } else {
    *smem = mma_smem<D>();
    return reinterpret_cast<const void*>(flash_fwd_mma<D, kNorm>);
  }
}

template <int kCode, int D, bool kNorm>
int launch(const void* q, const void* k, const void* v, void* o, void* r0,
           void* r1, int Sq, int Sk, int H, const long long* st, float scale,
           int causal, int q_off, int k_off, cudaStream_t stream) {
  size_t smem;
  const void* fn = kernel_of<kCode, D, kNorm>(&smem);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H);
  if constexpr (kCode == 0) {
    flash_fwd_f32<D, kNorm><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)r0, (float*)r1, Sq, Sk, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], scale, causal, q_off, k_off);
  } else {
    using OutT = std::conditional_t<kNorm, bf16, float>;
    flash_fwd_mma<D, kNorm><<<grid, kThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (OutT*)o,
        (float*)r0, (float*)r1, Sq, Sk, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], scale, causal, q_off, k_off);
  }
  return (int)cudaGetLastError();
}

template <bool kNorm>
int launch_dt(int dtype, int D, const void* q, const void* k, const void* v,
              void* o, void* r0, void* r1, int Sq, int Sk, int H,
              const long long* st, float scale, int causal, int q_off,
              int k_off, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CASE(CC, DD)                                                       \
  if (dtype == CC && D == DD)                                              \
    return launch<CC, DD, kNorm>(q, k, v, o, r0, r1, Sq, Sk, H, st, scale, \
                                 causal, q_off, k_off, s);
#define CASES(DD) CASE(0, DD) CASE(1, DD)
  CASES(16) CASES(32) CASES(64) CASES(128)
#undef CASES
#undef CASE
  return (int)cudaErrorInvalidValue;
}

template <bool kNorm>
const void* kernel_at(int dtype, int D, size_t* smem) {
#define CASE(CC, DD) \
  if (dtype == CC && D == DD) return kernel_of<CC, DD, kNorm>(smem);
#define CASES(DD) CASE(0, DD) CASE(1, DD)
  CASES(16) CASES(32) CASES(64) CASES(128)
#undef CASES
#undef CASE
  return nullptr;
}

}  // namespace

extern "C" {

// q (Sq, H, D), k/v (Sk, H, D), o (Sq, H, D) of one type (dtype 0 = f32,
// 1 = bf16), each with unit stride along D and 16-byte aligned rows;
// strides in elements: {q_seq, q_head, k_seq, k_head, v_seq, v_head,
// o_seq, o_head}. lse is (H, Sq) f32, contiguous. D in {16, 32, 64, 128}.
// Returns a cudaError_t (0 = launched).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int Sq, int Sk, int H, int D, int dtype,
                     long long q_ss, long long q_hs, long long k_ss,
                     long long k_hs, long long v_ss, long long v_hs,
                     long long o_ss, long long o_hs, float scale, int causal,
                     void* stream) {
  const long long st[8] = {q_ss, q_hs, k_ss, k_hs, v_ss, v_hs, o_ss, o_hs};
  return launch_dt<true>(dtype, D, q, k, v, o, lse, nullptr, Sq, Sk, H, st,
                         scale, causal, 0, 0, stream);
}

// The stats form: q, k, v as above; acc (Sq, H, D) f32 with unit stride
// along D and 16-byte aligned rows (strides {acc_seq, acc_head} in place of
// o's); m and l (H, Sq) f32, contiguous; q_off and k_off the blocks' global
// positions. Returns a cudaError_t (0 = launched).
int flash_stats_fwd_launch(const void* q, const void* k, const void* v,
                           void* acc, void* m, void* l, int Sq, int Sk,
                           int H, int D, int dtype, long long q_ss,
                           long long q_hs, long long k_ss, long long k_hs,
                           long long v_ss, long long v_hs, long long a_ss,
                           long long a_hs, float scale, int causal,
                           int q_off, int k_off, void* stream) {
  const long long st[8] = {q_ss, q_hs, k_ss, k_hs, v_ss, v_hs, a_ss, a_hs};
  return launch_dt<false>(dtype, D, q, k, v, acc, m, l, Sq, Sk, H, st, scale,
                          causal, q_off, k_off, stream);
}

// The normalized (norm = 1) or stats kernel of (dtype, D): its registers per
// thread, its dynamic shared memory per block and how many of its blocks
// fit one SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
int flash_fwd_occupancy(int norm, int dtype, int D, int* regs,
                        int* smem_bytes, int* blocks_per_sm) {
  size_t smem = 0;
  const void* fn = norm ? kernel_at<true>(dtype, D, &smem)
                        : kernel_at<false>(dtype, D, &smem);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, smem);
}

}  // extern "C"
