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
//   a computed tile masks all of its keys (offsets off the key grid), both
//   kernels take 0 in place of such a row's max in the exponent, so its
//   p = exp(-1e30) = 0 and the row ends acc = 0, l = 0, m = -1e30, as in
//   the plain version.
//   Every output stays finite. Rows past Sq are computed on zeros and never
//   written.
//
// WHAT BOUNDS IT
//   Operations: 4 * Sq * Sk * D * H FLOPs (half of that causal) against
//   ~256 MB of q/k/v/o at S=16384, H=8, D=128 in f32 -- 1.11 ms at the
//   H100's 989 TFLOP/s bf16 tensor-core rate, against 0.08 ms for the
//   bytes. In f32 every product takes six bf16 tensor-core products (below):
//   6.67 ms at that rate, against 16.4 ms at the 67 TFLOP/s of f32 FMAs.
//
// TWO DESIGNS, BY DTYPE CODE
//   Both run both products on the tensor cores (mma.sync.m16n8k16, bf16 in,
//   f32 accumulate; mma_frag.cuh).
//   bf16 (code 1): flash_fwd_mma.
//   f32 (code 0): flash_fwd_split3, every f32 operand as three bf16 terms
//   (TF32 keeps 10 mantissa bits and cannot meet the f32 limit; three bf16
//   terms carry 24).
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
//   flash_fwd_mma's block (4 warps of 16 query rows, 64 rows a block), its
//   masking, skipping and longest-rows-first order, with:
//   - Three-term operands (split3, mma_frag.cuh): hi = bf16(x), mid =
//     bf16(x - hi), lo = bf16(x - hi - mid), which sum to x exactly for
//     normal x. q * scale (rounded in f32, as the reference scales it), K,
//     V and the unrounded p are split; each product takes the six cross
//     products whose terms' ranks sum to at most 2, smallest first
//     (mma_x6): what is dropped is ~2^-24 of each term, as f32 rounding.
//   - Fresh accumulators. An mma aligns its accumulator input with the
//     products and truncates what falls below 24 bits, so a sum chained
//     through one loses up to an ulp a step, always toward zero. S takes a
//     fresh accumulator every 16-deep step, added to S in f32; each tile's
//     P.V takes one (by chunks of 64 columns), added to the alpha-rescaled
//     O in f32 with one FMA (O chained through the tensor cores over 512
//     tiles would drift ~1e-5 relative, too close to the f32 limit).
//     tests/test_torch_flash_fwd_f32_split.py rehearses this order.
//   - Shared memory holds three bf16 planes of each tile, row-major with 8
//     elements of padding, so ldmatrix feeds every term as in the bf16
//     kernel: q * scale (64 rows, loaded and split once), K and V (32 keys
//     a tile, split as they land: global loads into registers, then one
//     splitting pass). 104,448 B at D=128, so two blocks share an SM and
//     one block's loads overlap the other's products. Tiles of 64 keys
//     would take 156,672 B and one block per SM.
//   - Softmax and l in f32 with expf: p is never rounded (T is the
//     identity); its three terms are the A fragments of the P.V product,
//     straight from the score registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_frag.cuh"

namespace {

using namespace mma_sync;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile of the bf16 kernel
constexpr float kMask = -1e30f;
// threads per block, both kernels: 4 warps of 16 query rows
constexpr int kThreads = 128;

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
// f32 (code 0): the tensor-core kernel with three-term bf16 operands

constexpr int kBKS = 32;  // keys per tile of the f32 kernel

// three bf16 planes of q * scale ([kBQ][D + 8] each), then of K and of V
// ([kBKS][D + 8] each)
template <int D>
constexpr size_t split3_smem() {
  return (size_t)3 * (kBQ + 2 * kBKS) * ld_h<D>() * sizeof(bf16);
}

// rows [r0, r0 + R) of an (S, H, D) f32 tensor (x already at its head),
// times sc rounded in f32, split into three bf16 planes of [R][D + 8] at
// dst (plane t at dst + t * R * (D + 8)); rows past n are zeros. Each
// thread issues all its loads before it splits and stores.
template <int D, int R>
__device__ __forceinline__ void split_rows(bf16* dst,
                                           const float* __restrict__ x,
                                           int r0, int n, long long ss,
                                           float sc) {
  constexpr int LD = ld_h<D>(), kN = R * D / 4 / kThreads;
  float4 v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (D / 4), ch = idx % (D / 4);
    v[i] = r0 + r < n ? __ldg(reinterpret_cast<const float4*>(
                            x + (r0 + r) * ss + ch * 4))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (D / 4), ch = idx % (D / 4);
    uint32_t lo[3], hi[3];
    split3(v[i].x * sc, v[i].y * sc, lo);
    split3(v[i].z * sc, v[i].w * sc, hi);
#pragma unroll
    for (int t = 0; t < 3; ++t)
      *reinterpret_cast<uint2*>(dst + t * R * LD + r * LD + ch * 4) =
          make_uint2(lo[t], hi[t]);
  }
}

// kNorm: o is the normalized output and r0 the lse; otherwise o is the
// accumulator, r0 the row max m and r1 the row sum l. f32 throughout.
template <int D, bool kNorm>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_split3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ r0, float* __restrict__ r1, int Sq,
                 int Sk, long long q_ss, long long q_hs, long long k_ss,
                 long long k_hs, long long v_ss, long long v_hs,
                 long long o_ss, long long o_hs, float scale, int causal,
                 int q_off, int k_off) {
  constexpr int LD = ld_h<D>();
  constexpr int kKT = D / 16;             // 16-deep steps of s = q.K^T
  constexpr int kNT = D / 8;              // n-tiles of the accumulator
  constexpr int kCT = kNT < 8 ? kNT : 8;  // n-tiles of one P.V chunk
  constexpr int kQP = kBQ * LD, kKP = kBKS * LD;  // one plane
  bf16* Qp = reinterpret_cast<bf16*>(dyn_smem());  // q * scale
  bf16* Kp = Qp + 3 * kQP;
  bf16* Vp = Kp + 3 * kKP;

  const int h = blockIdx.y;
  // the longest causal rows first: the last query tile has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  const int m0 = 16 * (threadIdx.x >> 5);  // the warp's rows
  const float* kh = k + h * k_hs;
  const float* vh = v + h * v_hs;

  const int n_k = (Sk + kBKS - 1) / kBKS;
  // global q position minus global k position at local (0, 0): causal
  // keeps local (i, j) with i + delta >= j
  const int delta = q_off - k_off;
  // causal: tiles wholly above the global diagonal of this block are
  // skipped; none is left when the kv shard lies wholly after the block
  int kb_end = n_k;
  if (causal) {
    const int last = q0 + kBQ - 1 + delta;  // the block's last visible key
    kb_end = last < 0 ? 0 : min(n_k, last / kBKS + 1);
  }

  // rows m0 + g (i = 0) and m0 + g + 8 (i = 1), as in flash_fwd_mma
  float m_i[2] = {kMask, kMask}, l_i[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (kb_end > 0) split_rows<D, kBQ>(Qp, q + h * q_hs, q0, Sq, q_ss, scale);

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBKS;
    __syncthreads();  // the previous tile's K and V are consumed
    split_rows<D, kBKS>(Kp, kh, k0, Sk, k_ss, 1.f);
    split_rows<D, kBKS>(Vp, vh, k0, Sk, v_ss, 1.f);
    __syncthreads();  // this tile's K and V (and, first, q) are in

    // s: the warp's 16 rows x 32 keys, n-tile j = keys 8j..8j+7. Each
    // 16-deep step's six products go to a fresh accumulator, added to s
    // in f32: an mma truncates its accumulator input toward zero.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int kt = 0; kt < kKT; ++kt) {
      uint32_t a[3][4];
#pragma unroll
      for (int t = 0; t < 3; ++t) lda(a[t], Qp + t * kQP, LD, m0, 16 * kt);
#pragma unroll
      for (int jp = 0; jp < 4; jp += 2) {
        uint32_t b[2][3][2];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          uint32_t r[2][2];
          ldb_nk(r, Kp + t * kKP, LD, 8 * jp, 16 * kt);
          b[0][t][0] = r[0][0];
          b[0][t][1] = r[0][1];
          b[1][t][0] = r[1][0];
          b[1][t][1] = r[1][1];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_x6(part, a, b[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jp + j][e] += part[e];
        }
      }
    }
    const bool full =
        (k0 + kBKS <= Sk) && (!causal || k0 + kBKS - 1 <= q0 + delta);
    if (!full) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + c + (e & 1);
          const int row = q0 + m0 + g + 8 * (e >> 1);
          if (key >= Sk || (causal && row + delta < key)) s[j][e] = kMask;
        }
    }

    // online softmax in f32. A row whose max is still the mask (no visible
    // key yet) takes 0 in place of its max: its p are then exp(-1e30) = 0.
    float alpha[2], mref[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mb = fmaxf(s[0][2 * i], s[0][2 * i + 1]);
#pragma unroll
      for (int j = 1; j < 4; ++j)
        mb = fmaxf(mb, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float mn = fmaxf(m_i[i], mb);
      alpha[i] = expf(m_i[i] - mn);
      m_i[i] = mn;
      mref[i] = mn == kMask ? 0.f : mn;
    }
    // p, unrounded, into l and as three bf16 terms: score tiles 2t and
    // 2t + 1 are the A fragment of keys 16t..16t+15 for the P.V product
    uint32_t pa[2][3][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* sv = s[2 * t + hf] + 2 * i;
          const float p0 = expf(sv[0] - mref[i]);
          const float p1 = expf(sv[1] - mref[i]);
          ps[i] += p0;
          ps[i] += p1;
          uint32_t sp[3];
          split3(p0, p1, sp);
#pragma unroll
          for (int u = 0; u < 3; ++u) pa[t][u][2 * hf + i] = sp[u];
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + ps[i];

    // O = alpha O + P.V: the tile's P.V in a fresh accumulator (by chunks
    // of kCT n-tiles), added to the rescaled O in f32
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kCT) {
      float part[kCT][4];
#pragma unroll
      for (int j = 0; j < kCT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int j = 0; j < kCT; j += 2) {
          uint32_t b[2][3][2];
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            uint32_t r[2][2];
            ldb_kn(r, Vp + u * kKP, LD, 8 * (j0 + j), 16 * t);
            b[0][u][0] = r[0][0];
            b[0][u][1] = r[0][1];
            b[1][u][0] = r[1][0];
            b[1][u][1] = r[1][1];
          }
          mma_x6(part[j], pa[t], b[0]);
          mma_x6(part[j + 1], pa[t], b[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        acc[j0 + j][0] = fmaf(acc[j0 + j][0], alpha[0], part[j][0]);
        acc[j0 + j][1] = fmaf(acc[j0 + j][1], alpha[0], part[j][1]);
        acc[j0 + j][2] = fmaf(acc[j0 + j][2], alpha[1], part[j][2]);
        acc[j0 + j][3] = fmaf(acc[j0 + j][3], alpha[1], part[j][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + m0 + g + 8 * i;
    if (row >= Sq) continue;
    const long long r = h * (long long)Sq + row;
    float* out = o + row * o_ss + h * o_hs + c;
    if constexpr (kNorm) {
      const float den = fmaxf(l, 1e-30f);
      if ((lane & 3) == 0) r0[r] = m_i[i] + logf(den);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    } else {
      if ((lane & 3) == 0) {
        r0[r] = m_i[i];
        r1[r] = l;
      }
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
    *smem = split3_smem<D>();
    return reinterpret_cast<const void*>(flash_fwd_split3<D, kNorm>);
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
    flash_fwd_split3<D, kNorm><<<grid, kThreads, smem, stream>>>(
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
