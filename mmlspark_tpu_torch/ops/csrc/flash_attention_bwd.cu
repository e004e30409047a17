// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// WHAT THEY COMPUTE
//   For each head h, query row i and key j (q, k, v, dO in the public
//   (S, H, D) layout, read through their strides; Sk may differ from Sq),
//   given lse (H, Sq) f32 and dsum (H, Sq) f32, and the blocks' global
//   positions q_off + i and k_off + j:
//     s[i, j]  = (q[i] * scale) . k[j]            q scaled in its own type
//     p[i, j]  = exp(s[i, j] - lse[i]), and 0 where j >= Sk, or causal and
//                q_off + i < k_off + j
//     dp[i, j] = dO[i] . v[j]
//     ds[i, j] = p[i, j] (dp[i, j] - dsum[i])
//     dq[i]    = scale * sum_j T(ds[i, j]) k[j]         the dq kernel
//     dv[j]    = sum_i TO(p[i, j]) dO[i]                the dk/dv kernel
//     dk[j]    = scale * sum_i T(ds[i, j]) q[i]         (q unscaled)
//   with T(x) = x rounded to the inputs' type, TO(x) to dO's (identity for
//   f32) and every sum in f32: the contract of
//   mmlspark_tpu_torch/ops/flash_attention.py::_flash_backward_plain.
//   Two VJPs share them. The normalized forward's passes lse, dsum =
//   rowsum(dO * O), dO in the inputs' type and offsets 0. The ring stats
//   forward's passes lse := m, dsum := -dl, dO := d_acc, which is f32 for
//   bf16 inputs too (dtype code 2: as in the reference, whose dv product
//   rounds p to dO's type), and the pair's offsets.
//
// WHICH TPU KERNELS THEY REPLACE
//   mmlspark_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:478,
//   pallas_call :621) and ::_flash_bwd_dkv_kernel (:516, pallas_call :642),
//   with _bwd_common (:445) and the visibility tests _bwd_visible_t /
//   _bwd_full_t (:559-579), offsets included. The TPU walks a sequential
//   grid axis carrying the dq (or dk, dv) sums in VMEM scratch; here one
//   block owns a tile of 64 query rows (dq) or 64 keys (dk/dv) of one head
//   and loops over the other side's tiles itself, so nothing carries
//   between blocks and no atomics are needed: each kernel is deterministic
//   from run to run. Padded copies are gone: tiles are read through the
//   strides and ragged edges are masked.
//
// WHAT BOUNDS THEM
//   Operations. The least work of any backward is 5 products of
//   2 * Sq * Sk * D per head (S, dP, dV, dK, dQ), halved when causal; this
//   two-kernel design does 7 (the dq kernel rebuilds S and dP). At
//   S=16384, H=8, D=128, causal, that least work is 1.39 ms at the H100's
//   989 TFLOP/s bf16 tensor-core rate (20.5 ms at its 67 TFLOP/s f32 rate),
//   against ~0.1 ms for the bytes. In f32 each product takes 6 bf16
//   tensor-core products (below): its least time is 6x the bf16 one,
//   8.3 ms at that shape, against 20.5 ms at the 67 TFLOP/s of f32 FMAs.
//
// TWO DESIGNS, BY DTYPE CODE
//   Every product runs on the tensor cores in both.
//   bf16 (code 1, and code 2: bf16 q, k, v with an f32 dO):
//   flash_bwd_dq_mma / flash_bwd_dkv_mma, which round p and ds as the plain
//   version does.
//   f32 (code 0): flash_bwd_dq_split3 / flash_bwd_dkv_split3, every f32
//   operand split into three bf16 terms (TF32 alone keeps 10 mantissa bits
//   and cannot meet the f32 limit of _BWD_TOL; three bf16 terms carry 24).
//
// THE TENSOR-CORE KERNELS (bf16)
//   Products: mma.sync.m16n8k16 bf16 x bf16 -> f32, operands from shared
//   memory through ldmatrix (.trans where a product needs the transpose of
//   a stored tile: K for dq = ds.K, q and dO for dk and dv, p^T and ds^T),
//   so every tile is stored once, in its own type, row-major with 8
//   elements of padding per row (rows 16 bytes apart mod 128: ldmatrix's
//   8-row phases hit 8 distinct bank groups). wgmma is later work
//   (ROADMAP Queue 2 K1). The product of two bf16 values is exact in f32,
//   so with bf16 operands the tensor cores compute the reference's rounding
//   points exactly (S from T(q*scale), ds rounded to T before dq and dk, p
//   to bf16 before dv); only the order of the f32 sums differs.
//   Block: 256 threads, 8 warps. Tiles: 64 query rows x 64 keys. Warp w
//   computes s and dp for rows 16(w%4).. x keys 32(w/4).. (4 n-tiles of 8,
//   16 f32 each), then p and ds in registers; ds (and, dk/dv, p) go to
//   shared memory, and warp w accumulates rows (dq) or keys (dk, dv)
//   16(w%4).. x columns (D/2)(w/4).. over the tile: D/16 n-tiles, 32 f32
//   per output at D=128 (64 for dk + dv).
//   Loads: cp.async, two stages: the dq kernel's next K/V tile, the dk/dv
//   kernel's next q, dO, lse and dsum tile load while the current one
//   computes; rows past Sq or Sk are zero-filled. q*scale is rounded in
//   registers (dq: once, into shared memory; dk/dv: on each A fragment).
//   Shared memory at D=128: dq 113,696 B (2 blocks per SM), code 2 130,080;
//   dk/dv 123,968 B, code 2 164,928 (1 block per SM).
//   Sums: s and dp add each 16-deep chunk's fresh tensor-core accumulator
//   into f32 on the CUDA cores (rows_x_keys), and p and ds are rounded as
//   the plain version rounds them: the few elements near a bf16 rounding
//   midpoint are recomputed in its sequential order, at the block's end,
//   and corrected where they round otherwise (p_ds): the bf16 check
//   cannot absorb a dominant term rounded the other way. The lists of
//   those elements live in the block's own rows of dq (or dk), which the
//   epilogue writes last; shared memory holds only their lengths.
//   The f32 dO of code 2 (the ring's d_acc): tensor cores take no f32
//   operand, so each f32 value x is split into three bf16 terms, hi =
//   bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each remainder
//   is exact in f32), which carry x to ~2^-24 relative. dp = dO.v^T takes
//   three products (hi, mid, lo with v). dv = p^T.dO, with p unrounded
//   (TO = f32) and split alike, takes the six cross products whose terms'
//   ranks sum to at most 2; what is dropped (mid.lo, lo.mid, lo.lo) and
//   the split's remainders are a few 2^-24 |p||dO| per term: f32-sized,
//   far inside the bf16 limit code 2 is checked under (_BWD_TOL[bfloat16]:
//   2^-7 |want| + 2^-8 r). S, dq and dk keep bf16 operands.
//
// MASKING AND SKIPPING (the reference's; both designs)
//   Causal: the dq kernel stops at the global diagonal's tile and its
//   blocks run the longest rows first; the dk/dv kernel starts at it.
//   Every tile with no visible (row, key) is skipped, and a pair whose kv
//   shard lies wholly after its q shard computes no tile and writes zeros.
//   Tiles that need no mask (every key < Sk and, causal, below every row)
//   skip the mask pass; elsewhere p = 0 at masked entries, as the plain
//   version defines it (with lse := m = -1e30, a stats row with no visible
//   key, exp(s - lse) would not be). Rows past Sq take lse = +inf, so
//   their p and ds are 0.
//
// THE F32 KERNELS (code 0)
//   The same products and tiles, with every f32 operand x held as three
//   bf16 terms (split3 below: hi = bf16(x), mid = bf16(x - hi), lo =
//   bf16(x - hi - mid), exactly x for normal x) and every product taking
//   the six cross products whose terms' ranks sum to at most 2 (mma_x6):
//   what is dropped is ~2^-24 of each term, as f32 rounding itself. p and
//   ds are never rounded (T and TO are the identity), so none of the bf16
//   kernels' rounding machinery (midpoint flags, lists, recomputation) is
//   needed: the f32 limit allows any summation order. It does not allow
//   a sum chained through one tensor-core accumulator: an mma aligns its
//   accumulator input with its products and truncates below 24 bits, so
//   it loses up to an ulp of the running sum a step, always toward zero.
//   Each 16-deep step of s and dp, and each 64-deep tile of dq, dk and dv,
//   goes to a fresh accumulator that the CUDA cores add to the running
//   f32 sum. tests/test_torch_flash_bwd_f32_split.py rehearses this order
//   on the CPU.
//   Tiles are split once, as they land, into three bf16 planes of
//   [kB][D+8] (RowsF32: global loads into registers, one splitting pass),
//   so ldmatrix feeds every term as in the bf16 kernels. p and ds are split in
//   registers and stored as planes of [kB][kLDS]. Warp w computes s and dp
//   for rows 32(w%2).. x keys 16(w/2).. (2 x 2 tiles: each B fragment's
//   three terms serve two row tiles) and accumulates as the bf16 kernels.
//   dq: Q (q * scale), dO, K and V planes, one stage; ds takes V's space
//   once every warp has taken dP (D >= 64); the next K and V load once
//   the dq products are done. 208,896 B at D=128.
//   dk/dv: the block's K and V stay f32 (split on each B fragment: three
//   planes of each would not fit beside the q tile's), q * scale and dO
//   planes one stage, p and ds planes; the next dO loads once every warp
//   is done with the dv products, each warp going on to its dk products
//   as soon as its share is stored, the next q after the dk products, lse
//   and dsum by cp.async into two stages. dk sums ds^T against q * scale,
//   which moves each term by at most 2^-24 of itself. 230,400 B at D=128.
//   Both: 1 block per SM of 8 warps; one stage, because three planes of
//   each tile take 1.5x the bytes of f32 and the registers are spent (240
//   and 255 at D=128). Prefetching the next tile into registers spilled
//   and ran slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_frag.cuh"

namespace {

using namespace mma_sync;

constexpr int kB = 64;          // query rows and keys per tile
constexpr int kThreads = 256;   // 8 warps

// strides in elements, {seq, head} of q, k, v, dO and the outputs (a: dq
// or dk, b: dv)
struct Strides {
  long long q[2], k[2], v[2], o[2], a[2], b[2];
};

// ---------------------------------------------------------------------------
// bf16 (codes 1 and 2): the tensor-core kernels

// padded row strides, in elements: bf16 tiles of D or kB columns, f32 tiles
template <int D>
__host__ __device__ constexpr int ld_h() { return D + 8; }
constexpr int kLDS = kB + 8;
template <int D>
__host__ __device__ constexpr int ld_f() { return D + 4; }
constexpr int kLDP = kB + 4;

// row stride of a [kB][D] tile of dO's type
template <typename TO, int D>
__host__ __device__ constexpr int ld_o() {
  return sizeof(TO) == 2 ? ld_h<D>() : ld_f<D>();
}

// x and y each split into three bf16 terms (hi, mid, lo; see the header),
// packed pairwise: out[i] = (x_i, y_i)
__device__ __forceinline__ void split3(float x, float y, uint32_t out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
    x -= __bfloat162float(v.x);
    y -= __bfloat162float(v.y);
  }
}

// d += a . b over one 16-deep step for three-term operands: the six cross
// products whose terms' ranks (hi 0, mid 1, lo 2) sum to at most 2,
// smallest first. What is dropped (mid.lo, lo.mid, lo.lo) is ~2^-24 of
// |a||b| per product.
__device__ __forceinline__ void mma_x6(float d[4], const uint32_t a[3][4],
                                       const uint32_t b[3][2]) {
  mma_bf16(d, a[1], b[1]);
  mma_bf16(d, a[2], b[0]);
  mma_bf16(d, a[0], b[2]);
  mma_bf16(d, a[1], b[0]);
  mma_bf16(d, a[0], b[1]);
  mma_bf16(d, a[0], b[0]);
}

// f32 tiles (code 2's dO and p), split into three bf16 terms per element
// A at (m0, k0) of a row-major f32 tile
__device__ __forceinline__ void lda_f32(uint32_t a[3][4], const float* t,
                                        int ld, int m0, int k0) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(
        t + (m0 + g + 8 * (i & 1)) * ld + k0 + c + 8 * (i >> 1));
    uint32_t s[3];
    split3(x.x, x.y, s);
    a[0][i] = s[0];
    a[1][i] = s[1];
    a[2][i] = s[2];
  }
}
// A at (m0, k0) of the transpose of a row-major f32 tile: A(m, k) = t[k][m]
__device__ __forceinline__ void lda_t_f32(uint32_t a[3][4], const float* t,
                                          int ld, int m0, int k0) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = t + (k0 + c + 8 * (i >> 1)) * ld + m0 + g + 8 * (i & 1);
    uint32_t s[3];
    split3(p[0], p[ld], s);
    a[0][i] = s[0];
    a[1][i] = s[1];
    a[2][i] = s[2];
  }
}
// B of the one n-tile n0 at depth k0, where B(k, n) = t[k][n], f32
__device__ __forceinline__ void ldb_kn_f32(uint32_t b[3][2], const float* t,
                                           int ld, int n0, int k0) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* p = t + (k0 + c + 8 * i) * ld + n0 + g;
    uint32_t s[3];
    split3(p[0], p[ld], s);
    b[0][i] = s[0];
    b[1][i] = s[1];
    b[2][i] = s[2];
  }
}

// rows [r0, r0 + kB) of an (S, H, D) tensor (x already at its head) into a
// [kB][ld] tile of Te, asynchronously; rows past n are zeros
template <typename Te, int D>
__device__ __forceinline__ void cp_tile(Te* dst, int ld,
                                        const Te* __restrict__ x, int r0,
                                        int n, long long ss) {
  constexpr int kVec = 16 / sizeof(Te), kChunks = D / kVec;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool in = r0 + r < n;
    cp_async16(dst + r * ld + ch * kVec,
               in ? x + (r0 + r) * ss + ch * kVec : x, in);
  }
}

// acc = A . B^T-style products of one warp: s (or dp) for its 16 rows at
// m0 x 32 keys at n0, over depth D. A from `a_t` (row-major, ld_a, bf16 or
// f32 split) with, for bf16, each register rounded to T(a * sc) unless
// sc == 1 (q in the dk/dv kernel); B(k, n) = b_t[n][k] (bf16).
// Each 16-deep chunk is summed in a fresh tensor-core accumulator and
// added to acc in f32 on the CUDA cores. An mma aligns its accumulator
// input with the products and truncates what falls below 24 bits, so
// chaining the chunks through it loses ~1 ulp of the running sum per
// chunk, always toward zero; s and dp are rounded to bf16 (p, ds) right
// after, and that error would flip several times more of them than f32
// sums do (the bf16 check then fails). Added here, each chunk errs only
// against its own terms, and each addition rounds to nearest.
template <int D, typename TA>
__device__ __forceinline__ void rows_x_keys(float acc[4][4], const TA* a_t,
                                            int ld_a, int m0, float sc,
                                            const bf16* b_t, int ld_b,
                                            int n0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t b[4][2];
    ldb_nk(b, b_t, ld_b, n0, kk);
    ldb_nk(b + 2, b_t, ld_b, n0 + 16, kk);
    if constexpr (sizeof(TA) == 2) {
      uint32_t a[4];
      lda(a, a_t, ld_a, m0, kk);
      if (sc != 1.f) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = scale_bf16x2(a[i], sc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[4];
        mma_bf16_zero(part, a, b[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      }
    } else {
      uint32_t a[3][4];
      lda_f32(a, a_t, ld_a, m0, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[4];
        mma_bf16_zero(part, a[2], b[j]);
        mma_bf16(part, a[1], b[j]);
        mma_bf16(part, a[0], b[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      }
    }
  }
}

// a . b summed over d = 0, 1, ..., D - 1 with one rounding per step (fmaf
// from 0): the order, and so the rounding, in which the plain version's
// f32 products (cuBLAS) sum s and dp. 8 elements of a (bf16, or f32: code
// 2's dO) and of b (bf16) per step.
// a is rounded to T(a * sc) first unless sc == 1 (q in the dk/dv kernel)
__device__ __forceinline__ void fma8(float& acc, const bf16* a,
                                     const bf16* b, float sc) {
  const uint4 av = *reinterpret_cast<const uint4*>(a);
  const uint4 bv = *reinterpret_cast<const uint4*>(b);
  const uint32_t aw[4] = {av.x, av.y, av.z, av.w};
  const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = sc != 1.f ? scale_bf16x2(aw[i], sc) : aw[i];
    acc = fmaf(__uint_as_float(x << 16), __uint_as_float(bw[i] << 16),
               acc);
    acc = fmaf(__uint_as_float(x & 0xffff0000u),
               __uint_as_float(bw[i] & 0xffff0000u), acc);
  }
}
__device__ __forceinline__ void fma8(float& acc, const float* a,
                                     const bf16* b, float) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
  const uint4 bv = *reinterpret_cast<const uint4*>(b);
  const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(af[2 * i], __uint_as_float(bw[i] << 16), acc);
    acc = fmaf(af[2 * i + 1], __uint_as_float(bw[i] & 0xffff0000u), acc);
  }
}

// s = T(q * sc) . k and dp = dO . v of one (row, key), each in the plain
// version's order; the two chains interleave.
template <typename TO, int D, int kUnroll = 1>
__device__ __forceinline__ float2 seq_s_dp(const bf16* q, float sc,
                                           const bf16* k, const TO* o,
                                           const bf16* v) {
  float s = 0.f, dp = 0.f;
#pragma unroll kUnroll
  for (int d = 0; d < D; d += 8) {
    fma8(s, q + d, k + d, sc);
    fma8(dp, o + d, v + d, 1.f);
  }
  return make_float2(s, dp);
}

// Is x within w of the midpoint between its two bf16 neighbours (where
// rounding to bf16 changes direction)?
__device__ __forceinline__ bool near_bf16_mid(float x, float w) {
  const float mid =
      __uint_as_float((__float_as_uint(x) & 0xffff0000u) | 0x8000u);
  return fabsf(x - mid) <= w;
}

// The tile's rows in shared memory, for the sequential recomputation:
// q (rounded to T(q * sc) unless sc == 1), dO, k, v.
template <typename TO>
struct TileRows {
  const bf16* q;
  int ldq;
  float sc;
  const TO* o;
  int ldo;
  const bf16* k;
  const bf16* v;
  int ldk;
};

// p and ds of the warp's s and dp fragments in place (s -> p, dp -> ds):
// rows m0 + g (+8), keys n0 + 8j + c (+1) of the tile at (q0, k0); l and
// dsm are the two rows' lse and dsum. delta = q_off - k_off: causal keeps
// local (i, j) with i + delta >= j.
// Rounding as the plain version rounds: p is rounded to bf16 before dv
// (code 1) and ds before dq and dk, and a term that rounds the other way
// than in the plain version moves by up to 2^-7 of itself, which the bf16
// check does not allow where one term dominates its output. s and dp from
// the tensor cores differ from the plain version's sequential f32 sums by
// a few f32 ulps of the row's partial sums, far below a bf16 ulp, but not
// zero. So an element whose p (code 1) or ds lies within a window of a
// bf16 rounding midpoint has s and dp recomputed in the plain version's
// order (seq_s_dp): then p and ds round exactly as there. The window on s
// is 2^-25 sqrt(D) max(|s|, rms), with rms over the warp's 32 keys of the
// row (alike on dp; plus 2^-22 relative on p for expf's own rounding),
// several times the typical difference; an element whose difference still
// passes it rounds the other way only if it also lies within the excess
// of a midpoint, and that fails the bf16 check only where its term
// dominates its output. A ds whose dp and dsum cancel to within 2^-7 of
// their size is exempt: the check's own term scale covers its rounding
// (below); without that, nearly uniform attention, as at initialization,
// would flag many of its elements. Masked elements (p = ds = 0) never
// flag. Recomputing them in the tile would stall the block at its next
// barrier for the slowest warp nearly every tile; so p_ds only flags
// them, the tile uses its own roundings, and the kernel defers the flagged
// elements to lists (append_flags) that it works off at its end, 32 a
// pass: where the plain version's rounding differs from the one used, the
// accumulators get (the difference) x the row it multiplied (flush_dq,
// flush_dkv). A list that is full takes no more; that tile's flagged
// elements are recomputed at once (redo_now).
template <typename TO, int D>
__device__ __forceinline__ uint32_t p_ds(float s[4][4], float dp[4][4],
                                         const float l[2],
                                         const float dsm[2], int q0, int k0,
                                         int m0, int n0, int Sk, int causal,
                                         int delta, bool full) {
  constexpr float kUlps = 1.f / (1 << 22);
  const float win = sqrtf((float)D) / (1 << 25);
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  // the rms of s and dp over the row's 32 keys in this warp (4 lanes)
  float rs[2] = {0.f, 0.f}, rdp[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rs[e >> 1] = fmaf(s[j][e], s[j][e], rs[e >> 1]);
      rdp[e >> 1] = fmaf(dp[j][e], dp[j][e], rdp[e >> 1]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    rdp[i] += __shfl_xor_sync(0xffffffffu, rdp[i], 1);
    rdp[i] += __shfl_xor_sync(0xffffffffu, rdp[i], 2);
    rs[i] = sqrtf(rs[i] * (1.f / 32));
    rdp[i] = sqrtf(rdp[i] * (1.f / 32));
  }
  uint32_t redo = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e >> 1;
      const int qpos = q0 + m0 + g + 8 * hi;
      const int kpos = k0 + n0 + 8 * j + c + (e & 1);
      const bool masked =
          !full && (kpos >= Sk || (causal && qpos + delta < kpos));
      const float p = masked ? 0.f : expf(s[j][e] - l[hi]);
      const float ds = p * (dp[j][e] - dsm[hi]);
      const float ws = win * fmaxf(fabsf(s[j][e]), rs[hi]) + kUlps;
      const float wdp = win * fmaxf(fabsf(dp[j][e]), rdp[hi]);
      // a ds from dp and dsum that cancel to within 2^-7 of their size
      // may round either way: the bf16 check's term scale allows such a
      // term 2^-6 p (|dO|.|v| + |dsum|) >= 2^-6 p (|dp| + |dsum|), more
      // than the 2^-7 |ds| it can move (flash_attention._bwd_term_scales)
      const bool apart = fabsf(dp[j][e] - dsm[hi]) >
                         (fabsf(dp[j][e]) + fabsf(dsm[hi])) * (1.f / 128);
      bool again = apart && near_bf16_mid(ds, fabsf(ds) * ws + p * wdp);
      if (sizeof(TO) == 2) again |= near_bf16_mid(p, p * ws);
      redo |= (uint32_t)again << (4 * j + e);
      s[j][e] = p;
      dp[j][e] = ds;
    }
  return redo;
}

// The flagged elements of p_ds recomputed at once (when a warp's list of
// deferred ones is full): s -> p, dp -> ds in place.
template <typename TO, int D>
__device__ __forceinline__ void redo_now(float s[4][4], float dp[4][4],
                                         uint32_t redo, const float l[2],
                                         const float dsm[2], int m0, int n0,
                                         const TileRows<TO>& t) {
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  while (redo) {
    const int idx = __ffs(redo) - 1;
    redo &= redo - 1;
    const int hi = (idx >> 1) & 1;
    const int r = m0 + g + 8 * hi, kk = n0 + 8 * (idx >> 2) + c + (idx & 1);
    const float2 sd = seq_s_dp<TO, D>(t.q + r * t.ldq, t.sc,
                                      t.k + kk * t.ldk, t.o + r * t.ldo,
                                      t.v + kk * t.ldk);
    const float p = expf(sd.x - (hi ? l[1] : l[0]));
    const float ds = p * (sd.y - (hi ? dsm[1] : dsm[0]));
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (idx == 4 * j + e) {
          s[j][e] = p;
          dp[j][e] = ds;
        }
  }
}

// x rounded to bf16, as a float and as bits; bf16 bits as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_bits(uint32_t b) {
  return __uint_as_float(b << 16);
}
__device__ __forceinline__ uint32_t bits_bf16(float x) {
  return __float_as_uint(round_bf16(x)) >> 16;
}

// Deferred elements are kept in lists of 8-byte entries stored in the
// block's own rows of an output tensor (dq, or dk), which the kernel owns
// and writes only in its epilogue: `rows` rows of `per_row` entries (D/4)
// at `stride` elements, the list of a warp (and key group) starting at
// entry `first`.
struct Slots {
  bf16* base;
  long long stride;
  int per_row, first;
  __device__ __forceinline__ uint2* at(int e) const {
    e += first;
    return reinterpret_cast<uint2*>(base + (e / per_row) * stride +
                                    (e % per_row) * 4);
  }
};

// Appends the warp's flagged elements (redo: slot 4j + e of each lane;
// p, ds their values as used in the tile) to a list after `count`
// entries, lane by lane and slot by slot within a lane, so the order
// depends only on the data. The dq kernel's entry is {row << 26 | key,
// T(ds)}, the dk/dv kernel's {key << 26 | row, TO(p) << 16 | T(ds)}: local
// row and key in the tile, the other index global (base + local). Returns
// the new count, or -1 (nothing appended) when they do not fit in cap.
template <bool kDq>
__device__ __forceinline__ int append_flags(const Slots& list, int count,
                                            int cap, uint32_t redo,
                                            const float p[4][4],
                                            const float ds[4][4], int m0,
                                            int n0, int base) {
  if (!__any_sync(0xffffffffu, redo != 0)) return count;
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  const int mine = __popc(redo);
  int upto = mine;  // inclusive prefix sum over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += t;
  }
  const int n = __shfl_sync(0xffffffffu, upto, 31);
  if (count + n > cap) return -1;
  int pos = count + upto - mine;
  while (redo) {
    const int i = __ffs(redo) - 1;
    redo &= redo - 1;
    float pv = 0.f, dv = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i == 4 * jj + e) {
          pv = p[jj][e];
          dv = ds[jj][e];
        }
    const uint32_t r = m0 + g + 8 * ((i >> 1) & 1);
    const uint32_t kk = n0 + 8 * (i >> 2) + c + (i & 1);
    *list.at(pos++) = kDq ? make_uint2(r << 26 | (base + kk), bits_bf16(dv))
                          : make_uint2(kk << 26 | (base + r),
                                       bits_bf16(pv) << 16 | bits_bf16(dv));
  }
  return count + n;
}

// acc[j][2 hi .. 2 hi + 1] += dd * (the bf16 pair or f32 pair at x + 8 j),
// for the n-tiles j of a warp's columns; hi picks the fragment's row
template <int kNT, typename Te>
__device__ __forceinline__ void add_row(float acc[kNT][4], int hi, float dd,
                                        const Te* x) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    float a, b;
    if constexpr (sizeof(Te) == 2) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(x + 8 * j);
      a = __uint_as_float(w << 16);
      b = __uint_as_float(w & 0xffff0000u);
    } else {
      const float2 f = *reinterpret_cast<const float2*>(x + 8 * j);
      a = f.x;
      b = f.y;
    }
    if (hi) {
      acc[j][2] = fmaf(dd, a, acc[j][2]);
      acc[j][3] = fmaf(dd, b, acc[j][3]);
    } else {
      acc[j][0] = fmaf(dd, a, acc[j][0]);
      acc[j][1] = fmaf(dd, b, acc[j][1]);
    }
  }
}

// The dq warp's share of the block's deferred elements at its end: the
// lists of the two warps with its rows (m0), la then lb, one entry a lane:
// s and dp recomputed in the plain version's order (k and v rows read from
// global memory, their tiles being gone), and where T(ds) rounds otherwise
// than in the tile, acc += (the difference) k over the warp's columns.
template <typename TO, int D>
__device__ __forceinline__ void flush_dq(
    float acc[D / 16][4], const Slots& la, int na, const Slots& lb, int nb,
    const bf16* Qs, int ld, const TO* dOs, int ldo, const bf16* kh,
    long long ks, const bf16* vh, long long vs, const float* lse_h,
    const float* dsum_h, int q0, int m0, int d0) {
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  for (int base = 0; base < na + nb; base += 32) {
    const int idx = base + lane;
    uint2 ent = make_uint2(0, 0);
    if (idx < na + nb) ent = idx < na ? *la.at(idx) : *lb.at(idx - na);
    const int r = ent.x >> 26, key = ent.x & ((1 << 26) - 1);
    float dd = 0.f;
    if (idx < na + nb) {
      const float2 sd = seq_s_dp<TO, D, 4>(Qs + r * ld, 1.f, kh + key * ks,
                                           dOs + r * ldo, vh + key * vs);
      const float p = expf(sd.x - lse_h[q0 + r]);
      dd = round_bf16(p * (sd.y - dsum_h[q0 + r])) - bf16_bits(ent.y);
    }
    uint32_t m = __ballot_sync(0xffffffffu, dd != 0.f);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int rr = __shfl_sync(0xffffffffu, r, src) - m0;
      const int kk = __shfl_sync(0xffffffffu, key, src);
      const float d = __shfl_sync(0xffffffffu, dd, src);
      if ((rr & 7) == g)
        add_row<D / 16>(acc, rr >> 3, d, kh + kk * ks + d0 + c);
    }
  }
}

// The dk/dv warp's share at the block's end: the lists of its key group
// (keys km..km+15; kept by the four warps whose s tiles hold those keys),
// one entry a lane, recomputed in the plain version's order (q and dO rows
// read from global memory); where TO(p) (code 1) or T(ds) rounds otherwise
// than in the tile, dv += (the difference) dO and dk += (the difference) q
// over the warp's columns.
// List i of the group sits at entry (src(i)) * cap of `lists`, with
// src(i) = 2 (4 (kg / 2) + i) + kg % 2 (warp 4 (kg / 2) + i, its list
// kg % 2), and holds cnt[src(i)] entries.
template <typename TO, int D>
__device__ __forceinline__ void flush_dkv(
    float dka[D / 16][4], float dva[D / 16][4], const Slots& lists, int cap,
    const int* cnt, int kg, const bf16* qh, long long qs, const TO* oh,
    long long os, float scale_t, const bf16* Ks, const bf16* Vs, int ld,
    const float* lse_h, const float* dsum_h, int d0) {
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
  const int km = 16 * kg, src0 = 8 * (kg >> 1) + (kg & 1);
  const int total = cnt[src0] + cnt[src0 + 2] + cnt[src0 + 4] +
                    cnt[src0 + 6];
  for (int base = 0; base < total; base += 32) {
    const int idx = base + lane;
    uint2 ent = make_uint2(0, 0);
    if (idx < total) {
      int src = src0, i = idx;
      while (i >= cnt[src]) {
        i -= cnt[src];
        src += 2;
      }
      ent = *lists.at(src * cap + i);
    }
    const int kk = (int)(ent.x >> 26) - km;
    const int row = ent.x & ((1 << 26) - 1);
    float dp_ = 0.f, dds = 0.f;
    if (idx < total) {
      const float2 sd = seq_s_dp<TO, D, 4>(qh + row * qs, scale_t,
                                           Ks + (km + kk) * ld,
                                           oh + row * os,
                                           Vs + (km + kk) * ld);
      const float p = expf(sd.x - lse_h[row]);
      dds = round_bf16(p * (sd.y - dsum_h[row])) -
            bf16_bits(ent.y & 0xffffu);
      if (sizeof(TO) == 2) dp_ = round_bf16(p) - bf16_bits(ent.y >> 16);
    }
    uint32_t m = __ballot_sync(0xffffffffu, dds != 0.f || dp_ != 0.f);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int key = __shfl_sync(0xffffffffu, kk, src);
      const int rw = __shfl_sync(0xffffffffu, row, src);
      const float a = __shfl_sync(0xffffffffu, dds, src);
      const float b = __shfl_sync(0xffffffffu, dp_, src);
      if ((key & 7) == g) {
        if (a != 0.f)
          add_row<D / 16>(dka, key >> 3, a, qh + rw * qs + d0 + c);
        if (b != 0.f)
          add_row<D / 16>(dva, key >> 3, b, oh + rw * os + d0 + c);
      }
    }
  }
}

template <typename TO, int D>
constexpr size_t dq_mma_smem() {
  return (size_t)kB * (5 * ld_h<D>() * 2 + ld_o<TO, D>() * sizeof(TO) +
                       kLDS * 2) +
         (kThreads / 32) * sizeof(int);
}
template <typename TO, int D>
constexpr size_t dkv_mma_smem() {
  return (size_t)kB * (4 * ld_h<D>() * 2 +
                       2 * ld_o<TO, D>() * sizeof(TO) + 4 * 4 +
                       (sizeof(TO) == 2 ? kLDS : kLDP) * sizeof(TO) +
                       kLDS * 2) +
         2 * (kThreads / 32) * sizeof(int);
}

// TO: dO's type (bf16, or f32 for code 2); q, k, v, dq are bf16
template <typename TO, int D>
__global__ void __launch_bounds__(kThreads, sizeof(TO) == 2 ? 2 : 1)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const TO* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf16* __restrict__ dq,
                 int Sq, int Sk, Strides st, float scale, int causal,
                 int delta) {
  constexpr int LD = ld_h<D>(), LDO = ld_o<TO, D>();
  constexpr int kNT = D / 16;  // n-tiles of 8 in a warp's D/2 columns
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem());  // [kB][LD] T(q * scale)
  TO* dOs = reinterpret_cast<TO*>(Qs + kB * LD);   // [kB][LDO]
  bf16* KV = reinterpret_cast<bf16*>(dOs + kB * LDO);  // 2 x {K, V}
  bf16* dSs = KV + 4 * kB * LD;                    // [kB][kLDS] T(ds)
  int* Cnt = reinterpret_cast<int*>(dSs + kB * kLDS);  // list lengths

  const int h = blockIdx.y;
  // the longest causal rows first: the last query tile has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int w = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int m0 = 16 * (w & 3);          // the warp's rows
  const int n0 = 32 * (w >> 2);         // its keys in s, dp
  const int d0 = (D / 2) * (w >> 2);    // its columns of dq
  const bf16* kh = k + h * st.k[1];
  const bf16* vh = v + h * st.v[1];
  // each warp's list of deferred elements, in the block's rows of dq
  const int cap = min(kB, Sq - q0) * (D / 4) / (kThreads / 32);
  const Slots my_list = {dq + q0 * st.a[0] + h * st.a[1], st.a[0], D / 4,
                         w * cap};
  int count = 0;

  const int n_k = (Sk + kB - 1) / kB;
  // causal: key tiles wholly above the global diagonal of this block are
  // skipped; none is left when the kv shard lies wholly after the block
  int kb_end = n_k;
  if (causal) {
    const int last = q0 + kB - 1 + delta;  // the block's last visible key
    kb_end = last < 0 ? 0 : min(n_k, last / kB + 1);
  }

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (kb_end > 0) {
    cp_tile<TO, D>(dOs, LDO, dout + h * st.o[1], q0, Sq, st.o[0]);
    cp_tile<bf16, D>(KV, LD, kh, 0, Sk, st.k[0]);
    cp_tile<bf16, D>(KV + kB * LD, LD, vh, 0, Sk, st.v[0]);
    cp_async_commit();
    // T(q * scale), rows past Sq zeros
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
    for (int idx = threadIdx.x; idx < kB * D / 8; idx += kThreads) {
      const int r = idx / (D / 8), ch = idx % (D / 8);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (q0 + r < Sq)
        x = *reinterpret_cast<const uint4*>(q + (q0 + r) * st.q[0] +
                                            h * st.q[1] + ch * 8);
      x.x = scale_bf16x2(x.x, scale_t);
      x.y = scale_bf16x2(x.y, scale_t);
      x.z = scale_bf16x2(x.z, scale_t);
      x.w = scale_bf16x2(x.w, scale_t);
      *reinterpret_cast<uint4*>(Qs + r * LD + ch * 8) = x;
    }
  }
  // the lse and dsum of the warp's rows m0 + g and m0 + g + 8
  float l[2], dsm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + m0 + g + 8 * i;
    const bool in = row < Sq;
    l[i] = in ? lse[h * (long long)Sq + row] : INFINITY;
    dsm[i] = in ? dsum[h * (long long)Sq + row] : 0.f;
  }

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB;
    const bf16* Ks = KV + (kb & 1) * 2 * kB * LD;
    const bf16* Vs = Ks + kB * LD;
    if (kb + 1 < kb_end) {  // the next tile into the other stage
      bf16* nxt = KV + ((kb + 1) & 1) * 2 * kB * LD;
      cp_tile<bf16, D>(nxt, LD, kh, k0 + kB, Sk, st.k[0]);
      cp_tile<bf16, D>(nxt + kB * LD, LD, vh, k0 + kB, Sk, st.v[0]);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and, first, dO and Qs) is in

    float s[4][4], dp[4][4];
    rows_x_keys<D>(s, Qs, LD, m0, 1.f, Ks, LD, n0);
    rows_x_keys<D>(dp, dOs, LDO, m0, 1.f, Vs, LD, n0);
    const bool full =
        (k0 + kB <= Sk) && (!causal || k0 + kB - 1 <= q0 + delta);
    const uint32_t redo =
        p_ds<TO, D>(s, dp, l, dsm, q0, k0, m0, n0, Sk, causal, delta, full);
    const int appended =
        append_flags<true>(my_list, count, cap, redo, s, dp, m0, n0, k0);
    if (appended < 0) {
      const TileRows<TO> rows = {Qs, LD, 1.f, dOs, LDO, Ks, Vs, LD};
      redo_now<TO, D>(s, dp, redo, l, dsm, m0, n0, rows);
    } else {
      count = appended;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf16* o = dSs + (m0 + g) * kLDS + n0 + 8 * j + c;
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(dp[j][0], dp[j][1]);
      *reinterpret_cast<uint32_t*>(o + 8 * kLDS) =
          pack_bf16(dp[j][2], dp[j][3]);
    }
    __syncthreads();  // T(ds) is in
    // acc += T(ds) . k over the tile's keys
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      uint32_t a[4];
      lda(a, dSs, kLDS, m0, kk);
      if constexpr (kNT == 1) {
        uint32_t b[2];
        ldb_kn1(b, Ks, LD, d0, kk);
        mma_bf16(acc[0], a, b);
      } else {
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t b[2][2];
          ldb_kn(b, Ks, LD, d0 + 8 * j, kk);
          mma_bf16(acc[j], a, b[0]);
          mma_bf16(acc[j + 1], a, b[1]);
        }
      }
    }
    __syncthreads();  // ds and this stage are consumed
  }
  cp_async_wait<0>();
  if (lane == 0) Cnt[w] = count;
  __syncthreads();  // the lists and their lengths are in
  {
    // the two warps with this warp's rows: key halves 0 and 1
    const Slots la = {my_list.base, st.a[0], D / 4, (w & 3) * cap};
    const Slots lb = {my_list.base, st.a[0], D / 4, ((w & 3) + 4) * cap};
    flush_dq<TO, D>(acc, la, Cnt[w & 3], lb, Cnt[(w & 3) + 4], Qs, LD, dOs,
                    LDO, kh, st.k[0], vh, st.v[0], lse + h * (long long)Sq,
                    dsum + h * (long long)Sq, q0, m0, d0);
  }
  __syncthreads();  // every list is read before dq overwrites them

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + m0 + g + 8 * i;
    if (row >= Sq) continue;
    bf16* out = dq + row * st.a[0] + h * st.a[1] + d0 + c;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <typename TO, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const TO* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Sq, int Sk, Strides st,
                  float scale, int causal, int delta) {
  constexpr int LD = ld_h<D>(), LDO = ld_o<TO, D>();
  constexpr bool kF32 = sizeof(TO) == 4;
  constexpr int LDP = kF32 ? kLDP : kLDS;
  constexpr int kNT = D / 16;
  // one stage: q [kB][LD], dO [kB][LDO], lse [kB], dsum [kB]
  constexpr int kStage = kB * LD * 2 + kB * LDO * (int)sizeof(TO) + 8 * kB;
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem());  // [kB][LD], the block's
  bf16* Vs = Ks + kB * LD;                         // [kB][LD]
  char* stages = reinterpret_cast<char*>(Vs + kB * LD);
  TO* Ps = reinterpret_cast<TO*>(stages + 2 * kStage);  // [kB][LDP] TO(p)
  bf16* dSs = reinterpret_cast<bf16*>(Ps + kB * LDP);   // [kB][kLDS] T(ds)
  int* Cnt = reinterpret_cast<int*>(dSs + kB * kLDS);  // list lengths

  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int w = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int m0 = 16 * (w & 3);          // the warp's rows in s, dp
  const int n0 = 32 * (w >> 2);         // its keys in s, dp
  const int km = 16 * (w & 3);          // its keys of dk, dv
  const int d0 = (D / 2) * (w >> 2);    // its columns of dk, dv
  const bf16* qh = q + h * st.q[1];
  const TO* oh = dout + h * st.o[1];
  // deferred elements in the block's rows of dk: a list for each warp and
  // key group of its s tile (keys n0..n0+15, n0+16..n0+31)
  const int cap = min(kB, Sk - k0) * (D / 4) / (2 * kThreads / 32);
  const Slots lists = {dk + k0 * st.a[0] + h * st.a[1], st.a[0], D / 4, 0};
  const Slots list0 = {lists.base, st.a[0], D / 4, 2 * w * cap};
  const Slots list1 = {lists.base, st.a[0], D / 4, (2 * w + 1) * cap};
  int count0 = 0, count1 = 0;
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));

  const int n_q = (Sq + kB - 1) / kB;
  // causal: query tiles wholly above the global diagonal see none of these
  // keys; the first tile that does has q0 + kB - 1 + delta >= k0 (none,
  // and zeros written, when the q shard lies wholly before the keys)
  int qb_begin = 0;
  if (causal) {
    const int first = k0 - delta - kB + 1;
    qb_begin = first <= 0 ? 0 : (first + kB - 1) / kB;
  }

  // the q tile at q0 into stage `sg`: q, dO, lse, dsum (rows past Sq zeros)
  auto load_stage = [&](int sg, int q0) {
    char* base = stages + sg * kStage;
    cp_tile<bf16, D>(reinterpret_cast<bf16*>(base), LD, qh, q0, Sq,
                     st.q[0]);
    cp_tile<TO, D>(reinterpret_cast<TO*>(base + kB * LD * 2), LDO, oh, q0,
                   Sq, st.o[0]);
    float* rows = reinterpret_cast<float*>(base + kB * LD * 2 +
                                           kB * LDO * sizeof(TO));
    const int i = threadIdx.x;
    if (i < 2 * kB) {
      const int row = q0 + (i & (kB - 1));
      const bool in = row < Sq;
      const float* src = i < kB ? lse : dsum;
      cp_async4(rows + i, in ? src + h * (long long)Sq + row : src, in);
    }
  };

  float dka[kNT][4], dva[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (qb_begin < n_q) {
    cp_tile<bf16, D>(Ks, LD, k + h * st.k[1], k0, Sk, st.k[0]);
    cp_tile<bf16, D>(Vs, LD, v + h * st.v[1], k0, Sk, st.v[0]);
    load_stage(0, qb_begin * kB);
    cp_async_commit();
  }
  for (int qb = qb_begin, it = 0; qb < n_q; ++qb, ++it) {
    const int q0 = qb * kB;
    const char* base = stages + (it & 1) * kStage;
    const bf16* Qt = reinterpret_cast<const bf16*>(base);
    const TO* dOt = reinterpret_cast<const TO*>(base + kB * LD * 2);
    const float* Lse = reinterpret_cast<const float*>(
        base + kB * LD * 2 + kB * LDO * sizeof(TO));
    const float* Dsum = Lse + kB;
    if (qb + 1 < n_q) load_stage((it + 1) & 1, q0 + kB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and, first, k and v) is in

    float s[4][4], dp[4][4];
    rows_x_keys<D>(s, Qt, LD, m0, scale_t, Ks, LD, n0);
    rows_x_keys<D>(dp, dOt, LDO, m0, 1.f, Vs, LD, n0);
    float l[2], dsm[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + g + 8 * i;
      l[i] = q0 + r < Sq ? Lse[r] : INFINITY;
      dsm[i] = Dsum[r];
    }
    const bool full =
        (k0 + kB <= Sk) && (!causal || k0 + kB - 1 <= q0 + delta);
    const uint32_t redo =
        p_ds<TO, D>(s, dp, l, dsm, q0, k0, m0, n0, Sk, causal, delta, full);
    // keys n0..n0+15 are slots j = 0, 1 (bits 0-7), the others j = 2, 3
    const int a0 = append_flags<false>(list0, count0, cap, redo & 0xffu, s,
                                       dp, m0, n0, q0);
    const int a1 = a0 < 0 ? -1
                          : append_flags<false>(list1, count1, cap,
                                                redo & 0xff00u, s, dp, m0,
                                                n0, q0);
    if (a0 < 0 || a1 < 0) {
      // a list is full: this tile's flagged elements are recomputed now
      // (those already appended to the first list are dropped from it)
      const TileRows<TO> rows = {Qt, LD, scale_t, dOt, LDO, Ks, Vs, LD};
      redo_now<TO, D>(s, dp, redo, l, dsm, m0, n0, rows);
    } else {
      count0 = a0;
      count1 = a1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = (m0 + g + 8 * i) * LDP + n0 + 8 * j + c;
        if constexpr (kF32) {
          *reinterpret_cast<float2*>(Ps + off) =
              make_float2(s[j][2 * i], s[j][2 * i + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(Ps + off) =
              pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
        }
        *reinterpret_cast<uint32_t*>(dSs + (m0 + g + 8 * i) * kLDS + n0 +
                                     8 * j + c) =
            pack_bf16(dp[j][2 * i], dp[j][2 * i + 1]);
      }
    __syncthreads();  // TO(p) and T(ds) are in
    // keys km..km+15: dv += TO(p)^T . dO, dk += T(ds)^T . q
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      uint32_t a[4];
      lda_t(a, dSs, kLDS, km, kk);
      if constexpr (kF32) {
        uint32_t pa[3][4];
        lda_t_f32(pa, Ps, LDP, km, kk);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t ob[3][2];
          ldb_kn_f32(ob, dOt, LDO, d0 + 8 * j, kk);
          mma_x6(dva[j], pa, ob);
        }
      } else if constexpr (kNT == 1) {
        uint32_t pa[4], b[2];
        lda_t(pa, Ps, LDP, km, kk);
        ldb_kn1(b, dOt, LDO, d0, kk);
        mma_bf16(dva[0], pa, b);
      } else {
        uint32_t pa[4];
        lda_t(pa, Ps, LDP, km, kk);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t b[2][2];
          ldb_kn(b, dOt, LDO, d0 + 8 * j, kk);
          mma_bf16(dva[j], pa, b[0]);
          mma_bf16(dva[j + 1], pa, b[1]);
        }
      }
      if constexpr (kNT == 1) {
        uint32_t b[2];
        ldb_kn1(b, Qt, LD, d0, kk);
        mma_bf16(dka[0], a, b);
      } else {
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t b[2][2];
          ldb_kn(b, Qt, LD, d0 + 8 * j, kk);
          mma_bf16(dka[j], a, b[0]);
          mma_bf16(dka[j + 1], a, b[1]);
        }
      }
    }
    __syncthreads();  // p, ds and this stage are consumed
  }
  cp_async_wait<0>();
  if (lane == 0) {
    Cnt[2 * w] = count0;
    Cnt[2 * w + 1] = count1;
  }
  __syncthreads();  // the lists and their lengths are in
  // the key group km..km+15 (kg = w % 4) lies in the s tiles of warps
  // 4 (kg / 2) + 0..3, in their list kg % 2
  flush_dkv<TO, D>(dka, dva, lists, cap, Cnt, w & 3, qh, st.q[0], oh,
                   st.o[0], scale_t, Ks, Vs, LD, lse + h * (long long)Sq,
                   dsum + h * (long long)Sq, d0);
  __syncthreads();  // every list is read before dk overwrites them

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + km + g + 8 * i;
    if (key >= Sk) continue;
    bf16* ok = dk + key * st.a[0] + h * st.a[1] + d0 + c;
    bf16* ov = dv + key * st.b[0] + h * st.b[1] + d0 + c;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      *reinterpret_cast<uint32_t*>(ok + 8 * j) =
          pack_bf16(dka[j][2 * i] * scale, dka[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(ov + 8 * j) =
          pack_bf16(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (code 0): the tensor-core kernels with three-term bf16 operands

// row stride of an f32 tile: float2 fragment loads are conflict-free
template <int D>
__host__ __device__ constexpr int ld_f32() { return D + 8; }

// rows [r0, r0 + kB) of an (S, H, D) f32 tensor (x already at its head),
// kB * D / 4 / kThreads float4 a thread; rows past n are zeros. load()
// issues the global loads into registers, store() splits the values
// (times sc, rounded in f32) into three bf16 planes of [kB][ld_h] at dst,
// plane i at dst + i * kB * ld_h: one pass per tile, so that the products
// take every term through ldmatrix as the bf16 kernels take their tiles.
template <int D>
struct RowsF32 {
  static constexpr int kN = kB * D / 4 / kThreads;
  float4 v[kN];
  __device__ __forceinline__ void load(const float* __restrict__ x, int r0,
                                       int n, long long ss) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (D / 4), ch = idx % (D / 4);
      v[i] = r0 + r < n ? __ldg(reinterpret_cast<const float4*>(
                              x + (r0 + r) * ss + ch * 4))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(bf16* dst, float sc) const {
    constexpr int LD = ld_h<D>();
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (D / 4), ch = idx % (D / 4);
      uint32_t a[3], b[3];
      split3(v[i].x * sc, v[i].y * sc, a);
      split3(v[i].z * sc, v[i].w * sc, b);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint2*>(dst + t * kB * LD + r * LD + ch * 4) =
            make_uint2(a[t], b[t]);
    }
  }
};

// B of n-tiles n0 and n0 + 8 at depth k0 from three bf16 planes of
// [kB][ld], where B(k, n) = t[n][k]: b[j][i] is term i of n-tile j
__device__ __forceinline__ void ldb_nk_x3(uint32_t b[2][3][2], const bf16* t,
                                          int ld, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t r[2][2];
    ldb_nk(r, t + i * kB * ld, ld, n0, k0);
    b[0][i][0] = r[0][0];
    b[0][i][1] = r[0][1];
    b[1][i][0] = r[1][0];
    b[1][i][1] = r[1][1];
  }
}
// the same from an f32 tile [kB][ld], split into its terms on the way
__device__ __forceinline__ void ldb_nk_x3(uint32_t b[2][3][2],
                                          const float* t, int ld, int n0,
                                          int k0) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(
          t + (n0 + 8 * j + g) * ld + k0 + c + 8 * i);
      uint32_t s[3];
      split3(x.x, x.y, s);
      b[j][0][i] = s[0];
      b[j][1][i] = s[1];
      b[j][2][i] = s[2];
    }
}

// acc = A . B for one warp's 32 rows at m0 x 16 keys at n0 (2 m-tiles x 2
// n-tiles) over depth D: s = (q * scale) . k or dp = dO . v. A from three
// planes of [kB][ld_h] (row-major), B(k, n) = bt[n][k] from three planes
// (bf16) or an f32 tile [kB][ld_f32] split on the way (float). Each 16-deep
// step's products go to a fresh accumulator, which is added to acc in f32:
// chaining every step through one accumulator would lose up to an ulp of
// the running sum a step, always toward zero (an mma aligns its accumulator
// input with the products and truncates below 24 bits).
template <int D, typename TB>
__device__ __forceinline__ void rows_x_keys_x3(float acc[2][2][4],
                                               const bf16* a_p,
                                               const TB* b_t, int m0,
                                               int n0) {
  constexpr int LD = ld_h<D>();
  constexpr int LB = sizeof(TB) == 2 ? ld_h<D>() : ld_f32<D>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[2][3][4], b[2][3][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        lda(a[i][t], a_p + t * kB * LD, LD, m0 + 16 * i, kk);
    ldb_nk_x3(b, b_t, LB, n0, kk);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_x6(part, a[i], b[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
  }
}

// p and ds of the warp's s and dp fragments in place (s -> p, dp -> ds):
// rows m0 + 16 i + g (+8), keys n0 + 8 j + c (+1) of the tile at (q0, k0);
// l and dsm hold the rows' lse and dsum at [2 i + (row >= +8)]. Neither p
// nor ds is rounded (T and TO are the identity for f32). delta = q_off -
// k_off: causal keeps local (i, j) with i + delta >= j.
__device__ __forceinline__ void p_ds_f32(float s[2][2][4], float dp[2][2][4],
                                         const float l[4],
                                         const float dsm[4], int q0, int k0,
                                         int m0, int n0, int Sk, int causal,
                                         int delta, bool full) {
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * i + (e >> 1);
        const int qpos = q0 + m0 + 16 * i + g + 8 * (e >> 1);
        const int kpos = k0 + n0 + 8 * j + c + (e & 1);
        const bool masked =
            !full && (kpos >= Sk || (causal && qpos + delta < kpos));
        const float p = masked ? 0.f : expf(s[i][j][e] - l[r]);
        s[i][j][e] = p;
        dp[i][j][e] = p * (dp[i][j][e] - dsm[r]);
      }
}

// the warp's fragments x (as p_ds_f32 lays them out) into three bf16
// planes of [kB][kLDS] at dst
__device__ __forceinline__ void store_x3(bf16* dst, const float x[2][2][4],
                                         int m0, int n0) {
  const int lane = lane_id(), g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        uint32_t t[3];
        split3(x[i][j][2 * hi], x[i][j][2 * hi + 1], t);
        const int off = (m0 + 16 * i + g + 8 * hi) * kLDS + n0 + 8 * j + c;
#pragma unroll
        for (int u = 0; u < 3; ++u)
          *reinterpret_cast<uint32_t*>(dst + u * kB * kLDS + off) = t[u];
      }
}

// acc += A . B over one tile's 64-deep sum for a warp's 16 rows at m0 x
// columns d0.. (D/16 n-tiles of 8): A from three planes of [kB][kLDS],
// row-major (kTrans false: A(m, k) = t[m][k]) or transposed (A(m, k) =
// t[k][m]); B(k, n) = bt[k][n] from three planes of [kB][ld_h]. The tile's
// 4 steps x 6 products chain through one fresh accumulator, which is
// added to acc in f32 (see rows_x_keys_x3).
template <int D, bool kTrans>
__device__ __forceinline__ void tile_acc_x3(float acc[D / 16][4],
                                            const bf16* a_p,
                                            const bf16* b_p, int m0,
                                            int d0) {
  constexpr int LD = ld_h<D>(), kNT = D / 16;
  float part[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kB; kk += 16) {
    uint32_t a[3][4];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if constexpr (kTrans)
        lda_t(a[t], a_p + t * kB * kLDS, kLDS, m0, kk);
      else
        lda(a[t], a_p + t * kB * kLDS, kLDS, m0, kk);
    }
    if constexpr (kNT == 1) {
      uint32_t b[3][2];
#pragma unroll
      for (int t = 0; t < 3; ++t)
        ldb_kn1(b[t], b_p + t * kB * LD, LD, d0, kk);
      mma_x6(part[0], a, b);
    } else {
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[2][3][2];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          uint32_t r[2][2];
          ldb_kn(r, b_p + t * kB * LD, LD, d0 + 8 * j, kk);
          b[0][t][0] = r[0][0];
          b[0][t][1] = r[0][1];
          b[1][t][0] = r[1][0];
          b[1][t][1] = r[1][1];
        }
        mma_x6(part[j], a, b[0]);
        mma_x6(part[j + 1], a, b[1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// Q (q * scale), dO, K and V as three planes each; ds as three planes of
// [kB][kLDS] in V's space where they fit (D >= 64), else beside it
template <int D>
__host__ __device__ constexpr bool ds_in_v() { return kLDS <= ld_h<D>(); }
template <int D>
constexpr size_t dq_split3_smem() {
  return (size_t)3 * kB * 2 * (4 * ld_h<D>() + (ds_in_v<D>() ? 0 : kLDS));
}
// K and V f32; q (times scale) and dO, p and ds as three planes each; two
// stages of the q tile's lse and dsum
template <int D>
constexpr size_t dkv_split3_smem() {
  return (size_t)kB * (2 * ld_f32<D>() * 4 + 3 * 2 * (2 * ld_h<D>() + 2 * kLDS)
                       + 2 * 2 * 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_split3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq,
                    int Sq, int Sk, Strides st, float scale, int causal,
                    int delta) {
  constexpr int kP = 3 * kB * ld_h<D>();   // one tile's three planes
  constexpr int kNT = D / 16;
  bf16* Qp = reinterpret_cast<bf16*>(dyn_smem());  // q * scale
  bf16* dOp = Qp + kP;
  bf16* Kp = dOp + kP;
  bf16* Vp = Kp + kP;
  // ds, once every warp has taken dP
  bf16* dSp = ds_in_v<D>() ? Vp : Vp + kP;

  const int h = blockIdx.y;
  // the longest causal rows first: the last query tile has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int w = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int m0 = 32 * (w & 1), n0 = 16 * (w >> 1);  // s, dp: rows, keys
  const int mq = 16 * (w & 3), d0 = (D / 2) * (w >> 2);  // dq: rows, cols
  const float* kh = k + h * st.k[1];
  const float* vh = v + h * st.v[1];

  const int n_k = (Sk + kB - 1) / kB;
  // causal: key tiles wholly above the global diagonal of this block are
  // skipped; none is left when the kv shard lies wholly after the block
  int kb_end = n_k;
  if (causal) {
    const int last = q0 + kB - 1 + delta;  // the block's last visible key
    kb_end = last < 0 ? 0 : min(n_k, last / kB + 1);
  }

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (kb_end > 0) {
    RowsF32<D> a, b;
    a.load(q + h * st.q[1], q0, Sq, st.q[0]);
    b.load(dout + h * st.o[1], q0, Sq, st.o[0]);
    a.store(Qp, scale);
    b.store(dOp, 1.f);
    a.load(kh, 0, Sk, st.k[0]);
    b.load(vh, 0, Sk, st.v[0]);
    a.store(Kp, 1.f);
    b.store(Vp, 1.f);
  }
  // the lse and dsum of the warp's rows m0 + 16 (i / 2) + g + 8 (i % 2);
  // rows past Sq take lse = +inf, so their p and ds are 0
  float l[4], dsm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + m0 + 16 * (i >> 1) + g + 8 * (i & 1);
    const bool in = row < Sq;
    l[i] = in ? lse[h * (long long)Sq + row] : INFINITY;
    dsm[i] = in ? dsum[h * (long long)Sq + row] : 0.f;
  }

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB;
    const bool more = kb + 1 < kb_end;
    __syncthreads();  // this tile's K and V (and, first, Q and dO) are in
    float s[2][2][4], dp[2][2][4];
    rows_x_keys_x3<D>(s, Qp, Kp, m0, n0);
    rows_x_keys_x3<D>(dp, dOp, Vp, m0, n0);
    const bool full =
        (k0 + kB <= Sk) && (!causal || k0 + kB - 1 <= q0 + delta);
    p_ds_f32(s, dp, l, dsm, q0, k0, m0, n0, Sk, causal, delta, full);
    __syncthreads();  // every warp has taken dP: V's planes are free
    store_x3(dSp, dp, m0, n0);
    __syncthreads();  // ds is in
    tile_acc_x3<D, false>(acc, dSp, Kp, mq, d0);
    __syncthreads();  // K and ds are consumed
    // the next tile's K and V: loaded here, not into registers during the
    // dq products (that spilled at D=128 and ran slower)
    if (more) {
      RowsF32<D> nk, nv;
      nk.load(kh, k0 + kB, Sk, st.k[0]);
      nv.load(vh, k0 + kB, Sk, st.v[0]);
      nk.store(Kp, 1.f);
      nv.store(Vp, 1.f);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + mq + g + 8 * i;
    if (row >= Sq) continue;
    float* out = dq + row * st.a[0] + h * st.a[1] + d0 + c;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_split3(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, Strides st,
                     float scale, int causal, int delta) {
  constexpr int LF = ld_f32<D>(), kP = 3 * kB * ld_h<D>();
  constexpr int kNT = D / 16;
  float* Kf = reinterpret_cast<float*>(dyn_smem());  // [kB][LF], the block's
  float* Vf = Kf + kB * LF;                          // [kB][LF]
  bf16* Qp = reinterpret_cast<bf16*>(Vf + kB * LF);  // q * scale
  bf16* dOp = Qp + kP;
  bf16* Pp = dOp + kP;                               // p, [kB][kLDS] planes
  bf16* dSp = Pp + 3 * kB * kLDS;                    // ds
  float* Rows = reinterpret_cast<float*>(dSp + 3 * kB * kLDS);  // 2 stages

  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int w = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int m0 = 32 * (w & 1), n0 = 16 * (w >> 1);  // s, dp: rows, keys
  const int km = 16 * (w & 3), d0 = (D / 2) * (w >> 2);  // dk, dv: keys, cols
  const float* qh = q + h * st.q[1];
  const float* oh = dout + h * st.o[1];

  const int n_q = (Sq + kB - 1) / kB;
  // causal: query tiles wholly above the global diagonal see none of these
  // keys; the first tile that does has q0 + kB - 1 + delta >= k0 (none,
  // and zeros written, when the q shard lies wholly before the keys)
  int qb_begin = 0;
  if (causal) {
    const int first = k0 - delta - kB + 1;
    qb_begin = first <= 0 ? 0 : (first + kB - 1) / kB;
  }
  // the lse and dsum of the q tile at q0 into stage sg (rows past Sq zeros)
  auto load_rows = [&](int sg, int q0) {
    const int i = threadIdx.x;
    if (i < 2 * kB) {
      const int row = q0 + (i & (kB - 1));
      const bool in = row < Sq;
      const float* src = i < kB ? lse : dsum;
      cp_async4(Rows + sg * 2 * kB + i,
                in ? src + h * (long long)Sq + row : src, in);
    }
  };

  float dka[kNT][4], dva[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (qb_begin < n_q) {
    cp_tile<float, D>(Kf, LF, k + h * st.k[1], k0, Sk, st.k[0]);
    cp_tile<float, D>(Vf, LF, v + h * st.v[1], k0, Sk, st.v[0]);
    load_rows(0, qb_begin * kB);
    cp_async_commit();
    RowsF32<D> a, b;
    a.load(qh, qb_begin * kB, Sq, st.q[0]);
    b.load(oh, qb_begin * kB, Sq, st.o[0]);
    a.store(Qp, scale);
    b.store(dOp, 1.f);
  }
  for (int qb = qb_begin, it = 0; qb < n_q; ++qb, ++it) {
    const int q0 = qb * kB;
    const bool more = qb + 1 < n_q;
    if (more) load_rows((it + 1) & 1, q0 + kB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's q, dO, lse, dsum (and, first, K, V) are in
    const float* Lse = Rows + (it & 1) * 2 * kB;
    const float* Dsum = Lse + kB;

    float s[2][2][4], dp[2][2][4];
    rows_x_keys_x3<D>(s, Qp, Kf, m0, n0);
    rows_x_keys_x3<D>(dp, dOp, Vf, m0, n0);
    float l[4], dsm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + 16 * (i >> 1) + g + 8 * (i & 1);
      l[i] = q0 + r < Sq ? Lse[r] : INFINITY;
      dsm[i] = Dsum[r];
    }
    const bool full =
        (k0 + kB <= Sk) && (!causal || k0 + kB - 1 <= q0 + delta);
    p_ds_f32(s, dp, l, dsm, q0, k0, m0, n0, Sk, causal, delta, full);
    store_x3(Pp, s, m0, n0);
    store_x3(dSp, dp, m0, n0);
    __syncthreads();  // p and ds are in
    // keys km..km+15: dv += p^T . dO
    tile_acc_x3<D, true>(dva, Pp, dOp, km, d0);
    __syncthreads();  // dO is consumed
    // the next tile's dO (prefetching it into registers across the dv
    // products spilled at D=128 and ran slower than this wait)
    RowsF32<D> nx;
    if (more) {
      nx.load(oh, q0 + kB, Sq, st.o[0]);
      nx.store(dOp, 1.f);
    }
    // dk += ds^T . (q * scale): the scale is taken once per q element
    // here, which moves each term by at most 2^-24 of itself
    tile_acc_x3<D, true>(dka, dSp, Qp, km, d0);
    __syncthreads();  // q, p and ds are consumed
    if (more) {
      nx.load(qh, q0 + kB, Sq, st.q[0]);
      nx.store(Qp, scale);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + km + g + 8 * i;
    if (key >= Sk) continue;
    float* ok = dk + key * st.a[0] + h * st.a[1] + d0 + c;
    float* ov = dv + key * st.b[0] + h * st.b[1] + d0 + c;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      *reinterpret_cast<float2*>(ok + 8 * j) =
          make_float2(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<float2*>(ov + 8 * j) =
          make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// the kernel of (DQ, dtype code, D) and its dynamic shared memory. Code 0:
// f32 throughout; 1: bf16 throughout; 2: bf16 q, k, v and outputs with an
// f32 dO (the ring stats VJP's d_acc)
template <bool DQ, int kCode, int D>
const void* kernel_of(size_t* smem) {
  using TO = typename std::conditional<kCode == 1, bf16, float>::type;
  if constexpr (kCode == 0) {
    *smem = DQ ? dq_split3_smem<D>() : dkv_split3_smem<D>();
    return DQ ? reinterpret_cast<const void*>(flash_bwd_dq_split3<D>)
              : reinterpret_cast<const void*>(flash_bwd_dkv_split3<D>);
  } else {
    *smem = DQ ? dq_mma_smem<TO, D>() : dkv_mma_smem<TO, D>();
    return DQ ? reinterpret_cast<const void*>(flash_bwd_dq_mma<TO, D>)
              : reinterpret_cast<const void*>(flash_bwd_dkv_mma<TO, D>);
  }
}

template <bool DQ, int kCode, int D>
int launch_k(const void* const* ptr, int Sq, int Sk, int H,
             const Strides& st, float scale, int causal, int delta,
             cudaStream_t stream) {
  using T = typename std::conditional<kCode == 0, float, bf16>::type;
  using TO = typename std::conditional<kCode == 1, bf16, float>::type;
  size_t smem;
  const void* fn = kernel_of<DQ, kCode, D>(&smem);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((DQ ? Sq : Sk) + kB - 1) / kB, H);
  const T *q = (const T*)ptr[0], *k = (const T*)ptr[1],
          *v = (const T*)ptr[2];
  const TO* dout = (const TO*)ptr[3];
  const float *lse = (const float*)ptr[4], *dsum = (const float*)ptr[5];
  T *a = (T*)ptr[6], *b = (T*)ptr[7];
  if constexpr (kCode == 0) {
    if (DQ)
      flash_bwd_dq_split3<D><<<grid, kThreads, smem, stream>>>(
          q, k, v, dout, lse, dsum, a, Sq, Sk, st, scale, causal, delta);
    else
      flash_bwd_dkv_split3<D><<<grid, kThreads, smem, stream>>>(
          q, k, v, dout, lse, dsum, a, b, Sq, Sk, st, scale, causal, delta);
  } else {
    if (DQ)
      flash_bwd_dq_mma<TO, D><<<grid, kThreads, smem, stream>>>(
          q, k, v, dout, lse, dsum, a, Sq, Sk, st, scale, causal, delta);
    else
      flash_bwd_dkv_mma<TO, D><<<grid, kThreads, smem, stream>>>(
          q, k, v, dout, lse, dsum, a, b, Sq, Sk, st, scale, causal, delta);
  }
  return (int)cudaGetLastError();
}

template <bool DQ, int D>
int launch_c(int dtype, const void* const* ptr, int Sq, int Sk, int H,
             const Strides& st, float scale, int causal, int delta,
             cudaStream_t stream) {
  switch (dtype) {
#define CASE(CC)                                                        \
  case CC:                                                              \
    return launch_k<DQ, CC, D>(ptr, Sq, Sk, H, st, scale, causal, delta, \
                               stream);
    CASE(0)
    CASE(1)
    CASE(2)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(const void* const* ptr, int Sq, int Sk, int H, int D, int dtype,
           const long long* s, float scale, int causal, int q_off,
           int k_off, void* stream) {
  const Strides st = {{s[0], s[1]}, {s[2], s[3]},   {s[4], s[5]},
                      {s[6], s[7]}, {s[8], s[9]}, {s[10], s[11]}};
  cudaStream_t cs = (cudaStream_t)stream;
  const int delta = q_off - k_off;
  switch (D) {
#define CASE(DD)                                                          \
  case DD:                                                                \
    return launch_c<DQ, DD>(dtype, ptr, Sq, Sk, H, st, scale, causal,     \
                            delta, cs);
    CASE(16)
    CASE(32)
    CASE(64)
    CASE(128)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
const void* kernel_at(int dtype, int D, size_t* smem) {
#define CASE(CC, DD) \
  if (dtype == CC && D == DD) return kernel_of<DQ, CC, DD>(smem);
#define CASES(DD) CASE(0, DD) CASE(1, DD) CASE(2, DD)
  CASES(16) CASES(32) CASES(64) CASES(128)
#undef CASES
#undef CASE
  return nullptr;
}

}  // namespace

extern "C" {

// q (Sq, H, D), k/v (Sk, H, D), dout (Sq, H, D), each with unit stride along
// D and 16-byte aligned rows; dtype 0 = all f32, 1 = all bf16, 2 = bf16 with
// an f32 dout; lse and dsum (H, Sq) f32, contiguous. D in {16, 32, 64, 128}.
// strides: 12 element strides {seq, head} of q, k, v, dout, then of the
// outputs (dq; or dk, dv). q_off, k_off: the blocks' global positions (0, 0
// for the normalized VJP). Each returns a cudaError_t (0 = launched).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dq, int Sq, int Sk, int H, int D, int dtype,
                        const long long* strides, float scale, int causal,
                        int q_off, int k_off, void* stream) {
  const void* ptr[8] = {q, k, v, dout, lse, dsum, dq, nullptr};
  return launch<true>(ptr, Sq, Sk, H, D, dtype, strides, scale, causal,
                      q_off, k_off, stream);
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         void* dk, void* dv, int Sq, int Sk, int H, int D,
                         int dtype, const long long* strides, float scale,
                         int causal, int q_off, int k_off, void* stream) {
  const void* ptr[8] = {q, k, v, dout, lse, dsum, dk, dv};
  return launch<false>(ptr, Sq, Sk, H, D, dtype, strides, scale, causal,
                       q_off, k_off, stream);
}

// The dq (dq = 1) or dk/dv kernel of (dtype, D): its dynamic shared memory
// per block and how many of its blocks fit one SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
int flash_bwd_occupancy(int dq, int dtype, int D, int* smem_bytes,
                        int* blocks_per_sm) {
  size_t smem = 0;
  const void* fn = dq ? kernel_at<true>(dtype, D, &smem)
                      : kernel_at<false>(dtype, D, &smem);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, smem);
}

}  // extern "C"
