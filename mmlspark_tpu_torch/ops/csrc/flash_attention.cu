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
//   normalized (flash_fwd_kernel<T, D, true>; offsets 0):
//     o[i]    = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)   in q's type
//     lse[i]  = m_i + log(max(l_i, 1e-30))                         f32
//     the contract of flash_attention.py::_flash_forward_lse_plain;
//   stats (flash_fwd_kernel<T, D, false>), one (q shard, kv shard) pair of
//   ring attention:
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
// MASKING (kept from the reference, :103-152)
//   Masked scores are -1e30, not -inf. A k tile wholly above the global
//   diagonal (k_off + k0 > q_off + q0 + 63) is skipped; a tile needing no
//   mask (every key < Sk and, causal, every key at or below every row of the
//   block) takes the maskless branch. p is deliberately left unmasked: a
//   masked entry contributes exp(-1e30 - m) = 0 as soon as its row has seen
//   one valid key. On the normalized path every row does (causal row i sees
//   key 0). In the stats form a row may see none: when every tile of its
//   block is skipped (a kv shard wholly after the q shard) it keeps its
//   initial acc = 0, l = 0, m = -1e30; when a computed tile masks all of its
//   keys (offsets off the 64-key grid) it carries finite garbage (p = 1 on
//   masked keys) until a visible key resets it through alpha = 0, and a row
//   that never sees one ends flagged by m == -1e30, which the ring merge
//   weighs with exp(-1e30 - m_new) = 0. Every output stays finite. Rows past
//   Sq are computed on zeros and never written.
//
// WHAT BOUNDS IT
//   Operations: 4 * Sq * Sk * D * H FLOPs (half of that causal) against
//   ~256 MB of q/k/v/o at S=16384, H=8, D=128 in f32 -- 16.4 ms at the
//   H100's 67 TFLOP/s f32 rate, 1.11 ms at its 989 TFLOP/s bf16 tensor-core
//   rate, against 0.08 ms for the bytes. This first kernel does nothing
//   about that yet: both products run on the CUDA cores in f32 FMAs (bf16
//   is converted to f32 as it enters shared memory), with register
//   micro-tiles of 4 rows x 8 keys (scores) and 4 rows x D/8 columns (PV).
//   Tensor cores (mma.sync / wgmma) and TMA-fed pipelines are later work.
//
// DESIGN
//   Block: 128 threads = 16 row groups of 8 lanes; a group owns 4 query
//   rows. Tile: 64 query rows x 64 keys (chosen for the card, not taken
//   from the TPU's VMEM-sized blocks): shared memory holds q^T (D x 64),
//   k^T (D x 64), v (64 x D) and p (64 x 64) in f32, 112 KB at D=128, so
//   two blocks fit one SM. Lane c of a group holds keys {4c..4c+3,
//   32+4c..32+4c+3} of its rows' scores (conflict-free float4 reads of
//   k^T) and columns {4(c+8j)..} of the accumulator, so D is split across
//   the lanes and no thread holds a whole row. Row maxima and sums are
//   reduced over the 8 lanes with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = 8;       // keys per thread in a score tile
constexpr float kMask = -1e30f;

// 16 bytes of T as floats (exact: bf16 -> f32 is a shift)
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// x rounded to T and back
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the key index within the tile of slot j of lane c
__device__ __forceinline__ int key_of(int c, int j) {
  return (j < 4 ? 4 * c : 32 + 4 * c) + (j & 3);
}

// kNorm: o is the normalized output in T and r0 the lse; otherwise o is the
// f32 accumulator, r0 the row max m and r1 the row sum l
template <typename T, int D, bool kNorm>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 std::conditional_t<kNorm, T, float>* __restrict__ o,
                 float* __restrict__ r0, float* __restrict__ r1, int Sq,
                 int Sk, long long q_ss, long long q_hs, long long k_ss,
                 long long k_hs, long long v_ss, long long v_hs,
                 long long o_ss, long long o_hs, float scale, int causal,
                 int q_off, int k_off) {
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte load
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
  const T tag{};          // selects the overloads for T

  // q tile, scaled in T, transposed; a warp covers 32 rows of one chunk so
  // the transposing stores are conflict-free
  const float scale_t = round_to(scale, tag);
  for (int idx = t; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx % kBQ, ch = idx / kBQ;
    float f[kVec] = {};
    if (q0 + r < Sq)
      unpack(*reinterpret_cast<const uint4*>(q + (q0 + r) * q_ss + h * q_hs +
                                             ch * kVec),
             f, tag);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      Qt[(ch * kVec + e) * kBQ + r] = round_to(f[e] * scale_t, tag);
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
               f, tag);
#pragma unroll
      for (int e = 0; e < kVec; ++e) Kt[(ch * kVec + e) * kBK + r] = f[e];
    }
    for (int idx = t; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx % kChunks;
      float f[kVec] = {};
      if (k0 + r < Sk)
        unpack(*reinterpret_cast<const uint4*>(v + (k0 + r) * v_ss + h * v_hs +
                                               ch * kVec),
               f, tag);
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
        pr[j] = round_to(p, tag);
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
        store(orow + 4 * col, acc[i][jj].x / den);
        store(orow + 4 * col + 1, acc[i][jj].y / den);
        store(orow + 4 * col + 2, acc[i][jj].z / den);
        store(orow + 4 * col + 3, acc[i][jj].w / den);
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
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * kBQ + D * kBK + kBK * D + kBQ * kBK);
}

template <typename T, int D, bool kNorm>
int launch(const void* q, const void* k, const void* v, void* o, void* r0,
           void* r1, int Sq, int Sk, int H, const long long* st, float scale,
           int causal, int q_off, int k_off, cudaStream_t stream) {
  using OutT = std::conditional_t<kNorm, T, float>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kNorm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H);
  flash_fwd_kernel<T, D, kNorm><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (OutT*)o, (float*)r0,
      (float*)r1, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <bool kNorm>
int launch_dt(int dtype, int D, const void* q, const void* k, const void* v,
              void* o, void* r0, void* r1, int Sq, int Sk, int H,
              const long long* st, float scale, int causal, int q_off,
              int k_off, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CASE(TT, DD)                                                      \
  if (D == DD)                                                            \
    return launch<TT, DD, kNorm>(q, k, v, o, r0, r1, Sq, Sk, H, st, scale, \
                                 causal, q_off, k_off, s);
  if (dtype == 0) {
    CASE(float, 16) CASE(float, 32) CASE(float, 64) CASE(float, 128)
  } else if (dtype == 1) {
    CASE(__nv_bfloat16, 16) CASE(__nv_bfloat16, 32)
    CASE(__nv_bfloat16, 64) CASE(__nv_bfloat16, 128)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
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

}  // extern "C"
