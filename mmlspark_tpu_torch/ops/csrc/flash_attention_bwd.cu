// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// WHAT THEY COMPUTE
//   For each head h, query row i and key j (q, k, v, dO in the public
//   (S, H, D) layout, read through their strides; Sk may differ from Sq),
//   given the forward's lse (H, Sq) f32 and dsum (H, Sq) f32:
//     s[i, j]  = (q[i] * scale) . k[j]            q scaled in its own type
//     s[i, j]  = -1e30 where j >= Sk, or causal and i < j (raw positions)
//     p[i, j]  = exp(s[i, j] - lse[i])
//     dp[i, j] = dO[i] . v[j]
//     ds[i, j] = p[i, j] (dp[i, j] - dsum[i])
//     dq[i]    = scale * sum_j T(ds[i, j]) k[j]         flash_bwd_dq_kernel
//     dv[j]    = sum_i T(p[i, j]) dO[i]                 flash_bwd_dkv_kernel
//     dk[j]    = scale * sum_i T(ds[i, j]) q[i]         (q unscaled)
//   with T(x) = x rounded to the inputs' type (identity for f32) and every
//   sum in f32: the contract of
//   mmlspark_tpu_torch/ops/flash_attention.py::_flash_backward_plain.
//   lse and dsum are inputs, not O, so the ring slice's stats backward
//   (lse := m, dsum := -dl) can call the same kernels.
//
// WHICH TPU KERNELS THEY REPLACE
//   mmlspark_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:478,
//   pallas_call :621) and ::_flash_bwd_dkv_kernel (:516, pallas_call :642),
//   with _bwd_common (:445) and the visibility tests _bwd_visible_t /
//   _bwd_full_t (:559-579). The TPU walks a sequential grid axis carrying
//   the dq (or dk, dv) sums in VMEM scratch; here one block owns a tile of
//   64 query rows (dq) or 64 keys (dk/dv) of one head and loops over the
//   other side's tiles itself, so nothing carries between blocks and no
//   atomics are needed: each kernel is deterministic from run to run.
//   Padded copies are gone: tiles are read through the strides, ragged
//   edges are masked, and query rows past Sq get lse = +inf (p = 0), as the
//   reference's padding does.
//
// WHAT BOUNDS THEM
//   Operations. The least work of any backward is 5 products of
//   2 * Sq * Sk * D per head (S, dP, dV, dK, dQ), halved when causal; this
//   two-kernel design does 7 (the dq kernel rebuilds S and dP). At
//   S=16384, H=8, D=128, causal, that least work is 20.5 ms at the H100's
//   67 TFLOP/s f32 rate and 1.39 ms at its 989 TFLOP/s bf16 tensor-core
//   rate (twice that without the mask), against ~0.1 ms for the bytes. These first kernels run every product on the
//   CUDA cores in f32 FMAs (bf16 is converted to f32 as it enters shared
//   memory), as flash_fwd_kernel does; mma.sync / wgmma / TMA are later
//   work.
//
// DESIGN
//   Block: 256 threads = 16 row groups of 16 lanes. Tiles: 64 query rows x
//   64 keys. Every tile sits in shared memory transposed, [D][68] f32 (a
//   row of 64 plus 4 floats of padding), which serves both products
//   without a second copy: the score products read float4s along the
//   64-wide dimension (thread (r, c) holds rows 4r..4r+3 x keys 4c..4c+3 of
//   s and dp), and the accumulating products read single columns, where
//   the padding spreads a warp's 16 lanes over 8 banks (2-way conflict, not
//   16-way). The accumulating products give thread (r, c) rows (dq) or keys
//   (dk, dv) 4r..4r+3 x columns c, c+16, ..., so D/16 columns: 32 (dq) or
//   64 (dk and dv) accumulators at D=128, far from a spill. p and ds pass
//   between the two thread layouts through shared memory, rounded to T.
//   Shared memory at D=128: dq 157,184 B (q*scale, dO, k, v, ds^T), dk/dv
//   209,408 B (k, v, q*scale, q, dO, p, ds): one block per SM, 8 warps.
//   Above 48 KB it is dynamic, opted into with cudaFuncSetAttribute.
//   Causal: the dq kernel stops at the diagonal tile and its blocks run
//   the longest rows first; the dk/dv kernel starts at the diagonal tile.
//   Tiles that need no mask (every key < Sk and, causal, below every row)
//   skip the mask pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // query rows and keys per tile
constexpr int kLD = kB + 4;     // padded stride of a transposed tile
constexpr int kThreads = 256;   // 16 row groups x 16 lanes
constexpr float kMask = -1e30f;

// strides in elements, {seq, head} of q, k, v, dO and the outputs (a: dq
// or dk, b: dv)
struct Strides {
  long long q[2], k[2], v[2], o[2], a[2], b[2];
};

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

// rows [r0, r0 + kB) of x (S, H, D), head h, into transposed f32 tiles
// [D][kLD]: `raw` gets the values, `scaled` gets T(x * scale_t); either may
// be null. Rows past n are zeros. A warp covers 32 rows of one 16-byte
// chunk, so the transposing stores are conflict-free.
template <typename T, int D>
__device__ __forceinline__ void load_t(float* scaled, float* raw,
                                       const T* __restrict__ x, int r0, int n,
                                       int h, long long ss, long long hs,
                                       float scale_t) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  const T tag{};
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx % kB, ch = idx / kB;
    float f[kVec] = {};
    if (r0 + r < n)
      unpack(*reinterpret_cast<const uint4*>(x + (r0 + r) * ss + h * hs +
                                             ch * kVec),
             f, tag);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int o = (ch * kVec + e) * kLD + r;
      if (scaled) scaled[o] = round_to(f[e] * scale_t, tag);
      if (raw) raw[o] = f[e];
    }
  }
}

// lse and dsum of query rows [q0, q0 + kB); rows past Sq get lse = +inf
// and dsum = 0, so their p and ds are exactly 0
__device__ __forceinline__ void load_rows(float* Lse, float* Dsum,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ dsum,
                                          int q0, int Sq, int h) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const int row = q0 + i;
    const bool in = row < Sq;
    Lse[i] = in ? lse[h * (long long)Sq + row] : INFINITY;
    Dsum[i] = in ? dsum[h * (long long)Sq + row] : 0.f;
  }
}

// p and ds of query rows 4r..4r+3 x keys 4c..4c+3 of the tile at (q0, k0),
// the reference's _bwd_common
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const float* Qt, const float* dOt, const float* Kt, const float* Vt,
    const float* Lse, const float* Dsum, int q0, int k0, int Sk, int causal,
    bool full, int r, int c, float p[4][4], float ds[4][4]) {
  float dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 qv = *reinterpret_cast<const float4*>(Qt + d * kLD + 4 * r);
    const float4 ov = *reinterpret_cast<const float4*>(dOt + d * kLD + 4 * r);
    const float4 kv = *reinterpret_cast<const float4*>(Kt + d * kLD + 4 * c);
    const float4 vv = *reinterpret_cast<const float4*>(Vt + d * kLD + 4 * c);
    const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
    const float orr[4] = {ov.x, ov.y, ov.z, ov.w};
    const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
    const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(qr[i], kr[j], p[i][j]);     // s, for now
        dp[i][j] = fmaf(orr[i], vr[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = Lse[4 * r + i], dsm = Dsum[4 * r + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = p[i][j];
      if (!full) {
        const int qpos = q0 + 4 * r + i, kpos = k0 + 4 * c + j;
        if (kpos >= Sk || (causal && qpos < kpos)) s = kMask;
      }
      p[i][j] = expf(s - l);
      ds[i][j] = p[i][j] * (dp[i][j] - dsm);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(4 * D * kLD + kB * kLD + 2 * kB);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (size_t)(5 * D * kLD + 2 * kB * kLD + 2 * kB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int Sq, int Sk, Strides st, float scale, int causal) {
  constexpr int kC = D / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kLD] T(q * scale)
  float* dOt = Qt + D * kLD;                    // [D][kLD]
  float* Kt = dOt + D * kLD;                    // [D][kLD]
  float* Vt = Kt + D * kLD;                     // [D][kLD]
  float* DSt = Vt + D * kLD;                    // [kB keys][kLD] T(ds)^T
  float* Lse = DSt + kB * kLD;
  float* Dsum = Lse + kB;

  const int h = blockIdx.y;
  // the longest causal rows first: the last query tile has the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int t = threadIdx.x, r = t >> 4, c = t & 15;
  const T tag{};
  const float scale_t = round_to(scale, tag);

  load_t<T, D>(Qt, nullptr, q, q0, Sq, h, st.q[0], st.q[1], scale_t);
  load_t<T, D>(nullptr, dOt, dout, q0, Sq, h, st.o[0], st.o[1], 1.f);
  load_rows(Lse, Dsum, lse, dsum, q0, Sq, h);

  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) acc[i][jj] = 0.f;

  const int n_k = (Sk + kB - 1) / kB;
  // causal: key tiles wholly above the diagonal of this block are skipped
  const int kb_end = causal ? min(n_k, (q0 + kB - 1) / kB + 1) : n_k;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous tile's k, v and ds are consumed
    load_t<T, D>(nullptr, Kt, k, k0, Sk, h, st.k[0], st.k[1], 1.f);
    load_t<T, D>(nullptr, Vt, v, k0, Sk, h, st.v[0], st.v[1], 1.f);
    __syncthreads();
    const bool full = (k0 + kB <= Sk) && (!causal || k0 + kB - 1 <= q0);
    float p[4][4], ds[4][4];
    tile_p_ds<D>(Qt, dOt, Kt, Vt, Lse, Dsum, q0, k0, Sk, causal, full, r, c,
                 p, ds);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(DSt + (4 * c + j) * kLD + 4 * r) =
          make_float4(round_to(ds[0][j], tag), round_to(ds[1][j], tag),
                      round_to(ds[2][j], tag), round_to(ds[3][j], tag));
    __syncthreads();
    // acc += T(ds) . k over the tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(DSt + kk * kLD +
                                                         4 * r);
#pragma unroll
      for (int jj = 0; jj < kC; ++jj) {
        const float kv = Kt[(c + 16 * jj) * kLD + kk];
        acc[0][jj] = fmaf(d4.x, kv, acc[0][jj]);
        acc[1][jj] = fmaf(d4.y, kv, acc[1][jj]);
        acc[2][jj] = fmaf(d4.z, kv, acc[2][jj]);
        acc[3][jj] = fmaf(d4.w, kv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * r + i;
    if (row >= Sq) continue;
    T* out = dq + row * st.a[0] + h * st.a[1];
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) store(out + c + 16 * jj,
                                          acc[i][jj] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, Strides st,
                     float scale, int causal) {
  constexpr int kC = D / 16;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][kLD], this block's
  float* Vt = Kt + D * kLD;                     // [D][kLD]
  float* Qt = Vt + D * kLD;                     // [D][kLD] T(q * scale)
  float* Qr = Qt + D * kLD;                     // [D][kLD] q
  float* dOt = Qr + D * kLD;                    // [D][kLD]
  float* Ps = dOt + D * kLD;                    // [kB rows][kLD] T(p)
  float* DSs = Ps + kB * kLD;                   // [kB rows][kLD] T(ds)
  float* Lse = DSs + kB * kLD;
  float* Dsum = Lse + kB;

  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int t = threadIdx.x, r = t >> 4, c = t & 15;
  const T tag{};
  const float scale_t = round_to(scale, tag);

  load_t<T, D>(nullptr, Kt, k, k0, Sk, h, st.k[0], st.k[1], 1.f);
  load_t<T, D>(nullptr, Vt, v, k0, Sk, h, st.v[0], st.v[1], 1.f);

  float dka[4][kC], dva[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) dka[i][jj] = dva[i][jj] = 0.f;

  const int n_q = (Sq + kB - 1) / kB;
  // causal: query tiles wholly above the diagonal see none of these keys
  const int qb_begin = causal ? k0 / kB : 0;
  for (int qb = qb_begin; qb < n_q; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();  // the previous tile's q, dO, p and ds are consumed
    load_t<T, D>(Qt, Qr, q, q0, Sq, h, st.q[0], st.q[1], scale_t);
    load_t<T, D>(nullptr, dOt, dout, q0, Sq, h, st.o[0], st.o[1], 1.f);
    load_rows(Lse, Dsum, lse, dsum, q0, Sq, h);
    __syncthreads();
    const bool full = (k0 + kB <= Sk) && (!causal || k0 + kB - 1 <= q0);
    float p[4][4], ds[4][4];
    tile_p_ds<D>(Qt, dOt, Kt, Vt, Lse, Dsum, q0, k0, Sk, causal, full, r, c,
                 p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(Ps + (4 * r + i) * kLD + 4 * c) =
          make_float4(round_to(p[i][0], tag), round_to(p[i][1], tag),
                      round_to(p[i][2], tag), round_to(p[i][3], tag));
      *reinterpret_cast<float4*>(DSs + (4 * r + i) * kLD + 4 * c) =
          make_float4(round_to(ds[i][0], tag), round_to(ds[i][1], tag),
                      round_to(ds[i][2], tag), round_to(ds[i][3], tag));
    }
    __syncthreads();
    // keys 4r..4r+3: dv += T(p)^T . dO, dk += T(ds)^T . q
#pragma unroll 2
    for (int qq = 0; qq < kB; ++qq) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + qq * kLD +
                                                         4 * r);
      const float4 d4 = *reinterpret_cast<const float4*>(DSs + qq * kLD +
                                                         4 * r);
#pragma unroll
      for (int jj = 0; jj < kC; ++jj) {
        const float ov = dOt[(c + 16 * jj) * kLD + qq];
        const float qv = Qr[(c + 16 * jj) * kLD + qq];
        dva[0][jj] = fmaf(p4.x, ov, dva[0][jj]);
        dva[1][jj] = fmaf(p4.y, ov, dva[1][jj]);
        dva[2][jj] = fmaf(p4.z, ov, dva[2][jj]);
        dva[3][jj] = fmaf(p4.w, ov, dva[3][jj]);
        dka[0][jj] = fmaf(d4.x, qv, dka[0][jj]);
        dka[1][jj] = fmaf(d4.y, qv, dka[1][jj]);
        dka[2][jj] = fmaf(d4.z, qv, dka[2][jj]);
        dka[3][jj] = fmaf(d4.w, qv, dka[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * r + i;
    if (key >= Sk) continue;
    T* ok = dk + key * st.a[0] + h * st.a[1];
    T* ov = dv + key * st.b[0] + h * st.b[1];
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      store(ok + c + 16 * jj, dka[i][jj] * scale);
      store(ov + c + 16 * jj, dva[i][jj]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* const* ptr, int Sq, int Sk, int H,
              const Strides& st, float scale, int causal,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kB - 1) / kB, H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2], (const T*)ptr[3],
      (const float*)ptr[4], (const float*)ptr[5], (T*)ptr[6], Sq, Sk, st,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* const* ptr, int Sq, int Sk, int H,
               const Strides& st, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sk + kB - 1) / kB, H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2], (const T*)ptr[3],
      (const float*)ptr[4], (const float*)ptr[5], (T*)ptr[6], (T*)ptr[7], Sq,
      Sk, st, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, bool DQ>
int launch_d(int D, const void* const* ptr, int Sq, int Sk, int H,
             const Strides& st, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
#define CASE(DD)                                                      \
  case DD:                                                            \
    return DQ ? launch_dq<T, DD>(ptr, Sq, Sk, H, st, scale, causal,   \
                                 stream)                              \
              : launch_dkv<T, DD>(ptr, Sq, Sk, H, st, scale, causal,  \
                                  stream);
    CASE(16)
    CASE(32)
    CASE(64)
    CASE(128)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(const void* const* ptr, int Sq, int Sk, int H, int D, int dtype,
           const long long* s, float scale, int causal, void* stream) {
  const Strides st = {{s[0], s[1]}, {s[2], s[3]},   {s[4], s[5]},
                      {s[6], s[7]}, {s[8], s[9]}, {s[10], s[11]}};
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float, DQ>(D, ptr, Sq, Sk, H, st, scale, causal, cs);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, DQ>(D, ptr, Sq, Sk, H, st, scale, causal,
                                       cs);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (Sq, H, D), k/v (Sk, H, D), dout (Sq, H, D) of one type (dtype 0 =
// f32, 1 = bf16), each with unit stride along D and 16-byte aligned rows;
// lse and dsum (H, Sq) f32, contiguous. D in {16, 32, 64, 128}.
// strides: 12 element strides {seq, head} of q, k, v, dout, then of the
// outputs (dq; or dk, dv). Each returns a cudaError_t (0 = launched).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dq, int Sq, int Sk, int H, int D, int dtype,
                        const long long* strides, float scale, int causal,
                        void* stream) {
  const void* ptr[8] = {q, k, v, dout, lse, dsum, dq, nullptr};
  return launch<true>(ptr, Sq, Sk, H, D, dtype, strides, scale, causal,
                      stream);
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         void* dk, void* dv, int Sq, int Sk, int H, int D,
                         int dtype, const long long* strides, float scale,
                         int causal, void* stream) {
  const void* ptr[8] = {q, k, v, dout, lse, dsum, dk, dv};
  return launch<false>(ptr, Sq, Sk, H, D, dtype, strides, scale, causal,
                       stream);
}

}  // extern "C"
