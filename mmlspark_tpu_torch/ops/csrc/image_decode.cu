// The image decoders' kernels on the card: D1 jpeg_idct_islow, D2
// jpeg_upsample_ycc_rgb and D3 png_unfilter (ops/image_decode.py holds
// their wrappers and plain PyTorch versions, which they equal bit for bit).
//
// None replaces a TPU kernel: the reference decodes with PIL on the host.
// Each is bound by the bytes it moves, a few integer operations a byte;
// each is written to be right and simple, and takes a whole batch of
// images in one launch through an int64 table of per-image (or per-plane,
// per-pass) offsets and sizes.
//
// D1: libjpeg's jidctint.c (CONST_BITS 13, PASS1_BITS 2, DESCALE), after
// dequantizing, in 64-bit arithmetic where libjpeg's JLONG is 64-bit and
// 32-bit for its int workspace; each output masked with 0x3FF before the
// range table, as libjpeg does. 8 threads a block of coefficients: thread
// r takes column r in pass 1 and row r in pass 2, the workspace (the
// transpose) in shared memory; each thread stores its row's 8 bytes at
// once.
// D2: libjpeg-turbo's fancy upsampling (fullsize, h2v1, h2v2) and
// jdcolor.c's YCbCr -> RGB, one thread per output pixel; the last real
// sample stands in past a component's downsampled width, and its last
// real row below its height, as libjpeg-turbo's edge handling and
// jdmainct.c's context rows give.
// D3: PNG's filters. Avg and Paeth chain along a row and Up down a
// column, so a block walks one image pass by anti-diagonals: thread t
// owns row t of a band of blockDim.x rows and does pixel x at step t + x,
// when its left, upper and upper-left neighbours are done; one barrier a
// step makes them visible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdctBlocks = 32;          // coefficient blocks a CTA
constexpr int kThreads = 256;
constexpr int kBlocksPerImage = 64;      // D2's CTAs along one image
constexpr int kMaxGridY = 65535;
constexpr int kColorCols = 4 + 3 * 6;    // ops/image_decode.COLOR_COLS
constexpr int kPngCols = 5;              // ops/image_decode.PNG_PASS

// jidctint.c's FIX_* at CONST_BITS = 13
constexpr long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
constexpr long long F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
constexpr long long F1961 = 16069, F2053 = 16819, F2562 = 20995,
                    F3072 = 25172;

__device__ __forceinline__ void idct_1d(const long long* x, long long* y,
                                        int shift) {
  long long z1 = (x[2] + x[6]) * F0541;
  const long long tmp2 = z1 + x[6] * -F1847;
  const long long tmp3 = z1 + x[2] * F0765;
  const long long tmp0 = (x[0] + x[4]) * 8192;     // << CONST_BITS
  const long long tmp1 = (x[0] - x[4]) * 8192;
  const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  long long z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const long long z5 = (z3 + z4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const long long half = 1LL << (shift - 1);
  y[0] = (tmp10 + t3 + half) >> shift;
  y[7] = (tmp10 - t3 + half) >> shift;
  y[1] = (tmp11 + t2 + half) >> shift;
  y[6] = (tmp11 - t2 + half) >> shift;
  y[2] = (tmp12 + t1 + half) >> shift;
  y[5] = (tmp12 - t1 + half) >> shift;
  y[3] = (tmp13 + t0 + half) >> shift;
  y[4] = (tmp13 - t0 + half) >> shift;
}

// libjpeg's post-IDCT range table at (v & 0x3FF)
__device__ __forceinline__ uint32_t range_limit(long long v) {
  const int s = (((int)(v & 1023)) ^ 512) - 512;
  return (uint32_t)min(max(s + 128, 0), 255);
}

__global__ void __launch_bounds__(kThreads)
jpeg_idct_islow(const int16_t* __restrict__ coefs,
                const int32_t* __restrict__ quant,
                const long long* __restrict__ block_plane,
                const long long* __restrict__ planes,
                uint8_t* __restrict__ out, long long n_blocks) {
  __shared__ int ws[kIdctBlocks][64];
  const int slot = threadIdx.x / 8, r = threadIdx.x % 8;
  const long long b = (long long)blockIdx.x * kIdctBlocks + slot;
  const bool live = b < n_blocks;
  long long x[8], y[8];
  long long p = 0;
  if (live) {
    p = block_plane[b];
    const int16_t* c = coefs + b * 64;
    const int32_t* q = quant + p * 64;
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = (long long)c[k * 8 + r] * q[k * 8 + r];
    idct_1d(x, y, 11);                     // CONST_BITS - PASS1_BITS
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[slot][k * 8 + r] = (int)y[k];
  }
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = ws[slot][r * 8 + k];
  idct_1d(x, y, 18);                       // CONST_BITS + PASS1_BITS + 3
  const long long* pl = planes + p * 3;    // out_off, wb, block0
  const long long j = b - pl[2], wb = pl[1];
  const long long by = j / wb, bx = j % wb;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo |= range_limit(y[k]) << (8 * k);
    hi |= range_limit(y[k + 4]) << (8 * k);
  }
  // planes start at multiples of 64 bytes and rows at multiples of 8
  *reinterpret_cast<uint2*>(out + pl[0] + (by * 8 + r) * (wb * 8) + bx * 8) =
      make_uint2(lo, hi);
}

// one component's sample at output pixel (y, x), upsampled
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ planes,
                                         const long long* c, int y, int x) {
  const uint8_t* p = planes + c[0];
  const long long stride = c[1];
  const int dw = (int)c[2], dh = (int)c[3], hf = (int)c[4], vf = (int)c[5];
  if (hf == 1) return p[y * stride + x];
  const int i = x >> 1;
  if (vf == 1) {                           // h2v1
    const uint8_t* row = p + y * stride;
    const int cur = row[i];
    if ((x & 1) == 0) return i == 0 ? cur : (3 * cur + row[i - 1] + 1) >> 2;
    return i == dw - 1 ? cur : (3 * cur + row[i + 1] + 2) >> 2;
  }
  const int r = y >> 1;                    // h2v2
  const int r2 = (y & 1) ? min(r + 1, dh - 1) : max(r - 1, 0);
  const uint8_t* a = p + r * stride;
  const uint8_t* b = p + r2 * stride;
  const int cur = 3 * a[i] + b[i];
  if ((x & 1) == 0) {
    if (i == 0) return (4 * cur + 8) >> 4;
    return (3 * cur + 3 * a[i - 1] + b[i - 1] + 8) >> 4;
  }
  if (i == dw - 1) return (4 * cur + 7) >> 4;
  return (3 * cur + 3 * a[i + 1] + b[i + 1] + 7) >> 4;
}

// jdcolor.c's build_ycc_rgb_table at SCALEBITS = 16: FIX(1.402),
// FIX(1.772), FIX(0.71414), FIX(0.34414)
constexpr int kCrR = 91881, kCbB = 116130, kCrG = 46802, kCbG = 22554;

__global__ void __launch_bounds__(kThreads)
jpeg_upsample_ycc_rgb(const uint8_t* __restrict__ planes,
                      const long long* __restrict__ info,
                      uint8_t* __restrict__ out) {
  const long long* m = info + (long long)blockIdx.y * kColorCols;
  const int h = (int)m[1], w = (int)m[2], color = (int)m[3];
  uint8_t* o = out + m[0];
  const long long n = (long long)h * w;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int y = (int)(i / w), x = (int)(i % w);
    int rgb[3];
    const int s0 = upsampled(planes, m + 4, y, x);
    if (color == 0) {
      rgb[0] = rgb[1] = rgb[2] = s0;
    } else {
      const int s1 = upsampled(planes, m + 10, y, x);
      const int s2 = upsampled(planes, m + 16, y, x);
      if (color == 2) {
        rgb[0] = s0;
        rgb[1] = s1;
        rgb[2] = s2;
      } else {
        const int cb = s1 - 128, cr = s2 - 128;
        rgb[0] = s0 + ((kCrR * cr + 32768) >> 16);
        rgb[1] = s0 + ((-kCbG * cb + 32768 - kCrG * cr) >> 16);
        rgb[2] = s0 + ((kCbB * cb + 32768) >> 16);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) o[i * 3 + c] = (uint8_t)min(max(rgb[c], 0), 255);
  }
}

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// `out` is read back (the neighbours' finished bytes), so it is neither
// const nor __restrict__: its loads stay coherent across the barriers
__global__ void __launch_bounds__(kThreads)
png_unfilter(const uint8_t* __restrict__ data,
             const long long* __restrict__ info, uint8_t* out) {
  const long long* m = info + (long long)blockIdx.x * kPngCols;
  const uint8_t* in = data + m[0];
  uint8_t* o = out + m[1];
  const int rows = (int)m[2], bpp = (int)m[4];
  const long long rb = m[3];
  const int px = (int)(rb / bpp);
  for (int band = 0; band < rows; band += blockDim.x) {
    const int r = band + threadIdx.x;
    const bool live = r < rows;
    const uint8_t* src = in + r * (rb + 1);
    const int f = live ? src[0] : 0;
    uint8_t* dst = o + r * rb;
    const uint8_t* up = r > 0 ? dst - rb : nullptr;
    const int steps = px + min((int)blockDim.x, rows - band) - 1;
    for (int s = 0; s < steps; ++s) {
      const int x = s - (int)threadIdx.x;
      if (live && x >= 0 && x < px) {
        for (int k = 0; k < bpp; ++k) {
          const long long at = (long long)x * bpp + k;
          const int a = x > 0 ? dst[at - bpp] : 0;
          const int b = up ? up[at] : 0;
          const int c = (up && x > 0) ? up[at - bpp] : 0;
          int pred = 0;
          switch (f) {
            case 1: pred = a; break;
            case 2: pred = b; break;
            case 3: pred = (a + b) >> 1; break;
            case 4: pred = paeth(a, b, c); break;
            default: break;
          }
          dst[at] = (uint8_t)(src[1 + at] + pred);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

int jpeg_idct_launch(const void* coefs, const void* quant,
                     const void* block_plane, const void* planes, void* out,
                     long long n_blocks, int n_planes, void* stream) {
  if (n_blocks <= 0 || n_planes <= 0) return 0;
  const long long grid = (n_blocks + kIdctBlocks - 1) / kIdctBlocks;
  jpeg_idct_islow<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)quant,
      (const long long*)block_plane, (const long long*)planes,
      (uint8_t*)out, n_blocks);
  return (int)cudaGetLastError();
}

int jpeg_color_launch(const void* planes, const void* info, void* out,
                      int n_images, void* stream) {
  for (int base = 0; base < n_images; base += kMaxGridY) {
    const int n = min(kMaxGridY, n_images - base);
    jpeg_upsample_ycc_rgb<<<dim3(kBlocksPerImage, n), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)planes, (const long long*)info + (long long)base *
        kColorCols, (uint8_t*)out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int png_unfilter_launch(const void* data, const void* info, void* out,
                        int n_passes, void* stream) {
  if (n_passes <= 0) return 0;
  png_unfilter<<<n_passes, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const long long*)info, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
