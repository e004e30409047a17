// D4 resample_bicubic_u8: one pass of Pillow's fixed-point resampling
// (Resample.c, ImagingResampleHorizontal_8bpc / ImagingResampleVertical_8bpc)
// over a batch of RGB uint8 images (ops/image_decode.py holds the wrapper
// and the plain PyTorch version, which it equals bit for bit).
//
// It replaces no TPU kernel: the reference resizes with PIL on the host
// (io/sources.py read_images). The windows (first tap, taps) and the int32
// weights with 22 fractional bits come from the host (image/resample.py,
// Pillow's precompute_coeffs and normalize_coeffs_8bpc). Bound by bytes:
// an output sample reads its taps (at most 2 * ceil(2 * scale) + 1) and
// does one multiply-add each. One thread per output sample: the sum
// starts at 1 << 21 (half of the last bit), is shifted right by 22 and
// clipped to 0-255, as Pillow's clip8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerImage = 64;
constexpr int kMaxGridY = 65535;
constexpr int kCols = 10;                // ops/image_decode.RESAMPLE_IMAGE
constexpr int kPrecisionBits = 32 - 8 - 2;

__global__ void __launch_bounds__(kThreads)
resample_bicubic_u8(const uint8_t* __restrict__ in,
                    const long long* __restrict__ info,
                    const int* __restrict__ bounds,
                    const int* __restrict__ coefs,
                    uint8_t* __restrict__ out, int vertical) {
  const long long* m = info + (long long)blockIdx.y * kCols;
  const uint8_t* src = in + m[0];
  uint8_t* dst = out + m[1];
  const long long in_w = m[3];
  const int out_h = (int)m[4], out_w = (int)m[5], row0 = (int)m[6];
  const int* bnd = bounds + m[7] * 2;
  const int* kk = coefs + m[8];
  const int ksize = (int)m[9];
  const long long n = (long long)out_h * out_w * 3;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int ch = (int)(i % 3);
    const long long pix = i / 3;
    const int q = (int)(pix % out_w), p = (int)(pix / out_w);
    const int j = vertical ? p : q;
    const int first = bnd[2 * j], taps = bnd[2 * j + 1];
    const int* k = kk + (long long)j * ksize;
    int acc = 1 << (kPrecisionBits - 1);
    if (vertical) {
      const uint8_t* s = src + ((long long)first * in_w + q) * 3 + ch;
      for (int t = 0; t < taps; ++t) acc += (int)s[t * in_w * 3] * k[t];
    } else {
      const uint8_t* s = src + ((long long)(row0 + p) * in_w + first) * 3 + ch;
      for (int t = 0; t < taps; ++t) acc += (int)s[t * 3] * k[t];
    }
    dst[i] = (uint8_t)min(max(acc >> kPrecisionBits, 0), 255);
  }
}

}  // namespace

extern "C" {

int resample_launch(const void* in, const void* info, const void* bounds,
                    const void* coefs, void* out, int n_images, int vertical,
                    void* stream) {
  for (int base = 0; base < n_images; base += kMaxGridY) {
    const int n = min(kMaxGridY, n_images - base);
    resample_bicubic_u8<<<dim3(kBlocksPerImage, n), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const long long*)info + (long long)base * kCols,
        (const int*)bounds, (const int*)coefs, (uint8_t*)out, vertical);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
