// Launcher of the perspective warp (kernel and design notes: warp.cuh),
// with a plain C interface for ctypes.

#include "warp.cuh"

namespace {

using stpu::warp::Batch;

template <typename T, int C>
void launch(bool nearest, dim3 grid, dim3 block, cudaStream_t stream, const Batch& batch,
            float* dst, int h_out, int w_out, int vec) {
  if (nearest)
    stpu::warp::warp_kernel<T, C, true><<<grid, block, 0, stream>>>(batch, dst, h_out, w_out,
                                                                    vec);
  else
    stpu::warp::warp_kernel<T, C, false><<<grid, block, 0, stream>>>(batch, dst, h_out, w_out,
                                                                     vec);
}

}  // namespace

// The most sources one launch takes; stpu_warp launches once for each
// group of that many.
extern "C" int stpu_warp_max_images() { return stpu::warp::kMaxImages; }

// The name of a cudaError_t that stpu_warp returned.
extern "C" const char* stpu_warp_error(int err) { return cudaGetErrorString((cudaError_t)err); }

// Warps `n` sources into `dst` on `stream`; returns the first launch's
// cudaError_t that is not 0, else 0. Host arrays: `srcs` (n device
// pointers, each a contiguous (h, w, channels) image, uint8 if
// `src_uint8` else float32), `shapes` (n x (h, w)) and `hinv` (n x 9
// floats, each image's destination -> source map, row-major). `dst` is
// the device's (n, h_out, w_out, channels) float32 output, 16-byte
// aligned. channels is 1 or 3; `nearest` picks nearest over bilinear.
extern "C" int stpu_warp(const void* const* srcs, const int* shapes, const float* hinv, int n,
                         int src_uint8, int channels, float* dst, int h_out, int w_out,
                         int nearest, void* stream) {
  using namespace stpu::warp;
  if (n <= 0 || h_out <= 0 || w_out <= 0 || h_out > 65535 * kBlockY ||
      (channels != 1 && channels != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int vec = w_out % 4 == 0;
  const dim3 block(kBlockX, kBlockY);
  for (int first = 0; first < n; first += kMaxImages) {
    const int count = n - first < kMaxImages ? n - first : kMaxImages;
    Batch batch = {};
    for (int b = 0; b < count; ++b) {
      Source& s = batch.src[b];
      s.ptr = srcs[first + b];
      s.h = shapes[2 * (first + b)];
      s.w = shapes[2 * (first + b) + 1];
      for (int k = 0; k < 9; ++k) s.m[k] = hinv[9 * (first + b) + k];
      if (s.h <= 0 || s.w <= 0) return (int)cudaErrorInvalidValue;
    }
    const dim3 grid(((w_out + kPix - 1) / kPix + kBlockX - 1) / kBlockX,
                    (h_out + kBlockY - 1) / kBlockY, count);
    float* out = dst + static_cast<size_t>(first) * h_out * w_out * channels;
    if (src_uint8 && channels == 3)
      launch<uint8_t, 3>(nearest, grid, block, st, batch, out, h_out, w_out, vec);
    else if (src_uint8)
      launch<uint8_t, 1>(nearest, grid, block, st, batch, out, h_out, w_out, vec);
    else if (channels == 3)
      launch<float, 3>(nearest, grid, block, st, batch, out, h_out, w_out, vec);
    else
      launch<float, 1>(nearest, grid, block, st, batch, out, h_out, w_out, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
