// Launchers of the SIFT scale space (kernels and design notes: sift.cuh),
// with a plain C interface for ctypes.

#include "sift.cuh"

// One Gaussian level of B images on `stream`; returns the launch's
// cudaError_t, or cudaErrorInvalidValue for what the kernel does not take.
// `ptrs` holds the device pointers src, dst and copy (copy may be null);
// `dims` is B, H, W, src_batch, src_row, src_col, dst_batch (element
// strides), radius; `taps` the 2 * radius + 1 taps. The planes need H and W
// above the radius (reflect-101 reflects once), 1 <= radius <= kMaxRadius.
extern "C" int stpu_sift_level(void* const* ptrs, const long long* dims, const float* taps,
                               void* stream) {
  using namespace stpu::sift;
  LevelParams P = {};
  P.src = static_cast<const float*>(ptrs[0]);
  P.dst = static_cast<float*>(ptrs[1]);
  P.copy = static_cast<float*>(ptrs[2]);
  P.src_batch = dims[3];
  P.src_row = dims[4];
  P.src_col = dims[5];
  P.dst_batch = dims[6];
  if (dims[0] < 1 || dims[1] < 1 || dims[2] < 1 || dims[7] < 1 || dims[7] > kMaxRadius ||
      dims[1] <= dims[7] || dims[2] <= dims[7] || dims[1] > (1 << 20) || dims[2] > (1 << 20))
    return (int)cudaErrorInvalidValue;
  P.B = (int)dims[0];
  P.H = (int)dims[1];
  P.W = (int)dims[2];
  P.radius = (int)dims[7];
  P.tiles_x = (P.W + kTile - 1) / kTile;
  P.tiles_y = (P.H + kTile - 1) / kTile;
  const long long grid = (long long)P.B * P.tiles_x * P.tiles_y;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2 * P.radius + 1; ++i) P.taps[i] = taps[i];
  level_kernel<<<(unsigned)grid, kThreads, level_smem_bytes(P.radius), (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// One octave's detection planes for B images on `stream`; returns the
// launch's cudaError_t, or cudaErrorInvalidValue for what the kernel does
// not take. `ptrs` holds the device pointers gauss, dog, response, mag and
// ang (layouts in DetectParams); `dims` is B, s, oh, ow, H0, W0, planes,
// first; `scalars` is the contrast threshold, the edge ratio and its bound.
extern "C" int stpu_sift_detect(void* const* ptrs, const int* dims, const float* scalars,
                                void* stream) {
  using namespace stpu::sift;
  DetectParams P = {};
  P.gauss = static_cast<const float*>(ptrs[0]);
  P.dog = static_cast<float*>(ptrs[1]);
  P.response = static_cast<float*>(ptrs[2]);
  P.mag = static_cast<float*>(ptrs[3]);
  P.ang = static_cast<float*>(ptrs[4]);
  P.B = dims[0];
  P.s = dims[1];
  P.oh = dims[2];
  P.ow = dims[3];
  P.H0 = dims[4];
  P.W0 = dims[5];
  P.planes = dims[6];
  P.first = dims[7];
  P.contrast = scalars[0];
  P.edge = scalars[1];
  P.edge_bound = scalars[2];
  if (P.B < 1 || P.s < 1 || P.s > kMaxScales || P.oh < 1 || P.ow < 1 || P.oh > P.H0 ||
      P.ow > P.W0 || P.first < 0 || P.first + P.s > P.planes)
    return (int)cudaErrorInvalidValue;
  P.tiles_x = (P.ow + kDetW - 1) / kDetW;
  P.tiles_y = (P.oh + kDetH - 1) / kDetH;
  const long long grid = (long long)P.B * P.tiles_x * P.tiles_y;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  detect_kernel<<<(unsigned)grid, kThreads, detect_smem_bytes(P.s), (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
