// The SIFT scale space of the pose layer, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its scale space with
// banded-Toeplitz matmuls and XLA elementwise ops
// (stereo_reconstruction_tpu/ops/features.py), and the port's plain twin,
// ops/features.py::scale_space_plain with blur_in_tap_order, is ~1,800 small
// PyTorch ops a request of two 750x900 images: four launches a tap of each
// Gaussian level, and a roll, a maximum and a minimum a neighbour of each
// octave's extremum test. Two kernels make it 25 launches:
//
//   * level_kernel, one Gaussian level of every image of a batch: a CTA
//     loads its 32x32 output tile and the r-halo around it into shared
//     memory, at reflect-101 indices (F.pad(mode="reflect")), runs the
//     pass along H into shared memory and then the pass along W. The taps
//     are added in tap order, acc = x0*t0, then acc = acc + xi*ti, each
//     product and sum rounded on its own (__fmul_rn, __fadd_rn: no FMA),
//     as blur_in_tap_order's one elementwise pass a tap adds them; so the
//     two agree bit for bit, and an image's level never depends on the
//     other images of its batch. The source may be strided (the next
//     octave's first level reads level s of the previous stack at stride
//     2) and may be copied through into plane 0 of the new stack.
//   * detect_kernel, one octave of every image: a CTA loads its 32x16
//     tile of the octave's s+3 Gaussian planes with a one-pixel halo at
//     wrap-around indices (torch.roll), forms the s+2 DoG planes in shared
//     memory and writes, for the s middle ones, the DoG plane, the
//     extremum response (26-neighbour strict extremum, contrast, the 2x2
//     Hessian edge test in the twin's order of operations, margin 8) and
//     the gradient magnitude and angle of the Gaussian planes 1..s into
//     the (oh, ow) corner of their slots of the (B, n_oct * s, H0, W0)
//     stacks, which the caller zeroes beforehand.
//
// What binds: at 750x900 a level is 2.7 MB read and 2.7 MB written an
// image; the shared-memory taps are ~20 loads an output. Both are a few
// microseconds; the launches they replace were ~10 us of host time each.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stpu {
namespace sift {

constexpr int kMaxRadius = 24;     // a level's largest radius (sigma 8): 35 KB of shared memory
constexpr int kTile = 32;          // a level CTA's output tile, kTile x kTile
constexpr int kThreads = 256;      // threads a CTA, both kernels
constexpr int kDetW = 32;          // a detection CTA's tile: kDetW x kDetH
constexpr int kDetH = 16;
constexpr int kMaxScales = 7;      // scales an octave: 2s + 5 halo planes in 48 KB
constexpr int kMargin = 8;         // the border without keypoints

struct LevelParams {
  const float* src;        // image b's (row, col) at src + b*src_batch + row*src_row + col*src_col
  float* dst;              // image b's (H, W) plane at dst + b*dst_batch, rows contiguous
  float* copy;             // nullptr, or where the source is copied, as dst
  long long src_batch, src_row, src_col, dst_batch;
  int B, H, W, radius, tiles_x, tiles_y;
  float taps[2 * kMaxRadius + 1];
};

struct DetectParams {
  const float* gauss;      // (B, s + 3, oh, ow), contiguous
  float* dog;              // (B, s, oh, ow): the DoG planes 1..s
  float* response;         // (B, s, oh, ow)
  float* mag;              // (B, planes, H0, W0): the (oh, ow) corner of slots first ..
  float* ang;              //   first + s - 1, the rest left as it is
  int B, s, oh, ow, H0, W0, planes, first, tiles_x, tiles_y;
  float contrast;          // float32(contrast_threshold / s)
  float edge;              // float32(edge_threshold)
  float edge_bound;        // float32((edge_threshold + 1)^2)
};

// reflect-101 of i into [0, n) for -n < i < 2n - 1; clamped beyond, where
// the tile reads what it does not use
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// torch.roll's index of i into [0, n) for -n <= i < 2n; clamped beyond
__device__ __forceinline__ int wrap(int i, int n) {
  i = i < 0 ? i + n : (i >= n ? i - n : i);
  return min(max(i, 0), n - 1);
}

// torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) { return (b != b || b > a) ? b : a; }
__device__ __forceinline__ float nan_min(float a, float b) { return (b != b || b < a) ? b : a; }

__global__ void __launch_bounds__(kThreads) level_kernel(const LevelParams p) {
  extern __shared__ float smem[];
  __shared__ float taps[2 * kMaxRadius + 1];
  const int r = p.radius, n = 2 * r + 1, wide = kTile + 2 * r;
  float* in = smem;                    // (kTile + 2r) x wide
  float* mid = smem + wide * wide;     // kTile x wide: the pass along H
  int t = blockIdx.x;
  const int x0 = (t % p.tiles_x) * kTile;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * kTile;
  const long long b = t / p.tiles_y;
  for (int i = threadIdx.x; i < n; i += blockDim.x) taps[i] = p.taps[i];
  const float* src = p.src + b * p.src_batch;
  for (int i = threadIdx.x; i < wide * wide; i += blockDim.x) {
    const int row = reflect(y0 - r + i / wide, p.H), col = reflect(x0 - r + i % wide, p.W);
    in[i] = src[row * p.src_row + col * p.src_col];
  }
  __syncthreads();
  if (p.copy != nullptr) {
    float* copy = p.copy + b * p.dst_batch;
    for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
      const int y = y0 + i / kTile, x = x0 + i % kTile;
      if (y < p.H && x < p.W)
        copy[(long long)y * p.W + x] = in[(i / kTile + r) * wide + i % kTile + r];
    }
  }
  for (int i = threadIdx.x; i < kTile * wide; i += blockDim.x) {
    const float* c = in + i;             // row i / wide, column i % wide
    float acc = __fmul_rn(c[0], taps[0]);
    for (int k = 1; k < n; ++k) acc = __fadd_rn(acc, __fmul_rn(c[k * wide], taps[k]));
    mid[i] = acc;
  }
  __syncthreads();
  float* dst = p.dst + b * p.dst_batch;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int row = i / kTile, col = i % kTile, y = y0 + row, x = x0 + col;
    if (y >= p.H || x >= p.W) continue;
    const float* c = mid + row * wide + col;
    float acc = __fmul_rn(c[0], taps[0]);
    for (int k = 1; k < n; ++k) acc = __fadd_rn(acc, __fmul_rn(c[k], taps[k]));
    dst[(long long)y * p.W + x] = acc;
  }
}

// The level's dynamic shared memory: the halo tile and the pass along H.
inline size_t level_smem_bytes(int radius) {
  const size_t wide = kTile + 2 * radius;
  return (wide * wide + kTile * wide) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) detect_kernel(const DetectParams p) {
  extern __shared__ float smem[];
  constexpr int hw = kDetW + 2, area = hw * (kDetH + 2);
  const int s = p.s;
  float* g = smem;                     // s + 3 Gaussian planes, halo 1
  float* d = smem + (s + 3) * area;    // s + 2 DoG planes
  int t = blockIdx.x;
  const int x0 = (t % p.tiles_x) * kDetW;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * kDetH;
  const long long b = t / p.tiles_y;
  const long long plane_in = (long long)p.oh * p.ow, plane0 = (long long)p.H0 * p.W0;
  float* mag = p.mag + (b * p.planes + p.first) * plane0;
  float* ang = p.ang + (b * p.planes + p.first) * plane0;
  const float* gauss = p.gauss + b * (s + 3) * plane_in;
  for (int i = threadIdx.x; i < (s + 3) * area; i += blockDim.x) {
    const int k = i / area, at = i % area;
    const int row = wrap(y0 - 1 + at / hw, p.oh), col = wrap(x0 - 1 + at % hw, p.ow);
    g[i] = gauss[k * plane_in + (long long)row * p.ow + col];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (s + 2) * area; i += blockDim.x)
    d[i] = __fsub_rn(g[i + area], g[i]);
  __syncthreads();
  const long long out_b = b * s * plane_in;
  for (int i = threadIdx.x; i < kDetW * kDetH; i += blockDim.x) {
    const int row = i / kDetW, col = i % kDetW, y = y0 + row, x = x0 + col;
    if (y >= p.oh || x >= p.ow) continue;
    const long long at0 = (long long)y * p.W0 + x;
    const int ci = (row + 1) * hw + col + 1;
    const long long at = out_b + (long long)y * p.ow + x;
    const bool border_ok = y >= kMargin && y < p.oh - kMargin && x >= kMargin &&
                           x < p.ow - kMargin;
    for (int j = 0; j < s; ++j) {
      // the DoG plane j + 1 and its response
      const float* dk = d + (j + 1) * area;
      const float c = dk[ci];
      float hi = -INFINITY, lo = INFINITY;
      for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (dz == 0 && dy == 0 && dx == 0) continue;
            const float v = dk[dz * area + dy * hw + dx + ci];
            hi = nan_max(hi, v);
            lo = nan_min(lo, v);
          }
      const bool extremum = c > hi || c < lo;
      const bool contrast_ok = fabsf(c) > p.contrast;
      const float dxx = __fadd_rn(__fsub_rn(dk[ci + 1], __fmul_rn(2.0f, c)), dk[ci - 1]);
      const float dyy = __fadd_rn(__fsub_rn(dk[ci + hw], __fmul_rn(2.0f, c)), dk[ci - hw]);
      const float dxy = __fmul_rn(
          __fadd_rn(__fsub_rn(__fsub_rn(dk[ci + hw + 1], dk[ci + hw - 1]), dk[ci - hw + 1]),
                    dk[ci - hw - 1]),
          0.25f);
      const float tr = __fadd_rn(dxx, dyy);
      const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
      const bool edge_ok =
          det > 0.0f && __fmul_rn(__fmul_rn(tr, tr), p.edge) < __fmul_rn(p.edge_bound, det);
      p.dog[at + j * plane_in] = c;
      p.response[at + j * plane_in] =
          (extremum && contrast_ok && edge_ok && border_ok) ? fabsf(c) : 0.0f;
      // the gradient of the Gaussian plane j + 1, central differences
      const float* gk = g + (j + 1) * area;
      const float gx = __fmul_rn(__fsub_rn(gk[ci + 1], gk[ci - 1]), 0.5f);
      const float gy = __fmul_rn(__fsub_rn(gk[ci + hw], gk[ci - hw]), 0.5f);
      mag[j * plane0 + at0] = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
      ang[j * plane0 + at0] = atan2f(gy, gx);
    }
  }
}

// The detection's dynamic shared memory: s + 3 Gaussian and s + 2 DoG planes.
inline size_t detect_smem_bytes(int s) {
  return (size_t)(2 * s + 5) * (kDetW + 2) * (kDetH + 2) * sizeof(float);
}

}  // namespace sift
}  // namespace stpu
