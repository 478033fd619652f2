// The perspective warp, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package warps with XLA ops
// (stereo_reconstruction_tpu/ops/warp.py::warp_inverse_map, or its band
// warp), and the port's plain twin, ops/warp.py::warp_inverse_map, is
// ~100 small PyTorch ops a bilinear warp and ~40 a nearest one, each a
// launch with its own Python dispatch. The fixed-F request makes three
// warps (the two rectifying ones onto the canvas, and the back-warp of
// disparity); this kernel makes each call one launch.
//
// What it computes: for each destination pixel p = (x, y) of image b,
// dst(p) = src(Hinv p), bilinear or nearest, zero outside the source,
// exactly as the twin does, so the two agree bit for bit:
//
//   * float32 arithmetic in the twin's order of operations, each one
//     rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no
//     contraction into FMAs);
//   * a denominator |d| < 1e-12 replaced by 1e-12;
//   * _int_coord: clamp to [-2, n + 1] (NaN passes, as torch.clamp), then
//     truncation to int32 (cvt.rzi: NaN to 0, as a float->int32 cast on
//     the card); torch.round as rintf (half to even);
//   * each sample read at the clamped index and multiplied by its 0/1
//     inside flag, as the twin does, so -0.0 (a negative value outside)
//     and NaN survive; the bilinear sum added left to right.
//
// Source: uint8 or float32, (h, w, C) with C = 1 or 3, converted in the
// kernel (uint8 to float32 is exact). Up to kMaxImages sources a launch,
// each with its own pointer, shape and inverse map, passed by value as the
// kernel's argument (no upload, no device inverse); image b is blockIdx.z.
//
// What binds: the stores. A 1128x1408 canvas of 3 float32 channels is
// 19.1 MB against a 2 MB uint8 source that the 50 MB L2 holds whole: 5.7
// us at 3.35 TB/s. So each thread owns kPix consecutive destination
// pixels of one row and writes them as C 16-byte vectors where the row
// allows (w_out % 4 == 0), and reads the 9 map floats once into registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stpu {
namespace warp {

constexpr int kMaxImages = 32;   // sources a launch (the argument stays < 4 KB)
constexpr int kPix = 4;          // consecutive destination pixels a thread
constexpr int kBlockX = 64;      // threads along a row
constexpr int kBlockY = 4;       // rows a block

struct Source {
  const void* ptr;    // (h, w, C) uint8 or float32, contiguous, on the device
  int h, w;
  float m[9];         // Hinv row-major: destination -> source
};

struct Batch {
  Source src[kMaxImages];
};

__device__ __forceinline__ float load(const uint8_t* p, int i) {
  return static_cast<float>(__ldg(p + i));
}
__device__ __forceinline__ float load(const float* p, int i) { return __ldg(p + i); }

// ops/warp.py::_int_coord: clamp to [-2, n + 1] keeping NaN, then to int32
__device__ __forceinline__ int int_coord(float v, int n) {
  const float c = isnan(v) ? v : fminf(fmaxf(v, -2.0f), static_cast<float>(n + 1));
  return __float2int_rz(c);
}

// src at (iy, ix) clamped into the image, times the 0/1 inside flag
template <typename T, int C>
__device__ __forceinline__ void sample(const T* src, int h, int w, int iy, int ix,
                                       float* v) {
  const float inside = (ix >= 0 && ix < w && iy >= 0 && iy < h) ? 1.0f : 0.0f;
  const int cy = min(max(iy, 0), h - 1), cx = min(max(ix, 0), w - 1);
  const int base = (cy * w + cx) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __fmul_rn(load(src, base + c), inside);
}

template <typename T, int C, bool kNearest>
__device__ __forceinline__ void warp_pixel(const T* src, int h, int w, const float* m,
                                           int x, int y, float* out) {
  const float gx = static_cast<float>(x), gy = static_cast<float>(y);
  float d = __fadd_rn(__fadd_rn(__fmul_rn(m[6], gx), __fmul_rn(m[7], gy)), m[8]);
  if (fabsf(d) < 1e-12f) d = 1e-12f;
  const float sx =
      __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), __fmul_rn(m[1], gy)), m[2]), d);
  const float sy =
      __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), __fmul_rn(m[4], gy)), m[5]), d);
  if (kNearest) {
    sample<T, C>(src, h, w, int_coord(rintf(sy), h), int_coord(rintf(sx), w), out);
    return;
  }
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
  const float gx0 = __fsub_rn(1.0f, fx), gy0 = __fsub_rn(1.0f, fy);
  const int x0i = int_coord(x0, w), y0i = int_coord(y0, h);
  float v00[C], v01[C], v10[C], v11[C];
  sample<T, C>(src, h, w, y0i, x0i, v00);
  sample<T, C>(src, h, w, y0i, x0i + 1, v01);
  sample<T, C>(src, h, w, y0i + 1, x0i, v10);
  sample<T, C>(src, h, w, y0i + 1, x0i + 1, v11);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a = __fmul_rn(__fmul_rn(v00[c], gx0), gy0);
    const float b = __fmul_rn(__fmul_rn(v01[c], fx), gy0);
    const float e = __fmul_rn(__fmul_rn(v10[c], gx0), fy);
    const float f = __fmul_rn(__fmul_rn(v11[c], fx), fy);
    out[c] = __fadd_rn(__fadd_rn(__fadd_rn(a, b), e), f);
  }
}

// dst: (images, h_out, w_out, C) float32. vec: w_out % 4 == 0 (and dst
// 16-byte aligned), so each thread's kPix * C floats are C aligned float4s.
template <typename T, int C, bool kNearest>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    warp_kernel(const Batch batch, float* __restrict__ dst, int h_out, int w_out, int vec) {
  const int b = blockIdx.z;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x0 = (blockIdx.x * kBlockX + threadIdx.x) * kPix;
  if (y >= h_out || x0 >= w_out) return;
  const Source& s = batch.src[b];
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = s.m[k];
  const T* src = static_cast<const T*>(s.ptr);
  float out[kPix * C];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
    warp_pixel<T, C, kNearest>(src, s.h, s.w, m, x0 + i, y, out + i * C);
  float* row = dst + ((static_cast<size_t>(b) * h_out + y) * w_out + x0) * C;
  if (vec) {
    float4* v = reinterpret_cast<float4*>(row);
#pragma unroll
    for (int k = 0; k < C; ++k)
      v[k] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
  } else {
    const int n = min(kPix, w_out - x0) * C;
#pragma unroll
    for (int k = 0; k < kPix * C; ++k)    // unrolled: `out` stays in registers
      if (k < n) row[k] = out[k];
  }
}

}  // namespace warp
}  // namespace stpu
