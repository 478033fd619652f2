// K4 — the perceptual matcher's windowed smoother, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the lax.scan + lax.while_loop of stereo_reconstruction_tpu/
// perceptual/cost.py::windowed_smooth_argmin (not a Pallas kernel: on the
// TPU it was an XLA loop). From the (H, D, W) float32 LPIPS cost volume it
// runs the reference notebook's chunked multiplicative smoothing (cell 10)
// and writes the (H, W) float32 argmin indices:
//
//   c[d] = (cost[y, d, x] * T[|d - disp[y-1, x]|]) * T[|d - mean|],
//   mean = min(disp[y, x-1], min(D, W - x)),
//
// the first factor for y > 0 only, the second only where x is not the first
// pixel of its chunk of `chunk` columns; disp[y, x] = argmin_d c[d] with
// jnp.argmin's order (NaN first, then the first index of the minimum).
// T[k] = (1 - exp(-k / sigma)) + bias is a table of D + 1 floats made by
// the wrapper: every argument of the weight is an integer in [0, D], so
// the kernel and its plain twin (perceptual/scan.py::window_scan_plain)
// multiply by the same numbers and agree bit for bit.
//
// Design: row y of pixel x depends on row y-1 at x only, and on its left
// neighbour only inside a chunk, so a chunk's strip of columns is an
// independent problem over all H rows. One warp owns one strip (one CTA of
// one warp per chunk, spread over the SMs) and walks the rows in order;
// inside a row it resolves the strip's pixels left to right (position k of
// a chunk is what JAX's Jacobi sweeps reach after k sweeps, their fixpoint).
// Lanes run over d; a warp shuffle takes the (value, index) minimum. The
// next row's (D, chunk) slab is copied to shared memory with cp.async while
// the current row's chain runs (two slabs); the table and the previous
// row's indices live in shared memory too.
//
// Bound: the bytes are the volume read once and the indices written once
// (H * (D + 1) * W * 4: 68 MB at 375x450, D=100, 0.02 ms at 3.35 TB/s); the
// arithmetic is 3 operations per entry. Neither binds: the chain of
// H * chunk dependent argmins of each strip does.
//
// Exactness: the products are __fmul_rn in the twin's order (cost times
// the row weight, then times the pixel weight), no --use_fast_math.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace stpu {
namespace k4 {

// a block may use 227 KB of dynamic shared memory on Hopper
constexpr long long kMaxSmem = 232448;

// dynamic shared memory of one CTA: the table (rounded up to 16 bytes), two
// (D, chunk) slabs and two rows of chunk indices
__host__ __device__ inline long long smem_bytes(long long D, long long chunk) {
  return 4 * ((D + 1 + 3) / 4 * 4) + 8 * D * chunk + 8 * chunk;
}

// (v, i) comes before (bv, bi) in jnp.argmin's (and torch.argmin's) order:
// NaN before any number, then the smaller value, then the smaller index
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v < bv;
  return i < bi;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void commit_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most the newest group of this thread's copies is in flight
__device__ __forceinline__ void wait_all_but_newest() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

}  // namespace k4

__global__ void __launch_bounds__(32)
perceptual_scan_kernel(const float* __restrict__ cost, const float* __restrict__ table,
                       float* __restrict__ out, int H, int D, int W, int chunk) {
  using k4::before;
  extern __shared__ float smem[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * chunk;
  const int len = min(chunk, W - x0);     // this strip's columns
  const int n = D * len;                  // one row's slab
  float* tab = smem;
  float* slab = smem + (D + 1 + 3) / 4 * 4;
  int* rows = reinterpret_cast<int*>(slab + 2 * (size_t)D * chunk);
  for (int i = lane; i <= D; i += 32) tab[i] = table[i];

  // row y's (D, len) slab into slab buffer `buf`, entry (d, p) at d * len + p
  auto stage = [&](int y, int buf) {
    const float* src = cost + (size_t)y * D * W + x0;
    float* dst = slab + (size_t)buf * D * chunk;
    int d = lane / len, p = lane - d * len;
    for (int i = lane; i < n; i += 32) {
      k4::copy_async(dst + i, src + (size_t)d * W + p);
      p += 32;
      while (p >= len) {
        p -= len;
        ++d;
      }
    }
    k4::commit_async();
  };

  stage(0, 0);
  for (int y = 0; y < H; ++y) {
    // the next row's copies run under this row's chain; the buffer they
    // fill was last read by row y-1, before the barrier that ended it
    if (y + 1 < H) {
      stage(y + 1, (y + 1) & 1);
    } else {
      k4::commit_async();                 // an empty group keeps the count
    }
    k4::wait_all_but_newest();
    __syncwarp();
    const float* s = slab + (size_t)(y & 1) * D * chunk;
    const int* up = rows + ((y + 1) & 1) * chunk;   // row y-1's indices
    int* cur = rows + (y & 1) * chunk;
    int left = 0;
    for (int p = 0; p < len; ++p) {
      const int size = min(D, W - (x0 + p));        // the pixel's candidates
      const int mean = min(left, size);             // may equal size (the quirk)
      const int u = y > 0 ? up[p] : 0;
      float bv = __int_as_float(0x7f800000);
      int bi = INT_MAX;
      for (int d = lane; d < D; d += 32) {
        float c = s[d * len + p];
        if (y > 0) c = __fmul_rn(c, tab[abs(d - u)]);
        if (p > 0) c = __fmul_rn(c, tab[abs(d - mean)]);
        if (before(c, d, bv, bi)) {
          bv = c;
          bi = d;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(full, bv, off);
        const int oi = __shfl_xor_sync(full, bi, off);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      left = bi;                          // the same in every lane
      if (lane == 0) {
        cur[p] = bi;
        out[(size_t)y * W + x0 + p] = static_cast<float>(bi);
      }
    }
    __syncwarp();
  }
}

}  // namespace stpu
