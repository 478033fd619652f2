// K1 — the fused matcher inputs, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stereo_reconstruction_tpu/ops/
// pallas_cost_volume.py::_kernel in mode "inputs" (wrapper
// pallas_matcher_inputs). The window-cost routine (window_cost.cuh: the
// cost, its arithmetic order, the 48 x 64 tile and its phases) hands every
// plane j in [0, D) to the fold sink below, which folds the planes, in
// increasing j, into the five planes of the exact smoothing scan: m0 (min),
// a0 (first argmin, strict <), c_zero (plane j == -min_d), diag_up (plane
// with d == x) and diag_lf (plane with d == x - 1). The (D, H, W) volume is
// never written. K2 (cost_volume.cuh) stores the same costs from the same
// routine, so K1's planes equal volume_reductions(K2) bit for bit on any
// input.
//
// Bound. Per (pixel, plane) with a candidate the work is 9 flops of
// squared difference, 2 * 2hbs window adds, a sqrt, a multiply and a
// compare: about 44 flops, 1.3e10 at 1128x1408, D=200, block 17, or 0.19 ms
// at 67 TFLOP/s; the images and the five planes are ~70 MB (0.02 ms). The
// fixed summation order forbids sliding sums: every window sum is 2hbs
// adds that no neighbour can share. So K1 is bound by arithmetic and by
// the latency of its loads, not by device memory.
//
// The fold: the cost is non-decreasing in the window sum h, so only a
// plane whose h is below the smallest h so far can lower m0: the sqrt is
// taken for those planes alone (exact, and ~10% of K1's time at (b),
// NVIDIA H100 80GB HBM3, 700 W). c_zero, diag_up and diag_lf are stored
// straight from the one plane each pixel needs. Two CTAs fit an SM (97.5 KB
// of shared memory and 80 registers each at hbs 8): more warps per SM hid
// more latency than one barrier per plane with double-buffered sums did
// (a pipelined variant with 16 warps per SM was slower, same card).

#pragma once

#include "window_cost.cuh"

namespace stpu {

// K1's sink: the running m0 / a0 fold and the three planes it keeps.
struct FoldSink {
  float* __restrict__ m0;
  int* __restrict__ a0;
  float* __restrict__ cz;
  float* __restrict__ du;
  float* __restrict__ dl;
  int W, min_d;
  float acc_m0[wc::kP];
  float acc_h[wc::kP];                   // smallest window sum so far
  int acc_a0[wc::kP];

  __device__ __forceinline__ void begin(const wc::Pixels& px) {
    const float kInf = __int_as_float(0x7f800000);
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) {
      acc_m0[p] = kInf;
      acc_h[p] = kInf;
      acc_a0[p] = 0;
      const int x = px.xb + p;
      if (px.row_out && x < W) {         // planes no candidate reaches stay +inf
        const size_t o = (size_t)px.y * W + x;
        cz[o] = kInf;
        du[o] = kInf;
        dl[o] = kInf;
      }
    }
  }

  __device__ __forceinline__ void plane(const wc::Pixels& px, int j, int d,
                                        const float (&hh)[wc::kP], int n_valid) {
    const float kInf = __int_as_float(0x7f800000);
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) {
      // f(h) = sqrt(h) * inv_area never decreases with h: a plane lowers m0
      // only if its h is below every earlier one (ties keep the first j)
      if (p < n_valid && hh[p] < acc_h[p]) {
        acc_h[p] = hh[p];
        const float c = window_cost(hh[p], px.inv_area[p]);
        if (c < acc_m0[p]) {
          acc_m0[p] = c;
          acc_a0[p] = j;
        }
      }
    }
    // the planes c_zero, diag_up (d == x) and diag_lf (d == x - 1) keep
    const int dd = d - px.xb;
    if (px.row_out && (j == -min_d || (dd >= -1 && dd < wc::kP))) {
#pragma unroll
      for (int p = 0; p < wc::kP; ++p) {
        const int x = px.xb + p;
        if (x >= W) break;
        const size_t o = (size_t)px.y * W + x;
        const float cost = p < n_valid ? window_cost(hh[p], px.inv_area[p]) : kInf;
        if (j == -min_d) cz[o] = cost;
        if (dd == p) du[o] = cost;
        if (dd == p - 1) dl[o] = cost;
      }
    }
  }

  __device__ __forceinline__ void finish(const wc::Pixels& px, int) {
    if (!px.row_out) return;
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) {
      const int x = px.xb + p;
      if (x >= W) continue;
      const size_t o = (size_t)px.y * W + x;
      m0[o] = acc_m0[p];
      a0[o] = acc_a0[p];
    }
  }
};

template <int HBS>
__global__ void __launch_bounds__(wc::kThreads, 2)
matcher_inputs_kernel(const float2* __restrict__ left_rg,   // (H, WLp)
                      const float* __restrict__ left_b,     // (H, WLp)
                      const float* __restrict__ right,      // (H, W, 3)
                      float* __restrict__ m0, int* __restrict__ a0,
                      float* __restrict__ cz, float* __restrict__ du,
                      float* __restrict__ dl,
                      int H, int W, int WL, int WLp, int min_d, int D, int row0,
                      int H_total) {
  FoldSink sink{m0, a0, cz, du, dl, W, min_d};
  window_cost_tile<HBS>(left_rg, left_b, right, H, W, WL, WLp, min_d, D, row0, H_total,
                        sink);
}

}  // namespace stpu
