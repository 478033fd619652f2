// K2 — the Right-variant SSD cost volume, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stereo_reconstruction_tpu/ops/
// pallas_cost_volume.py::_kernel in mode "volume" (wrapper
// pallas_cost_volume_right_ssd). The window-cost routine (window_cost.cuh)
// forms every plane's window sums in K1's order; the store sink below
// takes sqrt * 1/area of every output with a candidate and stores
// cost[j, y, x] (+inf where there is none). Planes j >= j_end, where no
// pixel of the tile has a candidate, are stored as +inf without forming
// sums.
//
// Bound: K2 must store D*H*W*4 bytes (1.27 GB at 1128x1408, D=200: 0.38 ms
// at 3.35 TB/s) and do the same ~44 flops per (pixel, plane) as K1 (0.19 ms
// at 67 TFLOP/s), so its bound is the stores. A warp's stores of a plane
// are 8 rows x 128 contiguous bytes (two float4 per thread where W % 4 ==
// 0), streamed past L2 (__stcs: the volume is 25x the L2), and they drain
// while the CTA forms the next plane. What K1's fold saves on the sqrt
// (only planes that lower m0 take one) K2 cannot: every valid output takes
// its sqrt. At 1128x1408, D=200, block 17 K2 takes ~1.78 ms against K1's
// ~1.59 ms (NVIDIA H100 80GB HBM3, 700 W): the routine's latency binds, not
// the stores.
//
// Numerics: K1 adds in the same order, so volume_reductions of this volume
// equal K1's planes bit for bit on any input. Window sums of
// integer-valued images below 2^24 are exact in any order, so on such
// inputs the volume equals the plain PyTorch version bit for bit.

#pragma once

#include "window_cost.cuh"

namespace stpu {

// Stores the 8 costs of a phase-B thread at row `o` = (plane, y) * W + xb:
// two streaming float4 where they are 16-byte aligned and inside the row.
__device__ __forceinline__ void store_costs(float* __restrict__ cost, size_t o, int xb,
                                            int W, const float (&c)[wc::kP]) {
  if ((W & 3) == 0 && xb + wc::kP <= W) {
    float4* q = reinterpret_cast<float4*>(cost + o);
    __stcs(q, make_float4(c[0], c[1], c[2], c[3]));
    __stcs(q + 1, make_float4(c[4], c[5], c[6], c[7]));
  } else {
#pragma unroll
    for (int p = 0; p < wc::kP; ++p)
      if (xb + p < W) __stcs(cost + o + p, c[p]);
  }
}

// K2's sink: every plane stored, +inf where no candidate.
struct StoreSink {
  float* __restrict__ cost;              // (D, H, W)
  int H, W, D;

  __device__ __forceinline__ void begin(const wc::Pixels&) {}

  __device__ __forceinline__ void plane(const wc::Pixels& px, int j, int,
                                        const float (&hh)[wc::kP], int n_valid) {
    if (!px.row_out) return;
    const float kInf = __int_as_float(0x7f800000);
    float c[wc::kP];
#pragma unroll
    for (int p = 0; p < wc::kP; ++p)
      c[p] = p < n_valid ? window_cost(hh[p], px.inv_area[p]) : kInf;
    store_costs(cost, ((size_t)j * H + px.y) * W + px.xb, px.xb, W, c);
  }

  __device__ __forceinline__ void finish(const wc::Pixels& px, int j_end) {
    if (!px.row_out) return;
    const float kInf = __int_as_float(0x7f800000);
    float c[wc::kP];
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) c[p] = kInf;
    for (int j = j_end; j < D; ++j)
      store_costs(cost, ((size_t)j * H + px.y) * W + px.xb, px.xb, W, c);
  }
};

template <int HBS>
__global__ void __launch_bounds__(wc::kThreads, 2)
cost_volume_kernel(const float2* __restrict__ left_rg,   // (H, WLp)
                   const float* __restrict__ left_b,     // (H, WLp)
                   const float* __restrict__ right,      // (H, W, 3)
                   float* __restrict__ cost,             // (D, H, W)
                   int H, int W, int WL, int WLp, int min_d, int D) {
  StoreSink sink{cost, H, W, D};
  window_cost_tile<HBS>(left_rg, left_b, right, H, W, WL, WLp, min_d, D, sink);
}

}  // namespace stpu
