// K2 — the Right-variant SSD cost volume, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stereo_reconstruction_tpu/ops/
// pallas_cost_volume.py::_kernel in mode "volume" (wrapper
// pallas_cost_volume_right_ssd). For every output pixel (y, x) of the right
// image and every plane j in [0, D) (disparity d = min_d + j) it stores the
// reference cost (BlockSearch.cpp:116-158)
//
//   cost = sqrt(SSD over [y-hbs, y+hbs) x [x-hbs, x+hbs) clipped to
//               [0, H-1) x [0, W-1)) * (1 / area),
//   +inf where area <= 0 or x + d + min(W-1-x, hbs) >= WL,
//
// as cost[j, y, x], coalesced along x.
//
// Design: one CTA owns a 16 x 64 output tile. It stages the right band
// (tile + 2*hbs halo) in shared memory once; for each d, plane_costs()
// writes the masked channel-summed squared difference of the band to
// shared memory, takes the vertical then the horizontal 2*hbs window sums
// there, and hands each thread the cost of its 4 output pixels. Left pixels
// are read through L1 (neighbouring d reuse them). Every output pixel
// belongs to one thread: no atomics, no cross-CTA reduction.
//
// Bound: K2 must store D*H*W*4 bytes (1.27 GB at 1128x1408, D=200: 0.38 ms
// at 3.35 TB/s) and do the same ~44 flops per (pixel, plane) as K1 (0.21 ms
// at 67 TFLOP/s), so its bound is the stores. The routine re-sums both
// windows from shared memory (~47 accesses and 3 barriers per (pixel,
// plane)) and is bound by shared-memory bandwidth instead; K1
// (matcher_inputs.cuh) keeps its arithmetic order with register sums, and
// K2 moves onto that routine next.
//
// Numerics: every add and multiply is an explicit round-to-nearest
// intrinsic (no FMA contraction), 1/area is multiplied, not divided, and
// sqrt is IEEE. K1 adds in the same order, so volume_reductions of this
// volume equal K1's planes bit for bit on any input. Window sums of
// integer-valued images below 2^24 are exact in any order, so on such
// inputs the volume equals the plain PyTorch version bit for bit. Do not
// build with --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace stpu {

constexpr int kTileX = 64;
constexpr int kTileY = 16;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileY / (kThreads / kTileX);   // 4

// Shared-memory bytes of one CTA of K2.
inline size_t cost_tile_smem(int hbs) {
  const size_t rows = kTileY + 2 * hbs;
  const size_t cols = kTileX + 2 * hbs;
  return sizeof(float) * (rows * cols * 4 + kTileY * cols);
}

// One CTA's share of the cost: its tile, the staged right band, and each
// thread's 4 pixels (column x, rows y0 + ty + 4 * k).
struct CostTile {
  float* r_s;   // rows * cols * 3: right band
  float* s_s;   // rows * cols: masked dsq of the current plane
  float* v_s;   // kTileY * cols: vertical window sums
  int rows, cols, x0, y0, tx, ty, x, rgt;
  float inv_area[kRowsPerThread];
  bool pos_area[kRowsPerThread];
};

// Stage the right band and each thread's window geometry. The first
// plane_costs() call synchronises before anything reads the band.
__device__ __forceinline__ void cost_tile_init(CostTile& t, float* smem,
                                               const float* __restrict__ right,
                                               int H, int W, int hbs) {
  const int hw = 2 * hbs;
  t.rows = kTileY + hw;   // band row r <-> global row y0 - hbs + r
  t.cols = kTileX + hw;   // band col c <-> global col x0 - hbs + c
  t.r_s = smem;
  t.s_s = t.r_s + t.rows * t.cols * 3;
  t.v_s = t.s_s + t.rows * t.cols;
  t.x0 = blockIdx.x * kTileX;
  t.y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.x;

  for (int i = tid; i < t.rows * t.cols; i += kThreads) {
    const int gy = t.y0 - hbs + i / t.cols;
    const int gx = t.x0 - hbs + i % t.cols;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    for (int ch = 0; ch < 3; ++ch)
      t.r_s[i * 3 + ch] = in ? right[((size_t)gy * W + gx) * 3 + ch] : 0.0f;
  }

  t.tx = tid % kTileX;
  t.ty = tid / kTileX;    // this thread's rows: ty + 4 * k
  t.x = t.x0 + t.tx;
  const int lft = min(t.x, hbs);
  t.rgt = min(W - 1 - t.x, hbs);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = t.y0 + t.ty + (kThreads / kTileX) * k;
    const int up = min(y, hbs);
    const int down = min(H - 1 - y, hbs);
    const float area = (float)((lft + t.rgt) * (up + down));
    t.pos_area[k] = area > 0.0f;
    t.inv_area[k] = __fdiv_rn(1.0f, fmaxf(area, 1.0f));
  }
}

// Number of planes j for which the tile's first column still has a
// candidate. x + min(W-1-x, hbs) never decreases with x, so no pixel of
// the tile has a candidate at j or beyond: those planes are all +inf.
__device__ __forceinline__ int cost_tile_planes(const CostTile& t, int W,
                                                int WL, int hbs, int min_d,
                                                int D) {
  const int reach0 = t.x0 + min(W - 1 - t.x0, hbs);
  return max(0, min(D, WL - reach0 - min_d));
}

// The costs of one plane at a thread's 4 pixels.
struct PlaneCosts {
  float v[kRowsPerThread];
};

// The cost of disparity d at this thread's 4 pixels, +inf where invalid.
// Every thread of the CTA must call it: it synchronises.
__device__ __forceinline__ PlaneCosts plane_costs(const CostTile& t,
                                                  const float* __restrict__ left,
                                                  int H, int W, int WL,
                                                  int hbs, int d) {
  PlaneCosts plane;
  const float kInf = __int_as_float(0x7f800000);
  const int hw = 2 * hbs;
  const int tid = threadIdx.x;
  __syncthreads();               // band staged / previous plane consumed

  for (int i = tid; i < t.rows * t.cols; i += kThreads) {
    const int gy = t.y0 - hbs + i / t.cols;
    const int gx = t.x0 - hbs + i % t.cols;
    float v = 0.0f;
    if (gy >= 0 && gy < H - 1 && gx >= 0 && gx < W - 1) {
      const int lx = gx + d;
      const float* rp = t.r_s + i * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float l =
            lx < WL ? __ldg(left + ((size_t)gy * WL + lx) * 3 + ch) : 0.0f;
        const float diff = __fsub_rn(l, rp[ch]);
        v = __fadd_rn(v, __fmul_rn(diff, diff));
      }
    }
    t.s_s[i] = v;
  }
  __syncthreads();

  for (int i = tid; i < kTileY * t.cols; i += kThreads) {
    const int r = i / t.cols;
    const int c = i % t.cols;
    float acc = 0.0f;
    for (int q = 0; q < hw; ++q) acc = __fadd_rn(acc, t.s_s[(r + q) * t.cols + c]);
    t.v_s[i] = acc;
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = t.ty + (kThreads / kTileX) * k;
    float h = 0.0f;
    for (int q = 0; q < hw; ++q) h = __fadd_rn(h, t.v_s[r * t.cols + t.tx + q]);
    const float cost = __fmul_rn(__fsqrt_rn(fmaxf(h, 0.0f)), t.inv_area[k]);
    const bool valid = t.pos_area[k] && (t.x + d + t.rgt < WL);
    plane.v[k] = valid ? cost : kInf;
  }
  return plane;
}

// K2: the full (D, H, W) volume.
__global__ void __launch_bounds__(kThreads)
cost_volume_kernel(const float* __restrict__ left,    // (H, WL, 3)
                   const float* __restrict__ right,   // (H, W, 3)
                   float* __restrict__ cost,          // (D, H, W)
                   int H, int W, int WL, int hbs, int min_d, int D) {
  extern __shared__ float smem[];
  const float kInf = __int_as_float(0x7f800000);
  CostTile t;
  cost_tile_init(t, smem, right, H, W, hbs);

  const int j_end = cost_tile_planes(t, W, WL, hbs, min_d, D);
  const bool col_in = t.x < W;
  for (int j = 0; j < D; ++j) {
    PlaneCosts plane;
    if (j < j_end) {               // uniform across the CTA
      plane = plane_costs(t, left, H, W, WL, hbs, min_d + j);
    } else {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) plane.v[k] = kInf;
    }
    if (!col_in) continue;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int y = t.y0 + t.ty + (kThreads / kTileX) * k;
      if (y < H) cost[((size_t)j * H + y) * W + t.x] = plane.v[k];
    }
  }
}

}  // namespace stpu
