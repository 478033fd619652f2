// K1 — the fused matcher inputs, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stereo_reconstruction_tpu/ops/
// pallas_cost_volume.py::_kernel in mode "inputs" (wrapper
// pallas_matcher_inputs). For every output pixel (y, x) of the right image
// and every plane j in [0, D) (disparity d = min_d + j) it forms the
// reference cost (BlockSearch.cpp:116-158)
//
//   cost = sqrt(SSD over [y-hbs, y+hbs) x [x-hbs, x+hbs) clipped to
//               [0, H-1) x [0, W-1)) * (1 / area),
//   +inf where area <= 0 or x + d + min(W-1-x, hbs) >= WL,
//
// and folds the planes, in increasing j, into the five planes of the exact
// smoothing scan: m0 (min), a0 (first argmin, strict <), c_zero (plane
// j == -min_d), diag_up (plane with d == x) and diag_lf (plane with
// d == x - 1). The (D, H, W) volume is never written.
//
// Arithmetic order (the same as K2's plane_costs in cost_volume.cuh, so K1's
// planes equal volume_reductions(K2) bit for bit on any input): the squared
// difference adds channels 0, 1, 2 from 0; the vertical window sum adds
// rows y-hbs .. y+hbs-1 in order from 0; the horizontal sum adds columns
// x-hbs .. x+hbs-1 of those in order from 0; then IEEE sqrt and a multiply
// by 1/area. Every operation is an explicit round-to-nearest intrinsic (no
// FMA contraction). Do not build with --use_fast_math.
//
// Bound. Per (pixel, plane) with a candidate the work is 9 flops of
// squared difference, 2 * 2hbs window adds, a sqrt, a multiply and a
// compare: about 44 flops, 1.3e10 at 1128x1408, D=200, block 17, or 0.19 ms
// at 67 TFLOP/s; the images and the five planes are ~70 MB (0.02 ms). The
// fixed summation order forbids sliding sums: every window sum is 2hbs
// adds that no neighbour can share. So K1 is bound by arithmetic and by
// the latency of its loads, not by device memory.
//
// Design. K2's routine (cost_volume.cuh) re-sums both windows from shared
// memory: ~47 shared-memory accesses and 3 barriers per (pixel, plane), so
// it is bound by shared memory, not by arithmetic. Here one CTA of 384
// threads owns a 48 x 64 output tile and walks its planes in three phases
// split by two barriers:
//   A1  the masked dsq of the (48 + 2hbs) x (64 + 2hbs) band: a thread owns
//       one band column and every TC-th band row (TC = 384 / band width,
//       4 at hbs 8). The right band is
//       staged once in shared memory; the left comes from a layout pass
//       (left_layout_kernel: channels 0-1 as float2, channel 2 as float,
//       zero-padded past WL), so a pixel is two coalesced loads. The loads
//       carry no branch, so all of a thread's loads of a plane are in
//       flight together; interior tiles skip the masks. One shared write
//       per dsq.
//   A2  a thread owns (band column, 12 output rows): it reads the 11 + 2hbs
//       dsq of that segment once and forms the 12 vertical sums in
//       registers. One shared write per sum.
//   B   a thread owns 8 consecutive outputs of one row: it reads the
//       7 + 2hbs vertical sums once, forms the 8 horizontal sums in
//       registers, and folds sqrt * 1/area into m0/a0. The cost is
//       non-decreasing in the window sum h, so only a plane whose h is
//       below the smallest h so far can lower m0: the sqrt is taken for
//       those planes alone (exact, and ~10% of K1's time at (b)). c_zero,
//       diag_up and diag_lf are stored straight from the one plane each
//       pixel needs.
//       The sums' row stride is odd and a warp covers 8 rows x 4 groups, so
//       its reads are free of bank conflicts.
// That is ~5 shared-memory accesses and 2 barriers per (pixel, plane); the
// taller tile cuts the vertical halo to 1.33x. Two CTAs fit an SM (97.5 KB
// of shared memory and 80 registers each at hbs 8): more warps per SM hid
// more latency than one barrier per plane with double-buffered sums did
// (a pipelined variant with 16 warps per SM was slower, NVIDIA H100).
// hbs is a template parameter (0..8, block sizes up to 17: the TPU
// kernel's 24-row bands hold 8 + 2*8 rows at most), so every register
// array has a fixed size.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace stpu {
namespace k1 {

constexpr int kTX = 64;        // output columns per CTA
constexpr int kTY = 48;        // output rows per CTA
constexpr int kThreads = 384;
constexpr int kP = 8;          // outputs per thread in phase B
constexpr int kSegs = 4;       // phase-A2 row segments per band column
constexpr int kSegRows = (kTY + kSegs - 1) / kSegs;   // 12
constexpr int kMaxHbs = 8;

template <int HBS>
struct Tile {
  static constexpr int HW = 2 * HBS;
  static constexpr int BR = kTY + HW;            // band rows
  static constexpr int BC = kTX + HW;            // band columns
  static constexpr int TC = kThreads / BC;       // phase-A1 threads per column
  static constexpr int NE = (BR + TC - 1) / TC;  // band rows per A1 thread
  static constexpr int VS = BC | 1;              // odd row stride of the sums
  static constexpr int NV = kSegRows + HW - 1;   // dsq one A2 thread reads
  static constexpr int NH = kP + HW - 1;         // sums one B thread reads
  static constexpr size_t kSmem = sizeof(float) * (4 * BR * BC + kTY * VS);
  static_assert(TC >= 1 && BC * kSegs <= kThreads, "tile too wide");
};

}  // namespace k1

// K1's layout of the left image: channels 0-1 as float2 and channel 2 as
// float, (H, WLp) each, zero past column WL (where the cost reads 0), so a
// band pixel is one 8-byte and one 4-byte load.
__global__ void left_layout_kernel(const float* __restrict__ left,   // (H, WL, 3)
                                   float2* __restrict__ left_rg,
                                   float* __restrict__ left_b,
                                   int H, int WL, int WLp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * WLp) return;
  const int y = i / WLp, x = i % WLp;
  float2 rg = make_float2(0.0f, 0.0f);
  float b = 0.0f;
  if (x < WL) {
    const float* px = left + ((size_t)y * WL + x) * 3;
    rg = make_float2(px[0], px[1]);
    b = px[2];
  }
  left_rg[i] = rg;
  left_b[i] = b;
}

template <int HBS>
__global__ void __launch_bounds__(k1::kThreads, 2)
matcher_inputs_kernel(const float2* __restrict__ left_rg,   // (H, WLp)
                      const float* __restrict__ left_b,     // (H, WLp)
                      const float* __restrict__ right,      // (H, W, 3)
                      float* __restrict__ m0, int* __restrict__ a0,
                      float* __restrict__ cz, float* __restrict__ du,
                      float* __restrict__ dl,
                      int H, int W, int WL, int WLp, int min_d, int D) {
  using k1::kP;
  using k1::kSegRows;
  using k1::kSegs;
  using k1::kThreads;
  using k1::kTX;
  using k1::kTY;
  using T = k1::Tile<HBS>;
  extern __shared__ float smem[];
  float2* right_rg = reinterpret_cast<float2*>(smem);   // BR x BC
  float* right_b = smem + 2 * T::BR * T::BC;            // BR x BC
  float* dsq_s = right_b + T::BR * T::BC;               // BR x BC
  float* vs_s = dsq_s + T::BR * T::BC;                  // kTY x VS
  const float kInf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;

  // phase A1: band column c, band rows r1 + TC * k
  const bool a1 = tid < T::TC * T::BC;
  const int c1 = tid % T::BC;
  const int r1 = tid / T::BC;
  const int gx1 = x0 - HBS + c1;
  const bool col_in = a1 && gx1 >= 0 && gx1 < W - 1;
  unsigned row_in = 0;                   // bit k: band row of slot k inside [0, H-1)
#pragma unroll
  for (int k = 0; k < T::NE; ++k) {
    const int r = r1 + T::TC * k;
    const int gy = y0 - HBS + r;
    row_in |= (unsigned)(col_in && r < T::BR && gy >= 0 && gy < H - 1) << k;
  }
  for (int i = tid; i < T::BR * T::BC; i += kThreads) {
    const int gy = y0 - HBS + i / T::BC;
    const int gx = x0 - HBS + i % T::BC;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float2 rg = make_float2(0.0f, 0.0f);
    float bl = 0.0f;
    if (in) {
      const float* px = right + ((size_t)gy * W + gx) * 3;
      rg = make_float2(px[0], px[1]);
      bl = px[2];
    }
    right_rg[i] = rg;
    right_b[i] = bl;
  }
  __syncthreads();
  const int lbase = (y0 - HBS + r1) * WLp + gx1;  // left offset of slot 0
  // the whole band inside [0, H-1) x [0, W-1): no dsq is masked
  const bool interior = x0 >= HBS && x0 + kTX + HBS <= W - 1 && y0 >= HBS &&
                        y0 + kTY + HBS <= H - 1;

  // phase A2: band column c2, output rows seg * kSegRows ...
  const bool a2 = tid < T::BC * kSegs;
  const int c2 = tid % T::BC;
  const int seg = tid / T::BC;

  // phase B: output row ob, columns 8 * gb ... 8 * gb + 7; a warp covers
  // 8 rows x 4 groups
  const int warp = tid >> 5, lane = tid & 31;
  const int ob = (warp >> 1) * 8 + (lane >> 2);
  const int gb = (warp & 1) * 4 + (lane & 3);
  const int y = y0 + ob;
  const int xb = x0 + kP * gb;
  const bool row_out = y < H;
  // a window is empty only if the image is one pixel tall or wide (or hbs
  // is 0); then every plane is +inf
  const bool windows = HBS > 0 && H > 1 && W > 1;
  float inv_area[kP];
  {
    const int up = min(y, HBS);
    const int down = min(H - 1 - y, HBS);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int x = xb + p;
      const int lft = min(x, HBS);
      const int rgt = min(W - 1 - x, HBS);
      const float area = (float)((lft + rgt) * (up + down));
      inv_area[p] = __fdiv_rn(1.0f, fmaxf(area, 1.0f));
    }
  }
  float acc_m0[kP];
  float acc_h[kP];                       // smallest window sum so far
  int acc_a0[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    acc_m0[p] = kInf;
    acc_h[p] = kInf;
    acc_a0[p] = 0;
    const int x = xb + p;
    if (row_out && x < W) {              // planes no candidate reaches stay +inf
      const size_t o = (size_t)y * W + x;
      cz[o] = kInf;
      du[o] = kInf;
      dl[o] = kInf;
    }
  }

  // x + min(W-1-x, hbs) never decreases with x, so no pixel of the tile has
  // a candidate at j_end or beyond
  const int reach0 = x0 + min(W - 1 - x0, HBS);
  const int j_end = max(0, min(D, WL - reach0 - min_d));
  for (int j = 0; j < j_end; ++j) {
    const int d = min_d + j;

    // A1: the masked dsq of the band
    // branch-free, so the compiler can put every load of the plane in
    // flight at once; masked rows load a valid address and store 0. The
    // left is zero-padded past WL, as the cost reads it. Where TC * NE > BR
    // the last slot of some threads lies below the band, and below the
    // image for a tile whose band ends at row H-2: it loads nothing there
    // on either path.
    auto a1_plane = [&](auto masked) {
#pragma unroll
      for (int k = 0; k < T::NE; ++k) {
        const int r = r1 + T::TC * k;
        const bool in = decltype(masked)::value ? ((row_in >> k) & 1u) != 0
                                                : (k < T::NE - 1 || r < T::BR);
        const int off = in ? lbase + T::TC * k * WLp + d : 0;
        const float2 lrg = __ldg(left_rg + off);
        const float lb = __ldg(left_b + off);
        const float2 rrg = right_rg[r * T::BC + c1];
        const float d0 = __fsub_rn(lrg.x, rrg.x);
        const float d1 = __fsub_rn(lrg.y, rrg.y);
        const float d2 = __fsub_rn(lb, right_b[r * T::BC + c1]);
        // 0 + d0^2 == d0^2 (a square is >= +0)
        const float v = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                  __fmul_rn(d2, d2));
        if (k < T::NE - 1 || r < T::BR) dsq_s[r * T::BC + c1] = in ? v : 0.0f;
      }
    };
    if (a1) {
      if (interior)
        a1_plane(std::false_type{});
      else
        a1_plane(std::true_type{});
    }
    __syncthreads();

    // A2: vertical sums from registers (0 + s == s for the first term:
    // the dsq are >= +0)
    if (a2) {
      float s[T::NV];
#pragma unroll
      for (int i = 0; i < T::NV; ++i) s[i] = dsq_s[(seg * kSegRows + i) * T::BC + c2];
#pragma unroll
      for (int o = 0; o < kSegRows; ++o) {
        float acc = 0.0f;
        if constexpr (T::HW > 0) {
          acc = s[o];
#pragma unroll
          for (int q = 1; q < T::HW; ++q) acc = __fadd_rn(acc, s[o + q]);
        }
        if (seg * kSegRows + o < kTY) vs_s[(seg * kSegRows + o) * T::VS + c2] = acc;
      }
    }
    __syncthreads();

    // B: horizontal sums, cost, fold
    float v[T::NH];
#pragma unroll
    for (int i = 0; i < T::NH; ++i) v[i] = vs_s[ob * T::VS + kP * gb + i];
    // pixel p has a candidate iff min(W-1, x + hbs) < WL - d: a prefix of p
    const int n_valid = !windows ? 0
                        : W - 1 < WL - d ? kP
                                         : min(max(WL - d - xb - HBS, 0), kP);
    float hh[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      float h = 0.0f;
      if constexpr (T::HW > 0) {
        h = v[p];
#pragma unroll
        for (int q = 1; q < T::HW; ++q) h = __fadd_rn(h, v[p + q]);
      }
      hh[p] = fmaxf(h, 0.0f);
      // f(h) = sqrt(h) * inv_area never decreases with h: a plane lowers m0
      // only if its h is below every earlier one (ties keep the first j)
      if (p < n_valid && hh[p] < acc_h[p]) {
        acc_h[p] = hh[p];
        const float c = __fmul_rn(__fsqrt_rn(hh[p]), inv_area[p]);
        if (c < acc_m0[p]) {
          acc_m0[p] = c;
          acc_a0[p] = j;
        }
      }
    }
    // the planes c_zero, diag_up (d == x) and diag_lf (d == x - 1) keep
    const int dd = d - xb;
    if (row_out && (j == -min_d || (dd >= -1 && dd < kP))) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int x = xb + p;
        if (x >= W) break;
        const size_t o = (size_t)y * W + x;
        const float cost = p < n_valid ? __fmul_rn(__fsqrt_rn(hh[p]), inv_area[p]) : kInf;
        if (j == -min_d) cz[o] = cost;
        if (dd == p) du[o] = cost;
        if (dd == p - 1) dl[o] = cost;
      }
    }
  }

  if (!row_out) return;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int x = xb + p;
    if (x >= W) continue;
    const size_t o = (size_t)y * W + x;
    m0[o] = acc_m0[p];
    a0[o] = acc_a0[p];
  }
}

}  // namespace stpu
