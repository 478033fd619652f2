// K3 — fused Right-variant block search, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stereo_reconstruction_tpu/ops/
// pallas_block_search.py::_kernel (wrapper pallas_block_search_right): the
// whole approximate search of one image pair in one kernel. The image is
// cut into W tiles of TW columns. For each tile in order, and each output
// row y in order, it
//
//   1. forms the Right-variant SSD cost of every candidate d = min_d + j
//      (the clipped window [y-hbs, y+hbs) x [x-hbs, x+hbs) of
//      [0, H-1) x [0, W-1), sqrt(SSD) * (1 / area), +inf where invalid);
//   2. multiplies by smooth_factor the candidate with d == sign * prev,
//      where prev is the row above's final disparity in this column
//      (from row 1 on; sign -1 in mode "reference", +1 in "intended",
//      no discount in "none");
//   3. resolves a first-index argmin with no left neighbour (sweep 0), then
//      iters - 1 Jacobi sweeps, each discounting d == sign * left, where
//      left is the previous sweep's disparity one column to the left (before
//      black zeroing); column 0 of tile wt > 0 takes tile wt-1's final
//      disparity of the same row, tile 0 has none;
//   4. writes -x where no candidate is finite, zeroes black right pixels
//      (once, after the last sweep), and keeps the row as the next row's
//      prev and its last column as the next tile's boundary.
//
// Design: one CTA runs the whole search; thread x owns column x of the
// current tile and loops over D, kSearchChunk planes at a time. The TPU's
// sequential grid becomes three loops inside the CTA: tiles (the boundary
// column), rows (the up neighbour), sweeps (each reads the whole previous
// sweep: one block-wide barrier and a shared row of disparities). Per image
// row s the CTA stages the channel-summed squared differences of a chunk of
// planes in shared memory; each thread takes its column's x-window sum of
// row s and slides a running column sum (float64) down one row: it adds
// row s and subtracts row s - 2*hbs, kept in a ring (2*hbs, D, TW). The
// TPU kernel re-summed all 2*hbs ring rows for every output row; the
// running sum reads 2 values instead of 2*hbs (1.6x faster at D=200,
// block 17 in one measurement on an H100). Ring, column sums and cost
// scratch (D, TW) are private to the thread that owns the column (no
// barrier, coalesced along x); at D=200, TW=512 they take 7.7 MB, which
// stays in the 50 MB L2. The sweeps need only each column's two smallest
// discounted costs (first-index order) and one gathered cost, so a sweep
// is O(TW), not O(D * TW).
//
// Bound: per row and tile, D*(TW+2*hbs)*9 flops of staging and D*TW*2*hbs
// shared-memory adds, all on one SM: the design uses 1 SM of 132 and is
// bound by that SM's issue rate and the latency its 16 warps cannot hide
// (on an H100 at 1128x1408, D=200, staging and x-window sums alone took
// 381 ms of 584). Later work: split D across a thread-block cluster, or
// overlap the tiles as a wavefront.
//
// Numerics: channels and the x window are summed in the TPU kernel's order
// with explicit round-to-nearest intrinsics, IEEE sqrt and 1/area
// multiplied; do not build with --use_fast_math. The column sum of those
// float32 values is exact in float64 (their exponents span far less than
// 53 - 24 bits on image data), so adding and later subtracting a row leaves
// no drift, and the window sum is that exact sum rounded once to float32.
// On integer-valued images every sum is exact, so the disparity equals the
// plain PyTorch version bit for bit.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace stpu {

constexpr int kSearchChunk = 8;        // planes staged per shared-memory pass
constexpr int kSearchMaxThreads = 1024;

// Shared-memory bytes of K3's CTA.
inline size_t block_search_smem(int TW, int hbs) {
  return sizeof(float) * ((size_t)kSearchChunk * (TW + 2 * hbs) + TW);
}

// j with min_d + j == t for j in [0, D), else -1 (NaN gives -1): the
// plane a neighbour's disparity t discounts.
__device__ __forceinline__ int discounted_plane(float t, int min_d, int D) {
  if (!(t >= (float)min_d && t < (float)(min_d + D))) return -1;
  const int j = (int)t - min_d;
  return (float)(min_d + j) == t ? j : -1;
}

__global__ void __launch_bounds__(kSearchMaxThreads)
block_search_kernel(const float* __restrict__ left,    // (H, WL, 3)
                    const float* __restrict__ right,   // (H, W, 3)
                    float* __restrict__ disp,          // (H, W)
                    float* __restrict__ ring,          // (2*hbs, D, TW)
                    float* __restrict__ cst,           // (D, TW)
                    float* __restrict__ boundary,      // (H,)
                    double* __restrict__ colsum,       // (D, TW)
                    int H, int W, int WL, int hbs, int min_d, int D, int TW,
                    float sf, int sign, int iters) {
  extern __shared__ float smem[];
  const float kInf = __int_as_float(0x7f800000);
  const float kNaN = __int_as_float(0x7fffffff);
  const int hw = 2 * hbs;
  const int span = TW + hw;
  float* dsq_s = smem;                          // kSearchChunk * span
  float* disp_s = dsq_s + kSearchChunk * span;  // TW
  const int x = threadIdx.x;
  const int nt = blockDim.x;
  const int n_wt = (W + TW - 1) / TW;
  const float fsign = (float)sign;

  for (int wt = 0; wt < n_wt; ++wt) {
    const int x0 = wt * TW;
    const int xg = x0 + x;
    const bool active = x < TW && xg < W;
    const int lft = min(xg, hbs);
    const int rgt = min(W - 1 - xg, hbs);
    const float sentinel = -(float)xg;
    float prev = 0.0f;    // final disparity of the row above, this column

    for (int s = 0; s < H + hbs - 1; ++s) {
      const int y = s - (hbs - 1);
      const bool fill = s < H - 1;        // row s enters some window
      const bool emit = y >= 0 && y < H;  // both uniform across the CTA
      const int slot = s % hw;

      float inv_area = 0.0f;
      bool pos_area = false;
      int j_up = -1;
      if (emit) {
        const int up = min(y, hbs);
        const int down = min(H - 1 - y, hbs);
        const float area = (float)((lft + rgt) * (up + down));
        pos_area = area > 0.0f;
        inv_area = __fdiv_rn(1.0f, fmaxf(area, 1.0f));
        if (sign != 0 && y >= 1) j_up = discounted_plane(fsign * prev, min_d, D);
      }

      // first-index lexicographic top 2 of the up-discounted costs
      float m1 = kInf, m2 = kInf;
      int a1 = 0, a2 = INT_MAX;

      for (int j0 = 0; j0 < D; j0 += kSearchChunk) {
        const int nc = min(kSearchChunk, D - j0);
        if (fill) {
          __syncthreads();                // previous chunk consumed
          for (int i = x; i < nc * span; i += nt) {
            const int jj = i / span;
            const int gc = x0 - hbs + i % span;
            float v = 0.0f;
            if (gc >= 0 && gc < W - 1) {
              const int lx = gc + min_d + j0 + jj;
              const float* rp = right + ((size_t)s * W + gc) * 3;
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) {
                const float l =
                    lx < WL ? __ldg(left + ((size_t)s * WL + lx) * 3 + ch) : 0.0f;
                const float diff = __fsub_rn(l, __ldg(rp + ch));
                v = __fadd_rn(v, __fmul_rn(diff, diff));
              }
            }
            dsq_s[jj * span + i % span] = v;
          }
          __syncthreads();
        }
        if (!active) continue;
        float rowx[kSearchChunk];         // row s's x-window sums
        if (fill) {
          for (int jj = 0; jj < nc; ++jj) {
            float acc = 0.0f;
            for (int k = 0; k < hw; ++k) acc = __fadd_rn(acc, dsq_s[jj * span + x + k]);
            rowx[jj] = acc;
          }
        }
        // slide the column sum down one row: drop row s - 2*hbs (if it
        // entered), add row s (if it enters); the ring slot of row s - 2*hbs
        // then takes row s
        float win[kSearchChunk];
        for (int jj = 0; jj < nc; ++jj) {
          const size_t o = ((size_t)slot * D + j0 + jj) * TW + x;
          const size_t q = (size_t)(j0 + jj) * TW + x;
          double cs = s == 0 ? 0.0 : colsum[q];
          if (s >= hw && s - hw < H - 1) cs = __dsub_rn(cs, (double)ring[o]);
          if (fill) {
            cs = __dadd_rn(cs, (double)rowx[jj]);
            ring[o] = rowx[jj];
          }
          colsum[q] = cs;
          win[jj] = __double2float_rn(cs);
        }
        if (!emit) continue;
#pragma unroll
        for (int jj = 0; jj < kSearchChunk; ++jj) {
          if (jj >= nc) break;
          const int j = j0 + jj;
          float c = __fmul_rn(__fsqrt_rn(fmaxf(win[jj], 0.0f)), inv_area);
          const bool valid = pos_area && (xg + min_d + j + rgt < WL);
          c = valid ? c : kInf;
          if (j == j_up) c = __fmul_rn(c, sf);
          cst[(size_t)j * TW + x] = c;
          if (c < m1) {
            m2 = m1; a2 = a1;
            m1 = c; a1 = j;
          } else if (c < m2) {
            m2 = c; a2 = j;
          }
        }
      }
      if (!emit) continue;

      // column 0's left neighbour: tile wt-1's final disparity of this
      // row, read before the first sweep barrier, which orders it before
      // thread TW-1 overwrites boundary[y] below
      const float first_left =
          (x == 0 && wt > 0 && iters > 1) ? boundary[y] : kNaN;
      // sweep 0: no left neighbour
      float d_cur = m1 < kInf ? (float)a1 + (float)min_d : sentinel;
      for (int it = 1; it < iters; ++it) {
        __syncthreads();                  // readers of the last sweep done
        if (x < TW) disp_s[x] = d_cur;
        __syncthreads();
        const float lf = x > 0 && x < TW ? disp_s[x - 1] : first_left;
        const int js = sign != 0 ? discounted_plane(fsign * lf, min_d, D) : -1;
        float bv = m1;
        int bi = a1;
        if (js >= 0) {
          // the smallest cost other than plane js, against plane js discounted
          const float v = __fmul_rn(cst[(size_t)js * TW + x], sf);
          const float ov = js == a1 ? m2 : m1;
          const int oi = js == a1 ? a2 : a1;
          if (v < ov || (v == ov && js < oi)) {
            bv = v; bi = js;
          } else {
            bv = ov; bi = oi;
          }
        }
        d_cur = bv < kInf ? (float)bi + (float)min_d : sentinel;
      }

      if (active) {
        const float* rp = right + ((size_t)y * W + xg) * 3;
        if (rp[0] == 0.0f && rp[1] == 0.0f && rp[2] == 0.0f) d_cur = 0.0f;
        disp[(size_t)y * W + xg] = d_cur;
      }
      prev = d_cur;
      if (x == TW - 1) boundary[y] = d_cur;
    }
    __syncthreads();    // the boundary column is visible to the next tile
  }
}

}  // namespace stpu
