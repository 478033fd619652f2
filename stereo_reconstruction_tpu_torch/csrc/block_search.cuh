// K3 — fused Right-variant block search, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel stereo_reconstruction_tpu/ops/
// pallas_block_search.py::_kernel (wrapper pallas_block_search_right): the
// whole approximate search of one image pair. The image is cut into W tiles
// of TW columns, and the tiles are part of the result. For every output row
// y in order, and every column x, it
//
//   1. takes the Right-variant SSD cost of every candidate d = min_d + j
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
//   4. writes -x where no candidate is finite, or where a discounted cost of
//      the column is NaN (+inf * 0 at smooth_factor 0: torch.min and
//      jnp.min let a NaN win), zeroes black right pixels (once, after the
//      last sweep), and keeps the row as the next row's prev.
//
// The TPU kernel walks its grid in order, one row at a time, because its
// grid is sequential. The function is not: no cost depends on the
// recurrence (the discounts change the argmin, not the window sums), and
// little state crosses a row. So K3 is two kernels, counted as one launch:
//
// Phase 1, the cost pass (block_search_costs_kernel): the window-cost
// routine of K1 and K2 (window_cost.cuh) over all tiles, on every SM. Its
// sink stores the (D, H, W) volume (K2's store, into scratch) and keeps,
// per pixel, the three smallest costs with their first indices in
// (value, index) order; an empty slot is (+inf, 0xffff). No result reads
// the index of a +inf slot: a column whose best cost is +inf takes its
// sentinel whatever the index.
//
// Phase 2, the row chain (block_search_rows_kernel): one CTA of up to 1024
// threads walks the rows in order; thread t owns columns t, t + nt, ... of
// every row (no width limit). Per row:
//   A  each column's up discount. The two smallest up-discounted costs lie
//      among the undiscounted top 3 and plane j_up, so one gather of
//      cost[j_up] gives them (a NaN there marks the column: every sweep
//      gives its sentinel). Sweep 0 needs nothing more.
//   B  the tile boundaries: the final value of column x0 - 1 for every tile
//      start x0 = wt * TW > 0. Sweep s of a column needs sweep s-1 of its
//      left neighbour, so the final of x0 - 1 is a chain of iters - 1
//      gathers down the diagonal to a sweep-0 value. Where TW >= iters the
//      chain stays inside tile wt-1 and all boundaries go in parallel;
//      where TW < iters it can reach tile wt-1's own boundary, and one
//      thread takes the boundaries in order.
//   C  the iters - 1 Jacobi sweeps of all columns together, one gather and
//      one barrier each; the last zeroes black pixels and writes the row.
// Per-column state and the two sweep rows live in a small global scratch
// (8 W + n_tiles floats), private to the owning thread except across a
// barrier (in shared memory it was no faster). A thread keeps two columns'
// loads and gathers in flight at once, and asks for the next row's top 3
// and right pixels to be brought into L2 while it works on the current row.
// (Bringing the next row of every plane of the volume into L2 as well,
// ~9,000 prefetches per row at the canvas, made the chain slower: 9.4
// against 5.2 us per row, NVIDIA H100 80GB HBM3, 700 W.)
//
// Bound: the function reads both images and writes the disparity (0.04 GB
// at 1128x1408) and does K1's ~44 flops per (pixel, plane), 0.19 ms at
// 67 TFLOP/s. Phase 1 is K2 plus a top-3 fold: bound by its 1.27 GB of
// scratch stores (0.38 ms at 3.35 TB/s), which the function itself does not
// need. Phase 2 is bound by its chain of H rows, each ~2 + (iters - 1)
// dependent gathers from device memory and 2-3 barriers deep. At the
// 1128x1408 canvas, D=200, block 17, 3 tiles (NVIDIA H100 80GB HBM3,
// 700 W): phase 1 ~2.1 ms, phase 2 ~5.9 ms (~5.2 us per row).
//
// Numerics: the costs are K2's (K1's summation order, explicit
// round-to-nearest intrinsics, IEEE sqrt, 1/area multiplied); on
// integer-valued images every window sum is exact, so the disparity equals
// the plain PyTorch version bit for bit. The discounts are __fmul_rn, the
// argmin is lexicographic in (value, index). Do not build with
// --use_fast_math.

#pragma once

#include "cost_volume.cuh"

namespace stpu {

constexpr int kRowThreads = 1024;
constexpr int kNoPlane = 0xffff;   // index of an empty top-3 slot (D <= 0xffff)

// j with min_d + j == t for j in [0, D), else -1 (NaN gives -1): the
// plane a neighbour's disparity t discounts.
__device__ __forceinline__ int discounted_plane(float t, int min_d, int D) {
  if (!(t >= (float)min_d && t < (float)(min_d + D))) return -1;
  const int j = (int)t - min_d;
  return (float)(min_d + j) == t ? j : -1;
}

// K3's cost-pass sink: K2's store plus each pixel's top 3. The indices are
// 16 bits each: i01 = i0 | i1 << 16 per output, i2 two outputs per word.
struct TopSink {
  float* __restrict__ cost;              // (D, H, W)
  float* __restrict__ top_v;             // (3, H, W)
  int* __restrict__ top_i;               // (3, H, W)
  int H, W, D;
  float v0[wc::kP], v1[wc::kP], v2[wc::kP];
  unsigned i01[wc::kP], i2[wc::kP / 2];

  __device__ __forceinline__ void begin(const wc::Pixels&) {
    const float kInf = __int_as_float(0x7f800000);
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) {
      v0[p] = v1[p] = v2[p] = kInf;
      i01[p] = kNoPlane | (kNoPlane << 16);
    }
#pragma unroll
    for (int p = 0; p < wc::kP / 2; ++p) i2[p] = kNoPlane | (kNoPlane << 16);
  }

  __device__ __forceinline__ void set_i2(int p, unsigned j) {
    const int sh = 16 * (p & 1);
    i2[p >> 1] = (i2[p >> 1] & ~(0xffffu << sh)) | (j << sh);
  }

  __device__ __forceinline__ void plane(const wc::Pixels& px, int j, int,
                                        const float (&hh)[wc::kP], int n_valid) {
    if (!px.row_out) return;
    const float kInf = __int_as_float(0x7f800000);
    float c[wc::kP];
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) {
      c[p] = p < n_valid ? window_cost(hh[p], px.inv_area[p]) : kInf;
      // strict <: planes come in increasing j, so ties keep the first index
      if (c[p] < v2[p]) {
        const unsigned uj = (unsigned)j;
        if (c[p] < v1[p]) {
          v2[p] = v1[p];
          set_i2(p, i01[p] >> 16);
          if (c[p] < v0[p]) {
            v1[p] = v0[p];
            v0[p] = c[p];
            i01[p] = (i01[p] << 16) | uj;
          } else {
            v1[p] = c[p];
            i01[p] = (i01[p] & 0xffffu) | (uj << 16);
          }
        } else {
          v2[p] = c[p];
          set_i2(p, uj);
        }
      }
    }
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
    const size_t plane = (size_t)H * W;
#pragma unroll
    for (int p = 0; p < wc::kP; ++p) {
      const int x = px.xb + p;
      if (x >= W) continue;
      const size_t o = (size_t)px.y * W + x;
      top_v[o] = v0[p];
      top_v[plane + o] = v1[p];
      top_v[2 * plane + o] = v2[p];
      top_i[o] = (int)(i01[p] & 0xffffu);
      top_i[plane + o] = (int)(i01[p] >> 16);
      top_i[2 * plane + o] = (int)((i2[p >> 1] >> (16 * (p & 1))) & 0xffffu);
    }
  }
};

template <int HBS>
__global__ void __launch_bounds__(wc::kThreads, 2)
block_search_costs_kernel(const float2* __restrict__ left_rg,   // (H, WLp)
                          const float* __restrict__ left_b,     // (H, WLp)
                          const float* __restrict__ right,      // (H, W, 3)
                          float* __restrict__ cost,             // (D, H, W)
                          float* __restrict__ top_v,            // (3, H, W)
                          int* __restrict__ top_i,              // (3, H, W)
                          int H, int W, int WL, int WLp, int min_d, int D) {
  TopSink sink{cost, top_v, top_i, H, W, D};
  window_cost_tile<HBS>(left_rg, left_b, right, H, W, WL, WLp, min_d, D, 0, H, sink);
}

// A column's two smallest up-discounted costs, (m1, a1) <= (m2, a2) in
// (value, index) order; m1 is NaN where the discounted plane j_up is NaN.
// cu = cost[j_up] * sf.
struct Column {
  float m1, m2, cu;
  int a1, a2, up;
};

// The phase-2 scratch of a row: per-column state and two sweep rows.
struct RowScratch {
  float* m1;
  float* m2;
  float* cu;
  int* a1;
  int* a2;
  int* up;
  float* sweep[2];
  float* bnd;        // (n_tiles,) final value of the column left of each tile

  __device__ __forceinline__ RowScratch(float* s, int W) {
    m1 = s;
    m2 = s + W;
    cu = s + 2 * (size_t)W;
    a1 = reinterpret_cast<int*>(s + 3 * (size_t)W);
    a2 = reinterpret_cast<int*>(s + 4 * (size_t)W);
    up = reinterpret_cast<int*>(s + 5 * (size_t)W);
    sweep[0] = s + 6 * (size_t)W;
    sweep[1] = s + 7 * (size_t)W;
    bnd = s + 8 * (size_t)W;
  }
  __device__ __forceinline__ Column load(int x) const {
    return Column{m1[x], m2[x], cu[x], a1[x], a2[x], up[x]};
  }
  __device__ __forceinline__ void store(int x, const Column& c) const {
    m1[x] = c.m1;
    m2[x] = c.m2;
    cu[x] = c.cu;
    a1[x] = c.a1;
    a2[x] = c.a2;
    up[x] = c.up;
  }
};

// (v, i) into the lexicographic top 2 of c.
__device__ __forceinline__ void insert2(Column& c, float v, int i) {
  if (v < c.m1 || (v == c.m1 && i < c.a1)) {
    c.m2 = c.m1;
    c.a2 = c.a1;
    c.m1 = v;
    c.a1 = i;
  } else if (v < c.m2 || (v == c.m2 && i < c.a2)) {
    c.m2 = v;
    c.a2 = i;
  }
}

// The disparity of (value, index): -x (`sentinel`) unless the value is
// finite (a NaN is not).
__device__ __forceinline__ float resolved(float v, int i, int min_d, float sentinel) {
  return v < __int_as_float(0x7f800000) ? (float)i + (float)min_d : sentinel;
}

// Phase 2's fixed arguments.
struct Rows {
  const float* __restrict__ cost;        // (D, H, W)
  int H, W, D, min_d, TW;
  float sf;
  int sign;

  // The plane a left neighbour's disparity lf discounts (-1: none; NaN:
  // no neighbour).
  __device__ __forceinline__ int plane_of(float lf) const {
    return sign != 0 ? discounted_plane((float)sign * lf, min_d, D) : -1;
  }
  // The up-discounted cost of plane js of column x, row y (js >= 0): one
  // gather unless js is j_up.
  __device__ __forceinline__ float gather(const Column& c, int js, int x, int y) const {
    return js == c.up ? c.cu : __ldg(cost + ((size_t)js * H + y) * W + x);
  }
  // The sweep's disparity of column x from its plane js and that plane's
  // up-discounted cost cj.
  __device__ __forceinline__ float pick(const Column& c, int js, float cj, int x) const {
    const float sentinel = -(float)x;
    if (js < 0 || c.m1 != c.m1) return resolved(c.m1, c.a1, min_d, sentinel);
    const float v = __fmul_rn(cj, sf);
    if (v != v) return sentinel;
    // the smallest cost other than plane js, against plane js discounted
    const float ov = js == c.a1 ? c.m2 : c.m1;
    const int oi = js == c.a1 ? c.a2 : c.a1;
    if (v < ov || (v == ov && js < oi)) return resolved(v, js, min_d, sentinel);
    return resolved(ov, oi, min_d, sentinel);
  }
  // A sweep of column x of row y whose left neighbour's disparity is lf.
  __device__ __forceinline__ float sweep(const Column& c, float lf, int x, int y) const {
    const int js = plane_of(lf);
    return pick(c, js, js >= 0 && c.m1 == c.m1 ? gather(c, js, x, y) : 0.0f, x);
  }

  // The final (black-zeroed) disparity of column x0 - 1 of row y, for the
  // tile that starts at x0 > 0; reads the boundaries of earlier tiles where
  // TW < iters.
  __device__ float boundary(const RowScratch& rs, const float* __restrict__ right,
                            int x0, int y, int iters) const {
    int c = x0 - 1, k = iters - 1;
    while (k > 0 && c % TW != 0) {
      --c;
      --k;
    }
    const float kNaN = __int_as_float(0x7fffffff);
    float v = k == 0 ? rs.sweep[0][c]
                     : sweep(rs.load(c), c == 0 ? kNaN : rs.bnd[c / TW], c, y);
    while (c < x0 - 1) {
      ++c;
      v = sweep(rs.load(c), v, c, y);
    }
    return black(right, (size_t)y * W + x0 - 1) ? 0.0f : v;
  }

  __device__ __forceinline__ static bool black(const float* __restrict__ right, size_t o) {
    const float* rp = right + o * 3;
    return rp[0] == 0.0f && rp[1] == 0.0f && rp[2] == 0.0f;
  }
};

// Asks for the line at p to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Columns a phase-2 thread keeps in flight per stage: their loads and
// gathers are issued together.
constexpr int kRowCols = 2;

__global__ void __launch_bounds__(kRowThreads)
block_search_rows_kernel(Rows rows,
                         const float* __restrict__ top_v,   // (3, H, W)
                         const int* __restrict__ top_i,     // (3, H, W)
                         const float* __restrict__ right,   // (H, W, 3)
                         float* __restrict__ disp,          // (H, W)
                         float* __restrict__ scratch,       // 8 W + n_tiles
                         int iters) {
  constexpr int U = kRowCols;
  const int H = rows.H, W = rows.W, TW = rows.TW;
  const float kInf = __int_as_float(0x7f800000);
  const float kNaN = __int_as_float(0x7fffffff);
  const RowScratch rs(scratch, W);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_wt = (W + TW - 1) / TW;
  const size_t plane = (size_t)H * W;
  const float fsign = (float)rows.sign;

  for (int y = 0; y < H; ++y) {
    // A: the up discount and sweep 0
    for (int xb = tid; xb < W; xb += U * nt) {
      float tv[U][3], prev[U];
      int ti[U][3];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = min(xb + u * nt, W - 1);
        const size_t o = (size_t)y * W + x;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          tv[u][k] = __ldg(top_v + k * plane + o);
          ti[u][k] = __ldg(top_i + k * plane + o);
        }
        prev[u] = y >= 1 ? disp[o - W] : kNaN;
        if (y + 1 < H) {                 // the next row's loads, off the chain
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            prefetch_l2(top_v + k * plane + o + W);
            prefetch_l2(top_i + k * plane + o + W);
          }
          prefetch_l2(right + (o + W) * 3);
        }
      }
      Column c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = min(xb + u * nt, W - 1);
        c[u] = Column{kInf, kInf, 0.0f, kNoPlane, kNoPlane, -1};
        if (rows.sign != 0 && y >= 1) c[u].up = discounted_plane(fsign * prev[u], rows.min_d, rows.D);
        if (c[u].up >= 0)
          c[u].cu = __fmul_rn(__ldg(rows.cost + ((size_t)c[u].up * H + y) * W + x), rows.sf);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = xb + u * nt;
        if (x >= W) break;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (ti[u][k] != c[u].up) insert2(c[u], tv[u][k], ti[u][k]);
        if (c[u].up >= 0) {
          if (c[u].cu != c[u].cu)
            c[u].m1 = kNaN;
          else
            insert2(c[u], c[u].cu, c[u].up);
        }
        const float d0 = resolved(c[u].m1, c[u].a1, rows.min_d, -(float)x);
        const size_t o = (size_t)y * W + x;
        if (iters > 1) {
          rs.store(x, c[u]);
          rs.sweep[0][x] = d0;
        } else {
          disp[o] = Rows::black(right, o) ? 0.0f : d0;
        }
      }
    }
    if (iters <= 1) continue;           // no column reads another
    __syncthreads();

    // B: the tile boundaries
    if (n_wt > 1) {
      if (TW < iters) {
        if (tid == 0)
          for (int wt = 1; wt < n_wt; ++wt)
            rs.bnd[wt] = rows.boundary(rs, right, wt * TW, y, iters);
      } else {
        for (int wt = 1 + tid; wt < n_wt; wt += nt)
          rs.bnd[wt] = rows.boundary(rs, right, wt * TW, y, iters);
      }
      __syncthreads();
    }

    // C: the Jacobi sweeps; the last one writes the row
    for (int k = 1; k < iters; ++k) {
      const float* src = rs.sweep[(k - 1) & 1];
      float* dst = rs.sweep[k & 1];
      const bool last = k == iters - 1;
      for (int xb = tid; xb < W; xb += U * nt) {
        Column c[U];
        int js[U];
        float cj[U];
        bool blk[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int x = min(xb + u * nt, W - 1);
          c[u] = rs.load(x);
          const float lf = x % TW != 0 ? src[x - 1] : x == 0 ? kNaN : rs.bnd[x / TW];
          js[u] = rows.plane_of(lf);
          blk[u] = last && Rows::black(right, (size_t)y * W + x);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int x = min(xb + u * nt, W - 1);
          cj[u] = js[u] >= 0 && c[u].m1 == c[u].m1 ? rows.gather(c[u], js[u], x, y) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int x = xb + u * nt;
          if (x >= W) break;
          const float d = rows.pick(c[u], js[u], cj[u], x);
          if (!last)
            dst[x] = d;
          else
            disp[(size_t)y * W + x] = blk[u] ? 0.0f : d;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace stpu
