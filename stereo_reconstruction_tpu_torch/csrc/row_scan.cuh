// K1b — the exact smoothing row scan, CUDA C++ for Hopper (sm_90a).
//
// Replaces the lax.scan of stereo_reconstruction_tpu/ops/smoothing.py::
// smoothed_argmin_from_inputs (not a Pallas kernel: on the TPU it was an
// XLA loop). From the five planes of K1 (m0, a0, c_zero, diag_up, diag_lf)
// and the black mask it runs the Right variant's smoothing recurrence
// (BlockSearch.cpp:160-171) row by row, exactly:
//
//   * the up neighbour is the previous row's final disparity, so rows are
//     sequential; row 0 has none;
//   * inside a row the left neighbour acts through a 3-state automaton
//     (left chose none of the special values / 0 / the sentinel -x). Each
//     pixel's disparity under each of the 3 input cases (d_none, d_zero,
//     d_sent) depends on the row above only, and its case transition packs
//     into 6 bits; an inclusive scan of the composition (b o a)[c] = b[a[c]]
//     gives every pixel's true input case.
//
// Design: one CTA walks all H rows and keeps the previous row in registers;
// thread t owns the K consecutive columns t*K .. t*K+K-1 (K = ceil(W/1024),
// W <= 4096). The planes do not depend on the previous row, so each thread
// loads its columns of the next row while it works on the current one.
// Per row a thread forms its columns' three candidates and transitions,
// composes them, and the CTA scans the per-thread maps: warp shuffles, then
// every warp scans the 32 warp totals itself, so one barrier per row
// suffices (the totals are double-buffered by row). On one SM the row is
// issue-bound, so a composition is one shared-memory lookup in a 64 x 64
// table of 6-bit maps rather than ~15 dependent integer operations.
//
// Bound: the bytes are 25 per pixel (five planes, the mask, the output):
// 40 MB at 1128x1408, 0.012 ms at 3.35 TB/s, and the arithmetic is tens of
// operations per pixel. Neither binds: the chain of H dependent rows does,
// each row about two microseconds of issue, shuffle and barrier latency on
// one SM.
//
// Exactness: the products are __fmul_rn in the plain version's order
// (up_val * sf, then * extra; lf_val * sf, then * extra), the ties keep the
// lexicographic (value, index) rule with the -1 index of the "none" case,
// the x = 0 sentinel -0.0 equals 0.0 so the zero test comes first, and
// IEEE specials compare as in torch (inf * 0 = NaN compares false), so the
// output equals ops/smoothing.py::smoothed_argmin_from_inputs bit for bit
// on any input.

#pragma once

#include <cuda_runtime.h>

namespace stpu {
namespace k1b {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCols = 4;     // columns per thread: W <= 4096
constexpr unsigned kIdentity = 0u | (1u << 2) | (2u << 4);

__device__ __forceinline__ unsigned map_at(unsigned m, unsigned c) {
  return (m >> (2 * c)) & 3u;
}

// (b o a)[c] = b[a[c]]: a first, then b
__device__ __forceinline__ unsigned compose(unsigned b, unsigned a) {
  return map_at(b, a & 3u) | (map_at(b, (a >> 2) & 3u) << 2) |
         (map_at(b, (a >> 4) & 3u) << 4);
}

// The pixel's disparity when its left neighbour offers (lf_val, lf_idx):
// lexicographic min of the plain argmin, the up candidate and the left one.
__device__ __forceinline__ float resolve(float m0, int a0, float v_u, int up_idx,
                                         float lf_val, int lf_idx, float sf,
                                         int d_first, float sentinel, bool black) {
  const bool both = lf_idx == up_idx && isfinite(v_u) && isfinite(lf_val);
  const float extra = both ? sf : 1.0f;
  float best = m0;
  int bidx = a0;
  const float v2 = __fmul_rn(v_u, extra);
  if (v2 < best || (v2 == best && up_idx < bidx)) {
    best = v2;
    bidx = up_idx;
  }
  const float v3 = __fmul_rn(__fmul_rn(lf_val, sf), extra);
  if (v3 < best || (v3 == best && lf_idx < bidx)) {
    best = v3;
    bidx = lf_idx;
  }
  const float disp = isfinite(best) ? (float)(d_first + bidx) : sentinel;
  return black ? 0.0f : disp;
}

__device__ __forceinline__ unsigned case_of(float d, float sentinel) {
  return d == 0.0f ? 1u : (d == sentinel ? 2u : 0u);
}

}  // namespace k1b

template <int K>
__global__ void __launch_bounds__(k1b::kMaxThreads)
row_scan_kernel(const float* __restrict__ m0, const int* __restrict__ a0,
                const float* __restrict__ cz, const float* __restrict__ du,
                const float* __restrict__ dl,
                const unsigned char* __restrict__ black,
                float* __restrict__ out, int H, int W, float sf, int d_first,
                int D) {
  using k1b::case_of;
  using k1b::compose;
  using k1b::kIdentity;
  using k1b::map_at;
  using k1b::resolve;
  // warp totals, double-buffered by row: a warp may write row y+1's while
  // a slower one still reads row y's, and row y+2's only after the barrier
  // that every warp passes after its row-y reads
  __shared__ unsigned totals[2][32];
  // compose(b, a) for every pair of 6-bit maps: one shared load per
  // composition instead of ~15 dependent integer operations
  __shared__ unsigned char table[64 * 64];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int i = tid; i < 64 * 64; i += blockDim.x) table[i] = compose(i >> 6, i & 63);
  auto cmp = [&](unsigned b, unsigned a) { return (unsigned)table[(b << 6) | a]; };
  const float kInf = __int_as_float(0x7f800000);
  const unsigned full = 0xffffffffu;
  const int xk = tid * K;                 // this thread's first column

  // the next row's inputs, loaded one row ahead: they do not depend on the
  // scan, so their latency hides under the current row
  float n_m0[K] = {}, n_cz[K] = {}, n_du[K] = {}, n_dl[K] = {};
  int n_a0[K] = {};
  bool n_blk[K] = {};
  auto load = [&](int y) {
    const size_t row = (size_t)y * W;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = xk + k;
      if (x < W) {
        n_m0[k] = __ldg(m0 + row + x);
        n_a0[k] = __ldg(a0 + row + x);
        n_cz[k] = __ldg(cz + row + x);
        n_du[k] = __ldg(du + row + x);
        n_dl[k] = __ldg(dl + row + x);
        n_blk[k] = __ldg(black + row + x) != 0;
      }
    }
  };
  load(0);
  __syncthreads();                        // the table is built

  const int i_zero = -d_first;
  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = 0.0f;

  for (int y = 0; y < H; ++y) {
    float c_m0[K], c_cz[K], c_du[K], c_dl[K];
    int c_a0[K];
    bool c_blk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c_m0[k] = n_m0[k];
      c_a0[k] = n_a0[k];
      c_cz[k] = n_cz[k];
      c_du[k] = n_du[k];
      c_dl[k] = n_dl[k];
      c_blk[k] = n_blk[k];
    }
    if (y + 1 < H) load(y + 1);

    float dn[K] = {}, dz[K] = {}, ds[K] = {};
    unsigned maps = 0;                  // K transitions of 6 bits
    unsigned mine = kIdentity;          // their composition
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = xk + k;
      unsigned g = kIdentity;
      if (x < W) {
        const float sentinel = -(float)x;
        const float p = prev[k];
        const bool up_zero = p == 0.0f;
        const int up_idx = up_zero ? i_zero : min(max(x - d_first, 0), D - 1);
        float v_u = kInf;
        if (y > 0) {
          const float up_val = up_zero ? c_cz[k] : (p == sentinel ? c_du[k] : kInf);
          v_u = __fmul_rn(up_val, sf);
        }
        dn[k] = resolve(c_m0[k], c_a0[k], v_u, up_idx, kInf, -1, sf, d_first,
                        sentinel, c_blk[k]);
        dz[k] = resolve(c_m0[k], c_a0[k], v_u, up_idx, c_cz[k], i_zero, sf, d_first,
                        sentinel, c_blk[k]);
        ds[k] = resolve(c_m0[k], c_a0[k], v_u, up_idx, c_dl[k],
                        min(max(x - 1 - d_first, 0), D - 1), sf, d_first, sentinel,
                        c_blk[k]);
        g = case_of(dn[k], sentinel) | (case_of(dz[k], sentinel) << 2) |
            (case_of(ds[k], sentinel) << 4);
      }
      maps |= g << (6 * k);
      mine = cmp(g, mine);
    }

    // inclusive scan of the per-thread maps across the CTA
    unsigned v = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(full, v, off);
      if (lane >= off) v = cmp(v, o);
    }
    unsigned* tot = totals[y & 1];
    if (lane == 31) tot[warp] = v;
    unsigned before = __shfl_up_sync(full, v, 1);     // lanes below, this warp
    if (lane == 0) before = kIdentity;
    __syncthreads();
    unsigned t = lane < nwarps ? tot[lane] : kIdentity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(full, t, off);
      if (lane >= off) t = cmp(t, o);
    }
    unsigned warps_before = __shfl_sync(full, t, (warp + 31) & 31);
    if (warp == 0) warps_before = kIdentity;

    // the case entering this thread's first column (x = 0 enters with 0)
    unsigned c = map_at(before, map_at(warps_before, 0));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = xk + k;
      if (x < W) {
        const float r = c == 0 ? dn[k] : (c == 1 ? dz[k] : ds[k]);
        out[(size_t)y * W + x] = r;
        prev[k] = r;
      }
      c = map_at((maps >> (6 * k)) & 63u, c);
    }
  }
}

}  // namespace stpu
