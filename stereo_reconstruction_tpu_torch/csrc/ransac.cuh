// The pose layer's RANSAC, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's RANSAC,
// stereo_reconstruction_tpu/pose/ransac.py, is plain jnp that XLA fuses. The
// port's plain twin, pose/ransac.py (score_hypotheses and ransac_plain),
// is ~45,000 small PyTorch ops a call, ~12,750 of each
// eight-point solve being the 9x9 cyclic Jacobi of ops/small_linalg.py; even
// replayed from a CUDA graph the card then waits on the gaps between its
// sub-microsecond nodes. This kernel makes the call two launches:
//
//   1. hypotheses_kernel: one warp per hypothesis, B pairs x K hypotheses:
//      the sample (the s smallest uniforms among the first n_valid, ties to
//      the lower index: the twin's stable argsort), the eight-point solve,
//      the sample's pixel error, and F's Sampson inliers and match_fit over
//      all N matches;
//   2. refine_kernel: one warp per pair: the winner (argmax of
//      float32(inliers) - 1e-6 * mean error, ties to the first), the best
//      fitting hypothesis among the most-inlier ones, then `rounds` refits
//      on the current model's `support` tightest matches, each kept where it
//      loses no inliers, and every RansacResult field. A refit sorts the
//      matches by a key each, in shared memory up to kSharedKeys matches
//      and in the caller's (B, N) scratch past that, so N has no ceiling.
//
// What binds: one warp's serial chain of dependent float32 operations, not
// bytes (~0.5 MB of uniforms and ~12 KB of matches a pair: 0.15 us at 3.35
// TB/s) and not operations. An eight-point solve is 216 Jacobi rotations
// (6 sweeps x 36), 24 more for the 3x3 SVD, and 33 secular-equation steps
// for each of the four candidates' depths; each rotation is a chain of a
// division, two square roots and two reciprocals, all correctly rounded.
// The design keeps that chain short:
//
//   * a rotation's 32 changed entries of A are one a lane (and lane i < 9
//     holds row i of V in registers), each computed from the previous A in
//     one step (rows, then columns, as the twin's two in-place phases give
//     it), in shared memory: no shuffles, two __syncwarp around the writes;
//   * every lane computes the next rotation's 2 x 2 block itself, so the
//     chain from one rotation's c and s to the next's does not wait on
//     shared memory;
//   * the four (R, T) candidates are triangulated at once, a group of 8
//     lanes each, each lane up to 4 points: a bisection or Newton step is
//     three shuffles;
//   * the K hypotheses of a pair run on K warps at once (launch 1), so the
//     call's chain is one solve plus the `rounds` refits in series.
//
// On an H100 (700 W) a call at N = 500, K = 256 takes ~0.39 ms: ~0.13 ms a
// solve in series, a rotation ~730 cycles against ~375 for its exact
// scalar chain alone (the rest: the slow-path branches of the correctly
// rounded operations, which no instruction may cross, and the entry
// updates). Its bound is 0.26 us (operations; utils/roofline.py).
//
// The arithmetic is the twin's, in its order, each float32 operation
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into FMAs), with its constants and guards
// (the rotation's 1e-37, the secular equation's 1e-30 and 1e-7, the
// Sampson denominator's 1e-12) and its sweep and step counts (Jacobi 6 and
// 8, bisection 30, Newton 3). NaN takes torch's part: last in a sort,
// first in argmax and argmin, kept by clamp, minimum and maximum. Only the
// sums whose order a matrix product or a reduction chooses in the twin
// (chi^T chi, the small products, the mean error, the inlier sums and
// match_fit) may round apart from it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stpu {
namespace ransac {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPoints = 32;     // sample_size and refine_support at most
// N up to which the refits' sort keys live in shared memory; past it, in
// the caller's global scratch (Params::keys)
constexpr int kSharedKeys = 4096;
constexpr int kPointsPerLane = kMaxPoints / 8;
constexpr int kWarps = 4;          // hypotheses (warps) a block in launch 1
constexpr int kHypFloats = 23;     // a hypothesis: R (9), T (3), E (9), mean error, match fit
constexpr int kHypInts = 3;        // inliers (-1 invalid), valid, all below; then the sample

struct Params {
  const float* ml;            // (B, 3, N) homogeneous pixels
  const float* mr;
  const float* Kl;            // (B, 3, 3)
  const float* Kr;
  const long long* n_valid;   // (B,)
  const float* u;             // (B, K, N) uniforms
  float* hyp_f;               // (B, K, kHypFloats) scratch
  int* hyp_i;                 // (B, K, kHypInts + s) scratch
  int* picked;                // (B, 2) scratch: the winner and the best fitting hypothesis
  unsigned* keys;             // (B, N) scratch for N > kSharedKeys, else unused
  float* rotation;            // (B, 3, 3)
  float* translation;         // (B, 3)
  float* essential;           // (B, 3, 3)
  float* pose;                // (B, 4, 4)
  long long* sample_indices;  // (B, support)
  long long* inlier_count;    // (B,)
  float* mean_error;          // (B,)
  uint8_t* success;           // (B,) bool
  uint8_t* valid;             // (B,) bool
  float* fit_pose;            // (B, 4, 4)
  float* fit_error;           // (B,)
  int B, N, K, s, rounds, support;
  float threshold, threshold_sq;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ bool is_nan(float a) { return a != a; }
// torch.minimum / torch.maximum / clamp: NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return is_nan(a) || is_nan(b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return is_nan(a) || is_nan(b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
// torch.sign: NaN to 0
__device__ __forceinline__ float sign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

// (a @ b)[r][c] of row-major 3x3 matrices, summed left to right
__device__ __forceinline__ void matmul3(const float* a, const float* b, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[r * 3 + c] = add(add(mul(a[r * 3], b[c]), mul(a[r * 3 + 1], b[3 + c])),
                           mul(a[r * 3 + 2], b[6 + c]));
}

__device__ __forceinline__ void transpose3(const float* a, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r * 3 + c] = a[c * 3 + r];
}

// m @ v for a row-major 3x3 m
__device__ __forceinline__ void matvec3(const float* m, const float* v, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = add(add(mul(m[r * 3], v[0]), mul(m[r * 3 + 1], v[1])), mul(m[r * 3 + 2], v[2]));
}

// ops/geometry.py::skew
__device__ __forceinline__ void skew(const float* v, float* out) {
  out[0] = 0.0f;  out[1] = -v[2]; out[2] = v[1];
  out[3] = v[2];  out[4] = 0.0f;  out[5] = -v[0];
  out[6] = -v[1]; out[7] = v[0];  out[8] = 0.0f;
}

// ops/small_linalg.py::inv3 (adjugate over the determinant)
__device__ __forceinline__ void inv3(const float* m, float* out) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7],
              i = m[8];
  const float c11 = sub(mul(e, i), mul(f, h)), c12 = sub(mul(c, h), mul(b, i)),
              c13 = sub(mul(b, f), mul(c, e));
  const float c21 = sub(mul(f, g), mul(d, i)), c22 = sub(mul(a, i), mul(c, g)),
              c23 = sub(mul(c, d), mul(a, f));
  const float c31 = sub(mul(d, h), mul(e, g)), c32 = sub(mul(b, g), mul(a, h)),
              c33 = sub(mul(a, e), mul(b, d));
  const float det = add(add(mul(a, c11), mul(b, c21)), mul(c, c31));
  const float adj[9] = {c11, c12, c13, c21, c22, c23, c31, c32, c33};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = dvd(adj[k], det);
}

// ops/geometry.py::normalize_points: K^-1 x by back-substitution
__device__ __forceinline__ void normalize(const float* K, float p0, float p1, float p2,
                                          float* out) {
  const float u2 = dvd(p2, K[8]);
  const float u1 = dvd(sub(p1, mul(K[5], u2)), K[4]);
  out[0] = dvd(sub(sub(p0, mul(K[1], u1)), mul(K[2], u2)), K[0]);
  out[1] = u1;
  out[2] = u2;
}

// ops/geometry.py::fundamental_from_essential: Kr^-T E Kl^-1 at unit norm
__device__ __forceinline__ void fundamental(const float* E, const float* Klinv,
                                            const float* Krinv, float* F) {
  float KrT[9], t[9];
  transpose3(Krinv, KrT);
  matmul3(KrT, E, t);
  matmul3(t, Klinv, F);
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) ss = add(ss, mul(F[k], F[k]));
  const float norm = sqrt_rn(ss);
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = dvd(F[k], norm);
}

// pose/ransac.py::_sampson_sq of one match
__device__ __forceinline__ float sampson_sq(const float* F, const float* x, const float* y) {
  float Fx[3], Ftx[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    Fx[r] = add(add(mul(F[r * 3], x[0]), mul(F[r * 3 + 1], x[1])), mul(F[r * 3 + 2], x[2]));
    Ftx[r] = add(add(mul(F[r], y[0]), mul(F[3 + r], y[1])), mul(F[6 + r], y[2]));
  }
  const float dot = add(add(mul(y[0], Fx[0]), mul(y[1], Fx[1])), mul(y[2], Fx[2]));
  const float num = mul(dot, dot);
  const float den = add(add(add(mul(Fx[0], Fx[0]), mul(Fx[1], Fx[1])), mul(Ftx[0], Ftx[0])),
                        mul(Ftx[1], Ftx[1]));
  return dvd(num, nan_max(den, 1e-12f));
}

// an order on floats as torch's sort has it: -0 == +0, NaN after +inf
__device__ __forceinline__ unsigned order_key(float x) {
  if (is_nan(x)) return 0xffffffffu;
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// over the 8 lanes of a group
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 4; o; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = 4; o; o >>= 1) v = nan_min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int group_and(int v) {
#pragma unroll
  for (int o = 4; o; o >>= 1) v &= __shfl_xor_sync(kFull, v, o);
  return v;
}

// Lane r < count gets the index of the r-th smallest key(j), j < n, ties to
// the lower j (a stable ascending argsort's first `count`); n >= count.
template <class Key>
__device__ int select_smallest(int n, int count, Key key, int lane) {
  unsigned long long prev = 0;   // every key is above 0 (order_key >= 0x7fffff)
  int mine = 0;
  for (int r = 0; r < count; ++r) {
    unsigned long long best = ~0ull;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const unsigned long long k =
          (static_cast<unsigned long long>(key(j)) << 32) | static_cast<unsigned>(j);
      if (k > prev && k < best) best = k;
    }
    best = warp_min_u64(best);
    if (lane == r) mine = static_cast<int>(best & 0xffffffffu);
    prev = best;
  }
  return mine;
}

// A warp's shared memory: the points of a solve and Jacobi's two buffers.
struct WarpSmem {
  float xl[3][kMaxPoints];   // K^-1-normalised left points
  float xr[3][kMaxPoints];   // K^-1-normalised right points
  float obs[2][kMaxPoints];  // the right pixels
  float a[81];               // Jacobi's matrix
  float vec[16];             // broadcasts
};

// ops/small_linalg.py::jacobi_eigh's rotation of (p, q): c and s
__device__ __forceinline__ void rotation(float app, float aqq, float apq, float& c, float& s) {
  const bool small = fabsf(apq) <= 1e-37f;
  const float tau = dvd(sub(aqq, app), small ? 1.0f : mul(2.0f, apq));
  const float root = sqrt_rn(add(1.0f, mul(tau, tau)));
  const float sg = sign(tau);
  // 1 / x and +-1 / x as the correctly rounded reciprocal, which they equal
  const float t = sg == 0.0f ? __frcp_rn(add(tau, root)) : mul(sg, __frcp_rn(add(fabsf(tau), root)));
  const float cc = __frcp_rn(sqrt_rn(add(1.0f, mul(t, t))));
  const float ss = mul(t, cc);
  c = small ? 1.0f : cc;
  s = small ? 0.0f : ss;
}

// Rotation (p, q)'s new A[i][j] for i and j both in {p, q}: the column
// formula on the row formula's values, from the block A[p][p], A[q][q],
// A[p][q], A[q][p] as it stood before the rotation.
__device__ __forceinline__ float corner(bool ip, bool jp, float app, float aqq, float apq,
                                        float aqp, float c, float s) {
  const float rp = ip ? sub(mul(c, app), mul(s, aqp)) : add(mul(s, app), mul(c, aqp));
  const float rq = ip ? sub(mul(c, apq), mul(s, aqq)) : add(mul(s, apq), mul(c, aqq));
  return jp ? sub(mul(c, rp), mul(s, rq)) : add(mul(s, rp), mul(c, rq));
}

// c x0 - s x1 (first) or s x0 + c x1: a row or column entry of rotation (p, q)
__device__ __forceinline__ float rotate(bool first, float x0, float x1, float c, float s) {
  return first ? sub(mul(c, x0), mul(s, x1)) : add(mul(s, x0), mul(c, x1));
}

// Cyclic Jacobi on the symmetric N x N matrix `a` (row-major, in place),
// `sweeps` sweeps of the twin's (p, q) order. Lane i < N holds row i of V in
// `v` (set by the caller to I + 0 * A). The twin updates rows p, q of A in
// place, then columns p, q: 4N - 4 entries change (32 for N = 9), and lane
// l computes one of them from the previous A: lanes [0, N) row p's entry
// (p, l), [N, 2N) row q's, [2N, 3N - 2) column p's in the other rows and
// [3N - 2, 4N - 4) column q's:
//   row entry (i = p or q, j not p or q): c A[p][j] - s A[q][j] (i = p),
//                                         s A[p][j] + c A[q][j] (i = q)
//   column entry (i not p or q):          c A[i][p] - s A[i][q] (j = p),
//                                         s A[i][p] + c A[i][q] (j = q)
//   corner (i and j in p, q): the column formula on the row formula's values.
// The rotations form one chain: c and s need the block A[p][p], A[q][q],
// A[p][q] left by the rotation before. So every lane keeps the block in
// registers and computes the next rotation's block itself, by the same
// formulas, from c, s and entries it loads while c and s are computed; the
// entries go to shared memory between two __syncwarp off that chain.
template <int N>
__device__ void jacobi(float* a, float* v, int sweeps, int lane) {
  float bpp = a[0], bqq = a[N + 1], bpq = a[1], bqp = a[N];   // rotation (0, 1)'s block
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        // this lane's entry
        const bool active = lane < 4 * N - 4, row = lane < 2 * N;
        int i, j;
        if (row) {
          i = lane < N ? p : q;
          j = lane < N ? lane : lane - N;
        } else {
          j = lane < 3 * N - 2 ? p : q;
          i = lane - (lane < 3 * N - 2 ? 2 * N : 3 * N - 2);   // the i-th row other than p, q
          i += i >= p;
          i += i >= q;
        }
        float x0 = 0.0f, x1 = 0.0f;
        if (active) {
          x0 = row ? a[p * N + j] : a[i * N + p];
          x1 = row ? a[q * N + j] : a[i * N + q];
        }
        // the next rotation (np, nq) (the next sweep's first after the
        // last) and the entries its block is made from
        const int np = q + 1 < N ? p : (p + 2 < N ? p + 1 : 0);
        const int nq = q + 1 < N ? q + 1 : (p + 2 < N ? p + 2 : 1);
        float o0[4], o1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = e == 0 || e == 2 ? np : nq, je = e == 0 || e == 3 ? np : nq;
          const bool ir = ie == p || ie == q, jr = je == p || je == q;
          o0[e] = o1[e] = 0.0f;
          if (ir && !jr) {
            o0[e] = a[p * N + je];
            o1[e] = a[q * N + je];
          } else if (!ir && jr) {
            o0[e] = a[ie * N + p];
            o1[e] = a[ie * N + q];
          } else if (!ir) {
            o0[e] = a[ie * N + je];
          }
        }
        float c, s;
        rotation(bpp, bqq, bpq, c, s);
        const float x = row && (j == p || j == q)
                            ? corner(i == p, j == p, bpp, bqq, bpq, bqp, c, s)
                            : rotate(row ? i == p : j == p, x0, x1, c, s);
        float nb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = e == 0 || e == 2 ? np : nq, je = e == 0 || e == 3 ? np : nq;
          const bool ir = ie == p || ie == q, jr = je == p || je == q;
          if (ir && jr)
            nb[e] = corner(ie == p, je == p, bpp, bqq, bpq, bqp, c, s);
          else if (ir)
            nb[e] = rotate(ie == p, o0[e], o1[e], c, s);
          else if (jr)
            nb[e] = rotate(je == p, o0[e], o1[e], c, s);
          else
            nb[e] = o0[e];
        }
        if (lane < N) {
          const float vp = v[p], vq = v[q];
          v[p] = sub(mul(c, vp), mul(s, vq));
          v[q] = add(mul(s, vp), mul(c, vq));
        }
        __syncwarp();
        if (active) a[i * N + j] = x;
        __syncwarp();
        bpp = nb[0];
        bqq = nb[1];
        bpq = nb[2];
        bqp = nb[3];
      }
    }
  }
}

// the rank of each of the N diagonal entries of `a` in a stable ascending
// sort (torch.argsort(stable=True): NaN last); order[r] = the r-th
template <int N>
__device__ __forceinline__ void eig_order(const float* a, int* order) {
  unsigned key[N];
#pragma unroll
  for (int k = 0; k < N; ++k) key[k] = order_key(a[k * N + k]);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int rank = 0;
#pragma unroll
    for (int m = 0; m < N; ++m) rank += key[m] < key[k] || (key[m] == key[k] && m < k);
    order[rank] = k;
  }
}

template <int N>
__device__ __forceinline__ float pick(const float* v, int k) {
  float r = v[0];
#pragma unroll
  for (int m = 1; m < N; ++m) r = m == k ? v[m] : r;
  return r;
}

// secular equation's guard: |x| < 1e-30 pushed out to +-1e-30
__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < 1e-30f ? (x < 0.0f ? -1e-30f : 1e-30f) : x;
}

struct Solve {
  float R[9], T[3], E[9];
  bool valid;       // some candidate has every depth >= 0
  float err_sum;    // the points' right pixel errors, summed
  bool all_below;   // every error < threshold
};

// pose/eight_point.py::eight_point on the first s points of sm (s <= 32,
// filled and synchronised by the caller), with the errors of
// pose/ransac.py's scoring (the right pixel error of each reconstructed
// point). Every lane returns the same Solve.
__device__ Solve eight_point(WarpSmem& sm, int s, const float* Kr, float threshold,
                             int lane) {
  // chi^T chi: chi[i][3a + b] = xl_i[a] xr_i[b], summed over the points in order
  for (int e = lane; e < 45; e += 32) {
    int a = 0, r = e;
    while (r >= 9 - a) {
      r -= 9 - a;
      ++a;
    }
    const int b = a + r;
    float acc = 0.0f;
    for (int i = 0; i < s; ++i)
      acc = add(acc, mul(mul(sm.xl[a / 3][i], sm.xr[a % 3][i]),
                         mul(sm.xl[b / 3][i], sm.xr[b % 3][i])));
    const float sym = mul(0.5f, add(acc, acc));   // 0.5 (A + A^T)
    sm.a[a * 9 + b] = sym;
    sm.a[b * 9 + a] = sym;
  }
  __syncwarp();
  float v[9];
#pragma unroll
  for (int j = 0; j < 9; ++j)
    v[j] = lane < 9 ? add(lane == j ? 1.0f : 0.0f, mul(0.0f, sm.a[lane * 9 + j])) : 0.0f;
  jacobi<9>(sm.a, v, 6, lane);
  int order9[9];
  eig_order<9>(sm.a, order9);
  if (lane < 9) sm.vec[lane] = pick<9>(v, order9[0]);
  __syncwarp();
  // E0[r][c] = e[3c + r] (Eigen's column-major reshape)
  float E0[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) E0[r * 3 + c] = sm.vec[c * 3 + r];
  __syncwarp();

  // small_linalg.svd3_for_essential: Jacobi of E^T E, 8 sweeps
  if (lane < 9) {
    const int a = lane / 3, b = lane % 3;
    const float x = add(add(mul(E0[a], E0[b]), mul(E0[3 + a], E0[3 + b])),
                        mul(E0[6 + a], E0[6 + b]));
    sm.a[lane] = mul(0.5f, add(x, x));
  }
  __syncwarp();
  float v3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    v3[j] = lane < 3 ? add(lane == j ? 1.0f : 0.0f, mul(0.0f, sm.a[lane * 3 + j])) : 0.0f;
  jacobi<3>(sm.a, v3, 8, lane);
  int order3[3];
  eig_order<3>(sm.a, order3);
  if (lane < 3) {
#pragma unroll
    for (int j = 0; j < 3; ++j) sm.vec[lane * 3 + j] = v3[j];
  }
  __syncwarp();
  float Vf[9];   // V's columns in descending order (the twin's flip)
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) Vf[i * 3 + c] = sm.vec[i * 3 + order3[2 - c]];
  __syncwarp();
  auto unit = [&](float* x) {
    const float n = sqrt_rn(add(add(add(mul(x[0], x[0]), mul(x[1], x[1])), mul(x[2], x[2])),
                                1e-30f));
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = dvd(x[k], n);
  };
  const float v1[3] = {Vf[0], Vf[3], Vf[6]}, v2[3] = {Vf[1], Vf[4], Vf[7]};
  float u1[3], u2[3], u3[3];
  matvec3(E0, v1, u1);
  unit(u1);
  matvec3(E0, v2, u2);
  const float proj = add(add(mul(u2[0], u1[0]), mul(u2[1], u1[1])), mul(u2[2], u1[2]));
#pragma unroll
  for (int k = 0; k < 3; ++k) u2[k] = sub(u2[k], mul(proj, u1[k]));
  unit(u2);
  u3[0] = sub(mul(u1[1], u2[2]), mul(u1[2], u2[1]));
  u3[1] = sub(mul(u1[2], u2[0]), mul(u1[0], u2[2]));
  u3[2] = sub(mul(u1[0], u2[1]), mul(u1[1], u2[0]));
  const float U[9] = {u1[0], u2[0], u3[0], u1[1], u2[1], u3[1], u1[2], u2[2], u3[2]};
  const float det =
      add(sub(mul(Vf[0], sub(mul(Vf[4], Vf[8]), mul(Vf[5], Vf[7]))),
              mul(Vf[1], sub(mul(Vf[3], Vf[8]), mul(Vf[5], Vf[6])))),
          mul(Vf[2], sub(mul(Vf[3], Vf[7]), mul(Vf[4], Vf[6]))));
  const float sg = sign(det);
  Vf[2] = mul(Vf[2], sg);
  Vf[5] = mul(Vf[5], sg);
  Vf[8] = mul(Vf[8], sg);
  float Vt[9], Ut[9];
  transpose3(Vf, Vt);
  transpose3(U, Ut);

  // the candidates (eight_point.cpp:72-87): R = U Rz^T V^T, [T]x = U Rz sigma U^T,
  // for Rz and Rz^T; candidate g = (R1, T1), (R1, T2), (R2, T1), (R2, T2)
  const float Rz[9] = {0.0f, -1.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const float RzT[9] = {0.0f, 1.0f, 0.0f, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const float sigma[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float Rc[2][9], Tc[2][3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float t1[9], t2[9], t3[9];
    matmul3(U, k == 0 ? RzT : Rz, t1);
    matmul3(t1, Vt, Rc[k]);
    matmul3(U, k == 0 ? Rz : RzT, t1);
    matmul3(t1, sigma, t2);
    matmul3(t2, Ut, t3);
    Tc[k][0] = -t3[5];
    Tc[k][1] = t3[2];
    Tc[k][2] = -t3[1];
  }

  // each group of 8 lanes triangulates one candidate (geometry.triangulate_depths,
  // small_linalg.arrow_smallest_eigvec), a lane the points sub, sub + 8, ...
  const int g = lane >> 3, sub8 = lane & 7;
  float R[9], T[3];   // selected element by element, so the arrays stay in registers
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = (g >> 1) ? Rc[1][k] : Rc[0][k];
#pragma unroll
  for (int k = 0; k < 3; ++k) T[k] = (g & 1) ? Tc[1][k] : Tc[0][k];
  float dg[kPointsPerLane], cr[kPointsPerLane], c2[kPointsPerLane];
  float part_corner = 0.0f, dmin = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < kPointsPerLane; ++k) {
    const int i = sub8 + 8 * k;
    dg[k] = cr[k] = c2[k] = 0.0f;
    if (i >= s) continue;
    const float x[3] = {sm.xl[0][i], sm.xl[1][i], sm.xl[2][i]};
    const float y[3] = {sm.xr[0][i], sm.xr[1][i], sm.xr[2][i]};
    float Rx[3], S[9], ci[3], cT[3];
    matvec3(R, x, Rx);
    skew(y, S);
    matvec3(S, Rx, ci);
    matvec3(S, T, cT);
    dg[k] = add(add(mul(ci[0], ci[0]), mul(ci[1], ci[1])), mul(ci[2], ci[2]));
    cr[k] = add(add(mul(ci[0], cT[0]), mul(ci[1], cT[1])), mul(ci[2], cT[2]));
    c2[k] = mul(cr[k], cr[k]);
    const float ct = add(add(mul(cT[0], cT[0]), mul(cT[1], cT[1])), mul(cT[2], cT[2]));
    part_corner = k == 0 ? ct : add(part_corner, ct);
    dmin = nan_min(dmin, dg[k]);
  }
  const float corner = group_sum(part_corner);
  dmin = group_min(dmin);
  auto f = [&](float lam) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kPointsPerLane; ++k)
      if (sub8 + 8 * k < s) {
        const float term = dvd(c2[k], guard(sub(dg[k], lam)));
        acc = k == 0 ? term : add(acc, term);
      }
    return sub(sub(corner, lam), group_sum(acc));
  };
  const float eps = mul(1e-7f, nan_max(dmin, 1e-30f));
  float lo = 0.0f, hi = nan_max(sub(dmin, eps), 0.0f);
  for (int it = 0; it < 30; ++it) {
    const float mid = mul(0.5f, add(lo, hi));
    const bool right = f(mid) > 0.0f;
    lo = right ? mid : lo;
    hi = right ? hi : mid;
  }
  float lam = mul(0.5f, add(lo, hi));
  for (int it = 0; it < 3; ++it) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kPointsPerLane; ++k)
      if (sub8 + 8 * k < s) {
        float den = sub(dg[k], lam);
        den = fabsf(den) < 1e-30f ? 1e-30f : den;
        const float term = dvd(c2[k], mul(den, den));
        acc = k == 0 ? term : add(acc, term);
      }
    const float fp = sub(-1.0f, group_sum(acc));
    lam = nan_min(nan_max(sub(lam, dvd(f(lam), fp)), lo), hi);
  }
  // depths -> cheirality and the right pixel errors, this group's candidate
  int ok = 1, below = 1;
  float part_err = 0.0f;
#pragma unroll
  for (int k = 0; k < kPointsPerLane; ++k) {
    const int i = sub8 + 8 * k;
    if (i >= s) continue;
    const float depth = dvd(-cr[k], guard(sub(dg[k], lam)));
    const float pl[3] = {mul(sm.xl[0][i], depth), mul(sm.xl[1][i], depth),
                         mul(sm.xl[2][i], depth)};
    float pr[3];
    matvec3(R, pl, pr);
#pragma unroll
    for (int r = 0; r < 3; ++r) pr[r] = add(pr[r], T[r]);
    ok &= pl[2] >= 0.0f && pr[2] >= 0.0f;
    float q[3];
    matvec3(Kr, pr, q);
    const float d0 = sub(dvd(q[0], pr[2]), sm.obs[0][i]);
    const float d1 = sub(dvd(q[1], pr[2]), sm.obs[1][i]);
    const float err = sqrt_rn(add(mul(d0, d0), mul(d1, d1)));
    below &= err < threshold;
    part_err = k == 0 ? err : add(part_err, err);
  }
  ok = group_and(ok);
  below = group_and(below);
  const float err_sum = group_sum(part_err);

  // the first candidate with every depth >= 0 (candidate 0 where none has)
  int first = 0;
  bool any = false;
#pragma unroll
  for (int c = 3; c >= 0; --c) {
    const int okc = __shfl_sync(kFull, ok, 8 * c);
    first = okc ? c : first;
    any = any || okc;
  }
  Solve out;
  out.valid = any;
  out.err_sum = __shfl_sync(kFull, err_sum, 8 * first);
  out.all_below = __shfl_sync(kFull, below, 8 * first) != 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) out.R[k] = (first >> 1) ? Rc[1][k] : Rc[0][k];
#pragma unroll
  for (int k = 0; k < 3; ++k) out.T[k] = (first & 1) ? Tc[1][k] : Tc[0][k];
  float S[9];
  skew(out.T, S);
  matmul3(S, out.R, out.E);
  return out;
}

// the points idx (lane r < count holds the r-th) into sm, normalised by
// K; ends synchronised
__device__ __forceinline__ void load_points(WarpSmem& sm, const float* ml, const float* mr,
                                            int N, const float* Kl, const float* Kr, int idx,
                                            int count, int lane) {
  if (lane < count) {
    float x[3], y[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      x[r] = ml[r * N + idx];
      y[r] = mr[r * N + idx];
    }
    float nx[3], ny[3];
    normalize(Kl, x[0], x[1], x[2], nx);
    normalize(Kr, y[0], y[1], y[2], ny);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      sm.xl[r][lane] = nx[r];
      sm.xr[r][lane] = ny[r];
    }
    sm.obs[0][lane] = y[0];
    sm.obs[1][lane] = y[1];
  }
  __syncwarp();
}

// F's inliers (d2 < threshold^2) among the first n_valid matches, and its
// match_fit (the mean over them of min(d2, threshold^2)); `keys`, where
// given, takes each match's sort key (d2 within n_valid, else +inf)
__device__ __forceinline__ void score(const float* F, const float* ml, const float* mr, int N,
                                      long long n_valid, float threshold_sq, int lane,
                                      int& inliers, float& fit, unsigned* keys) {
  int count = 0;
  float part = 0.0f;
  bool first = true;
#pragma unroll 4
  for (int j = lane; j < N; j += 32) {
    const float x[3] = {ml[j], ml[N + j], ml[2 * N + j]};
    const float y[3] = {mr[j], mr[N + j], mr[2 * N + j]};
    const float d2 = sampson_sq(F, x, y);
    if (keys) keys[j] = order_key(j < n_valid ? d2 : __int_as_float(0x7f800000));
    if (j < n_valid) {
      count += d2 < threshold_sq;
      const float capped = nan_min(d2, threshold_sq);
      part = first ? capped : add(part, capped);
      first = false;
    }
  }
  inliers = warp_sum_int(count);
  const float total = warp_sum(part);
  fit = dvd(total, static_cast<float>(n_valid > 1 ? n_valid : 1));
}

__device__ __forceinline__ void load3x3(const float* src, float* dst) {
#pragma unroll
  for (int k = 0; k < 9; ++k) dst[k] = src[k];
}

// Launch 1: warp w of block b solves hypothesis b * kWarps + w of the B x K.
__global__ void __launch_bounds__(32 * kWarps) hypotheses_kernel(const Params P) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int h = blockIdx.x * kWarps + w;
  if (h >= P.B * P.K) return;
  const int b = h / P.K;
  WarpSmem& sm = smem[w];
  const float* ml = P.ml + static_cast<size_t>(b) * 3 * P.N;
  const float* mr = P.mr + static_cast<size_t>(b) * 3 * P.N;
  const float* u = P.u + static_cast<size_t>(h) * P.N;
  const long long nv = P.n_valid[b];
  float Kl[9], Kr[9], Klinv[9], Krinv[9];
  load3x3(P.Kl + 9 * b, Kl);
  load3x3(P.Kr + 9 * b, Kr);
  inv3(Kl, Klinv);
  inv3(Kr, Krinv);

  // the sample: the s smallest uniforms among the first n_valid (inf past them)
  const int idx = select_smallest(
      P.N, P.s,
      [&](int j) { return order_key(j < nv ? u[j] : __int_as_float(0x7f800000)); }, lane);
  load_points(sm, ml, mr, P.N, Kl, Kr, idx, P.s, lane);
  const Solve sol = eight_point(sm, P.s, Kr, P.threshold, lane);
  float F[9];
  fundamental(sol.E, Klinv, Krinv, F);
  int inliers;
  float fit;
  score(F, ml, mr, P.N, nv, P.threshold_sq, lane, inliers, fit, nullptr);

  float* hf = P.hyp_f + static_cast<size_t>(h) * kHypFloats;
  int* hi = P.hyp_i + static_cast<size_t>(h) * (kHypInts + P.s);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) hf[k] = sol.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) hf[9 + k] = sol.T[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) hf[12 + k] = sol.E[k];
    hf[21] = dvd(sol.err_sum, static_cast<float>(P.s));
    hf[22] = fit;
    hi[0] = sol.valid ? inliers : -1;
    hi[1] = sol.valid;
    hi[2] = sol.all_below;
  }
  if (lane < P.s) hi[kHypInts + lane] = idx;
}

// [[R, T], [0, 0, 0, 1]]
__device__ __forceinline__ void write_pose(const float* R, const float* T, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r * 4 + c] = R[r * 3 + c];
    out[r * 4 + 3] = T[r];
  }
  out[12] = out[13] = out[14] = 0.0f;
  out[15] = 1.0f;
}

// argmax / argmin as torch has them: NaN wins, ties to the lower index
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib, bool largest) {
  if (is_nan(a) || is_nan(b)) return is_nan(a) && (!is_nan(b) || ia < ib);
  if (a == b) return ia < ib;
  return largest ? a > b : a < b;
}

__device__ __forceinline__ int warp_arg(float v, int i, bool largest) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    const int iw = __shfl_xor_sync(kFull, i, o);
    if (beats(w, iw, v, i, largest)) {
      v = w;
      i = iw;
    }
  }
  return i;
}

// Launch 2: one warp per pair.
__global__ void __launch_bounds__(32) refine_kernel(const Params P) {
  __shared__ WarpSmem sm;
  __shared__ unsigned shared_keys[kSharedKeys];
  const int lane = threadIdx.x, b = blockIdx.x;
  unsigned* keys = P.N <= kSharedKeys ? shared_keys : P.keys + static_cast<size_t>(b) * P.N;
  const float* ml = P.ml + static_cast<size_t>(b) * 3 * P.N;
  const float* mr = P.mr + static_cast<size_t>(b) * 3 * P.N;
  const float* hf = P.hyp_f + static_cast<size_t>(b) * P.K * kHypFloats;
  const int* hi = P.hyp_i + static_cast<size_t>(b) * P.K * (kHypInts + P.s);
  const long long nv = P.n_valid[b];
  float Kl[9], Kr[9], Klinv[9], Krinv[9];
  load3x3(P.Kl + 9 * b, Kl);
  load3x3(P.Kr + 9 * b, Kr);
  inv3(Kl, Klinv);
  inv3(Kr, Krinv);

  // the winner: argmax(float32(inliers) - 1e-6 * mean error); the most
  // inliers; whether any hypothesis is valid
  float best = 0.0f;
  int best_k = -1, most = -2147483647 - 1, any = 0;
  for (int k = lane; k < P.K; k += 32) {
    const int inl = hi[k * (kHypInts + P.s)];
    const float sc = sub(static_cast<float>(inl), mul(1e-6f, hf[k * kHypFloats + 21]));
    if (best_k < 0 || beats(sc, k, best, best_k, true)) {
      best = sc;
      best_k = k;
    }
    most = inl > most ? inl : most;
    any |= hi[k * (kHypInts + P.s) + 1];
  }
  if (best_k < 0) best = __int_as_float(0xff800000);   // a lane with no hypothesis
  const int win = warp_arg(best, best_k < 0 ? 2147483647 : best_k, true);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int m = __shfl_xor_sync(kFull, most, o);
    most = m > most ? m : most;
    any |= __shfl_xor_sync(kFull, any, o);
  }
  // the best fitting of the most-inlier hypotheses: argmin of match_fit
  // where inliers == most, else +inf
  float fbest = __int_as_float(0x7f800000);
  int fit_k = 2147483647;
  for (int k = lane; k < P.K; k += 32) {
    const float fv = hi[k * (kHypInts + P.s)] == most ? hf[k * kHypFloats + 22]
                                                      : __int_as_float(0x7f800000);
    if (fit_k == 2147483647 || beats(fv, k, fbest, fit_k, false)) {
      fbest = fv;
      fit_k = k;
    }
  }
  const int fit = warp_arg(fbest, fit_k, false);
  if (lane == 0) {
    P.picked[2 * b] = win;
    P.picked[2 * b + 1] = fit;
  }

  // the current model: the winner, its sample cut or padded with 0 to `support`
  const float* wf = hf + win * kHypFloats;
  const int* wi = hi + win * (kHypInts + P.s);
  float R[9], T[3], E[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = wf[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) T[k] = wf[9 + k];
#pragma unroll
  for (int k = 0; k < 9; ++k) E[k] = wf[12 + k];
  int inliers = wi[0];
  float mean = wf[21];
  bool success = wi[2] && wi[1];
  int sample = lane < P.s && lane < P.support ? wi[kHypInts + lane] : 0;

  for (int round = 0; round < P.rounds; ++round) {
    float F[9];
    fundamental(E, Klinv, Krinv, F);
    int unused_i;
    float unused_f;
    score(F, ml, mr, P.N, nv, P.threshold_sq, lane, unused_i, unused_f, keys);
    __syncwarp();
    const int top = select_smallest(P.N, P.support, [&](int j) { return keys[j]; }, lane);
    __syncwarp();
    load_points(sm, ml, mr, P.N, Kl, Kr, top, P.support, lane);
    const Solve sol = eight_point(sm, P.support, Kr, P.threshold, lane);
    float Fn[9];
    fundamental(sol.E, Klinv, Krinv, Fn);
    int refit_inl;
    float unused;
    score(Fn, ml, mr, P.N, nv, P.threshold_sq, lane, refit_inl, unused, nullptr);
    refit_inl = sol.valid ? refit_inl : -1;
    if (refit_inl >= inliers) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = sol.R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) T[k] = sol.T[k];
#pragma unroll
      for (int k = 0; k < 9; ++k) E[k] = sol.E[k];
      inliers = refit_inl;
      mean = dvd(sol.err_sum, static_cast<float>(P.support));
      success = sol.all_below && sol.valid;
      sample = top;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) P.rotation[9 * b + k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) P.translation[3 * b + k] = T[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) P.essential[9 * b + k] = E[k];
    write_pose(R, T, P.pose + 16 * b);
    P.inlier_count[b] = inliers;
    P.mean_error[b] = mean;
    P.success[b] = success;
    P.valid[b] = any != 0;
    const float* ff = hf + fit * kHypFloats;
    write_pose(ff, ff + 9, P.fit_pose + 16 * b);
    P.fit_error[b] = ff[22];
  }
  if (lane < P.support) P.sample_indices[static_cast<size_t>(b) * P.support + lane] = sample;
}

}  // namespace ransac
}  // namespace stpu
