// The pose layer's two-view bundle adjustment, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's BA, stereo_reconstruction_tpu/
// pose/ba.py, is plain jnp that XLA fuses. The port's plain twin,
// pose/ba.py::bundle_adjust_plain, is ~1,080 small PyTorch ops a
// Levenberg-Marquardt step (jacfwd under vmap, the per-point 3x3 inverses,
// the einsums), ~21,800 a solve of 20 steps; even replayed from a CUDA graph
// the card then waits on the gaps between its sub-microsecond nodes. This
// kernel is the whole solve, every problem of a batch in one launch:
//
//   one CTA a problem (a start of a pair: its observations, intrinsics and
//   weights, its own R, T and points), one thread a point, the points
//   padded with idle threads to a power of two of warps. A thread keeps its
//   point's observations, X, residuals and Jacobian blocks in registers for
//   the whole solve; nothing is read from or written to global memory
//   between the start and the results.
//
// A step (pose/ba.py, in its order):
//   1. each thread: the point's Huber or L2 weight from its residuals, then
//      its terms of B (21 entries of the lower triangle), of v (6), C and
//      (C + lambda I)^-1, E, E C^-1 and its terms of the Schur product's
//      lower triangle (21) and right-hand side (6): 54 numbers a point,
//      written to a row of shared memory;
//   2. the threads sum a column each over the points (two where one warp
//      holds them), in the tree order below;
//   3. every thread reads the 54 sums, forms S and its right-hand side and
//      solves the 6x6 system by the unrolled Cholesky, the same numbers in
//      every thread (so no broadcast and no barrier), then its point's step;
//   4. every thread: R and its derivatives at the new pose, its point's
//      residuals and Jacobians there (the next step's, if accepted), and
//      its term of the new cost, summed over the CTA by warp shuffles and
//      one shared-memory step; every thread applies the accept rule.
//
// What binds: the chain of one step, not bytes (~2 KB a problem) nor
// operations (~150 kFLOP a step a problem). Three barriers a step; the
// Cholesky and both substitutions are ~40 dependent divisions, square
// roots and sums, all correctly rounded.
//
// The arithmetic is the twin's, each float32 operation rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no contraction
// into FMAs), with its constants and guards. The Jacobians are jacfwd's:
// the forward-mode rules of PyTorch written out (a quotient's tangent
// (a' - b' q) / b, a product's a' b + a b', a sum's in its order, tangents
// that PyTorch never forms left out, zeros where it materialises them).
// sin, cos and acos are taken in float64 and rounded once, and so is the
// angle's derivative through the square root, as the pinned twin takes
// them (tests/ba_twin.py). Sums over the points run in one tree order: each
// warp's 32 by halving (lane i + lane i + 16, ...), then the warps' totals
// by halving; sums over a residual or coordinate index run in order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stpu {
namespace ba {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;
constexpr int kMaxPoints = 32 * kMaxWarps;   // num_points at most: a point a thread
constexpr int kTerms = 54;                    // B (21), v (6), the Schur product (21), its rhs (6)
constexpr int kStride = kTerms + 1;           // a point's row of shared memory, odd

struct Params {
  const float* kl;        // (B, 3, N) homogeneous pixels, left
  const float* kr;        // (B, 3, N)
  const float* Kl;        // (B, 3, 3)
  const float* Kr;        // (B, 3, 3)
  const float* w;         // (B, N) weights (0: a padded point)
  const float* R0;        // (B * S, 3, 3) starts
  const float* T0;        // (B * S, 3)
  const float* X0;        // (B * S, 3, N)
  float* rotation;        // (B * S, 3, 3)
  float* translation;     // (B * S, 3)
  float* pose;            // (B * S, 4, 4)
  float* points;          // (B * S, 3, N)
  float* initial_cost;    // (B * S,)
  float* final_cost;      // (B * S,)
  float* fundamental;     // (B * S, 3, 3)
  uint8_t* converged;     // (B * S,) bool
  int B, S, N, iterations, window, huber;
  float huber_delta, init_lambda, lambda_up, lambda_down, min_lambda, max_lambda, settle_rtol;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
// torch.clamp's bounds: NaN stays NaN
__device__ __forceinline__ float clamp_min(float a, float lo) { return a < lo ? lo : a; }
__device__ __forceinline__ float clamp_max(float a, float hi) { return a > hi ? hi : a; }

// float32 x through a float64 function, rounded once (the pinned twin's)
__device__ __forceinline__ float through64(double x) { return static_cast<float>(x); }

// (a @ b) of row-major 3x3 matrices, summed in order
__device__ __forceinline__ void matmul3(const float* a, const float* b, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[r * 3 + c] = add(add(mul(a[r * 3], b[c]), mul(a[r * 3 + 1], b[3 + c])),
                           mul(a[r * 3 + 2], b[6 + c]));
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

// R of an angle-axis (ops/geometry.py::angle_axis_to_rotation) and, for
// k < 3, its tangent Rt[k] along angle-axis component k, as jacfwd forms it
struct Rotation {
  float R[9];
  float Rt[3][9];
};

__device__ __forceinline__ void rodrigues(const float* aa, Rotation& out) {
  const float theta2 = add(add(mul(aa[0], aa[0]), mul(aa[1], aa[1])), mul(aa[2], aa[2]));
  if (theta2 < 1e-12f) {
    // eye + skew(aa), whose tangent is skew(e_k)
    float Sa[9];
    skew(aa, Sa);
#pragma unroll
    for (int e = 0; e < 9; ++e) out.R[e] = add((e % 4 == 0) ? 1.0f : 0.0f, Sa[e]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float e[3] = {0.0f, 0.0f, 0.0f};
      e[k] = 1.0f;
      skew(e, out.Rt[k]);
    }
    return;
  }
  const double root = sqrt(static_cast<double>(clamp_min(theta2, 1e-24f)));
  const float theta = through64(root);
  const float thc = clamp_min(theta, 1e-12f);
  const float u[3] = {dvd(aa[0], thc), dvd(aa[1], thc), dvd(aa[2], thc)};
  float K[9], KK[9];
  skew(u, K);
  matmul3(K, K, KK);
  const double sd = sin(static_cast<double>(theta)), cd = cos(static_cast<double>(theta));
  const float s = through64(sd), c = through64(cd);
  const float omc = sub(1.0f, c);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    out.R[e] = add(add(eye, mul(s, K[e])), mul(omc, KK[e]));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // theta' = (2 aa_k) / (2 sqrt(theta2)), in float64 as the pinned sqrt
    const float th_t = through64(static_cast<double>(aa[k]) / root);
    float ut[3], Kt[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) ut[j] = dvd(sub(j == k ? 1.0f : 0.0f, mul(th_t, u[j])), thc);
    skew(ut, Kt);
    const float s_t = through64(static_cast<double>(th_t) * cd);
    const float omc_t = -through64(static_cast<double>(th_t) * -sd);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        // (K @ K)' summed in order, each term a' b + a b'
        float kk_t = add(mul(Kt[r * 3], K[l]), mul(K[r * 3], Kt[l]));
        kk_t = add(kk_t, add(mul(Kt[r * 3 + 1], K[3 + l]), mul(K[r * 3 + 1], Kt[3 + l])));
        kk_t = add(kk_t, add(mul(Kt[r * 3 + 2], K[6 + l]), mul(K[r * 3 + 2], Kt[6 + l])));
        const int e = r * 3 + l;
        out.Rt[k][e] = add(add(mul(s_t, K[e]), mul(s, Kt[e])),
                           add(mul(omc_t, KK[e]), mul(omc, kk_t)));
      }
  }
}

// R -> angle-axis (ops/geometry.py::rotation_to_angle_axis)
__device__ __forceinline__ void angle_axis(const float* R, float* aa) {
  const float trace = add(add(R[0], R[4]), R[8]);
  const float x = clamp_max(clamp_min(dvd(sub(trace, 1.0f), 2.0f), -1.0f), 1.0f);
  const float theta = through64(acos(static_cast<double>(x)));
  const float s = fabsf(through64(sin(static_cast<double>(theta))));
  const float scale = s > 1e-6f ? dvd(theta, mul(2.0f, clamp_min(s, 1e-12f))) : 0.5f;
  aa[0] = mul(sub(R[7], R[5]), scale);
  aa[1] = mul(sub(R[2], R[6]), scale);
  aa[2] = mul(sub(R[3], R[1]), scale);
}

// One point's residuals [left x, left y, right x, right y] (observed -
// projected) and Jacobians: Jp rows 2 and 3 (rows 0 and 1 are zero) over
// the pose, Jx over the point (pose/ba.py::_residuals_one under jacfwd)
struct PointEval {
  float r[4];
  float Jp[2][6];
  float Jx[4][3];
};

__device__ __forceinline__ void eval_point(const Rotation& rot, const float* t, const float* X,
                                           const float* Kl, const float* Kr, const float* obs,
                                           PointEval& out) {
  float pl[3], P[3], q[3], plp[2], pr[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pl[i] = add(add(mul(Kl[i * 3], X[0]), mul(Kl[i * 3 + 1], X[1])), mul(Kl[i * 3 + 2], X[2]));
    P[i] = add(add(add(mul(rot.R[i * 3], X[0]), mul(rot.R[i * 3 + 1], X[1])),
                   mul(rot.R[i * 3 + 2], X[2])), t[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q[i] = add(add(mul(Kr[i * 3], P[0]), mul(Kr[i * 3 + 1], P[1])), mul(Kr[i * 3 + 2], P[2]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    plp[i] = dvd(pl[i], pl[2]);
    pr[i] = dvd(q[i], q[2]);
  }
  out.r[0] = sub(obs[0], plp[0]);
  out.r[1] = sub(obs[1], plp[1]);
  out.r[2] = sub(obs[2], pr[0]);
  out.r[3] = sub(obs[3], pr[1]);
  // over the pose: P' = R' X (+ 0) for the angle-axis, e_k for T
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float Pt[3], qt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (k < 3) {
        const float* Rt = rot.Rt[k < 3 ? k : 0];
        Pt[i] = add(add(add(mul(Rt[i * 3], X[0]), mul(Rt[i * 3 + 1], X[1])),
                        mul(Rt[i * 3 + 2], X[2])), 0.0f);
      } else {
        Pt[i] = (i == k - 3) ? 1.0f : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      qt[i] = add(add(mul(Kr[i * 3], Pt[0]), mul(Kr[i * 3 + 1], Pt[1])), mul(Kr[i * 3 + 2], Pt[2]));
#pragma unroll
    for (int i = 0; i < 2; ++i) out.Jp[i][k] = -dvd(sub(qt[i], mul(qt[2], pr[i])), q[2]);
  }
  // over the point: pl' = Kl e_k, P' = R e_k
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      out.Jx[i][k] = -dvd(sub(Kl[i * 3 + k], mul(Kl[6 + k], plp[i])), pl[2]);
    float qt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      qt[i] = add(add(mul(Kr[i * 3], rot.R[k]), mul(Kr[i * 3 + 1], rot.R[3 + k])),
                  mul(Kr[i * 3 + 2], rot.R[6 + k]));
#pragma unroll
    for (int i = 0; i < 2; ++i) out.Jx[2 + i][k] = -dvd(sub(qt[i], mul(qt[2], pr[i])), q[2]);
  }
}

// The point's weighted squared residuals, summed in order
__device__ __forceinline__ float point_cost(const float* r, float w) {
  float c = mul(mul(r[0], r[0]), w);
#pragma unroll
  for (int i = 1; i < 4; ++i) c = add(c, mul(mul(r[i], r[i]), w));
  return c;
}

// The sum of x halved in place: x[i] + x[i + h] for h = n / 2, ... 1
template <int n>
__device__ __forceinline__ float halving(float* x) {
#pragma unroll
  for (int h = n / 2; h >= 1; h /= 2)
#pragma unroll
    for (int i = 0; i < h; ++i) x[i] = add(x[i], x[i + h]);
  return x[0];
}

// The warps' totals by halving, read from shared memory
__device__ __forceinline__ float warps_total(const float* totals, int warps) {
  float x[kMaxWarps];
#pragma unroll
  for (int i = 0; i < kMaxWarps; ++i) x[i] = i < warps ? totals[i] : 0.0f;
  if (warps == 1) return x[0];
  if (warps == 2) return add(x[0], x[1]);
  return halving<kMaxWarps>(x);
}

// v summed over the CTA's threads in the tree order: each warp's by a
// butterfly of shuffles (lane i + lane i + 16, ...), then the warps'
// totals by halving; every thread gets the sum
__device__ __forceinline__ float block_sum(float v, float* scratch, int warps) {
#pragma unroll
  for (int h = 16; h >= 1; h /= 2) v = add(v, __shfl_xor_sync(kFull, v, h));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warps_total(scratch, warps);
}

__global__ void __launch_bounds__(kMaxPoints) ba_kernel(const Params P) {
  __shared__ float stage[kMaxPoints * kStride];
  __shared__ float sums[kTerms];
  __shared__ float warp_cost[kMaxWarps];

  const int prob = blockIdx.x;
  const int pair = prob / P.S;
  const int n = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int N = P.N;
  const bool live = n < N;

  float Kl[9], Kr[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    Kl[e] = P.Kl[pair * 9 + e];
    Kr[e] = P.Kr[pair * 9 + e];
  }
  float obs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, X[3] = {0.0f, 0.0f, 1.0f}, w = 0.0f;
  if (live) {
    const float* kl = P.kl + static_cast<size_t>(pair) * 3 * N;
    const float* kr = P.kr + static_cast<size_t>(pair) * 3 * N;
    const float* X0 = P.X0 + static_cast<size_t>(prob) * 3 * N;
    obs[0] = kl[n];
    obs[1] = kl[N + n];
    obs[2] = kr[n];
    obs[3] = kr[N + n];
#pragma unroll
    for (int i = 0; i < 3; ++i) X[i] = X0[i * N + n];
    w = P.w[static_cast<size_t>(pair) * N + n];
  }
  float pose6[6];
  {
    float R0[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) R0[e] = P.R0[prob * 9 + e];
    angle_axis(R0, pose6);
#pragma unroll
    for (int i = 0; i < 3; ++i) pose6[3 + i] = P.T0[prob * 3 + i];
  }

  Rotation rot;
  rodrigues(pose6, rot);
  float R[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = rot.R[e];
  PointEval cur;
  eval_point(rot, pose6 + 3, X, Kl, Kr, obs, cur);
  const float c0 = block_sum(live ? point_cost(cur.r, w) : 0.0f, warp_cost, warps);
  float cost = c0, before = c0;
  float lam = P.init_lambda;

  for (int it = 0; it < P.iterations; ++it) {
    // 1. the point's terms
    float terms[kTerms];
    float E[6][3], Ci[9], g[3];
    {
      float rw = w;
      if (P.huber) {
        float ss = mul(cur.r[0], cur.r[0]);
#pragma unroll
        for (int i = 1; i < 4; ++i) ss = add(ss, mul(cur.r[i], cur.r[i]));
        const float err = sqrt_rn(add(ss, 1e-12f));
        rw = mul(w, sqrt_rn(clamp_max(dvd(P.huber_delta, err), 1.0f)));
      }
      float r[4], jp[4][6], jx[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = mul(cur.r[i], rw);
      const float zero = mul(0.0f, rw);     // jacfwd's zero rows, weighted
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        jp[0][k] = zero;
        jp[1][k] = zero;
        jp[2][k] = mul(cur.Jp[0][k], rw);
        jp[3][k] = mul(cur.Jp[1][k], rw);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) jx[i][k] = mul(cur.Jx[i][k], rw);
      // sums over the residual index, in order
      auto rsum = [&](auto f) {
        float acc = f(0);
#pragma unroll
        for (int i = 1; i < 4; ++i) acc = add(acc, f(i));
        return acc;
      };
      int t = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) terms[t++] = rsum([&](int q) { return mul(jp[q][i], jp[q][j]); });
#pragma unroll
      for (int i = 0; i < 6; ++i) terms[t++] = rsum([&](int q) { return mul(jp[q][i], r[q]); });
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) E[i][j] = rsum([&](int q) { return mul(jp[q][i], jx[q][j]); });
      float C[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          C[i * 3 + j] = add(rsum([&](int q) { return mul(jx[q][i], jx[q][j]); }),
                             i == j ? lam : 0.0f);
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = -rsum([&](int q) { return mul(jx[q][i], r[q]); });
      inv3(C, Ci);
      float EC[6][3];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          EC[i][j] = add(add(mul(E[i][0], Ci[j]), mul(E[i][1], Ci[3 + j])), mul(E[i][2], Ci[6 + j]));
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int k = 0; k <= i; ++k)
          terms[t++] = add(add(mul(EC[i][0], E[k][0]), mul(EC[i][1], E[k][1])),
                           mul(EC[i][2], E[k][2]));
#pragma unroll
      for (int i = 0; i < 6; ++i)
        terms[t++] = add(add(mul(EC[i][0], g[0]), mul(EC[i][1], g[1])), mul(EC[i][2], g[2]));
    }
    float* row = stage + n * kStride;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) row[k] = live ? terms[k] : 0.0f;
    __syncthreads();
    // 2. a column each over the points (two each where one warp holds them)
    for (int col = n; col < kTerms; col += blockDim.x) {
      float totals[kMaxWarps];
#pragma unroll
      for (int wp = 0; wp < kMaxWarps; ++wp) {
        totals[wp] = 0.0f;
        if (wp < warps) {
          float x[32];
#pragma unroll
          for (int l = 0; l < 32; ++l) x[l] = stage[(wp * 32 + l) * kStride + col];
          totals[wp] = halving<32>(x);
        }
      }
      sums[col] = warps == 1 ? totals[0] : warps == 2 ? add(totals[0], totals[1])
                                                      : halving<kMaxWarps>(totals);
    }
    __syncthreads();
    // 3. S d = rhs by the unrolled Cholesky (ops/small_linalg.py::solve_spd_small)
    float L[6][6], d[6];
    {
      float S[6][6], rhs[6];
      int t = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) S[i][j] = add(sums[t++], i == j ? lam : 0.0f);
#pragma unroll
      for (int i = 0; i < 6; ++i) rhs[i] = -sums[t++];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) S[i][j] = sub(S[i][j], sums[t++]);
#pragma unroll
      for (int i = 0; i < 6; ++i) rhs[i] = sub(rhs[i], sums[t++]);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float s = S[j][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = sub(s, mul(L[j][k], L[j][k]));
        L[j][j] = sqrt_rn(clamp_min(s, 1e-30f));
#pragma unroll
        for (int i = j + 1; i < 6; ++i) {
          float s2 = S[i][j];
#pragma unroll
          for (int k = 0; k < j; ++k) s2 = sub(s2, mul(L[i][k], L[j][k]));
          L[i][j] = dvd(s2, L[j][j]);
        }
      }
      float y[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float s = rhs[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = sub(s, mul(L[i][k], y[k]));
        y[i] = dvd(s, L[i][i]);
      }
#pragma unroll
      for (int i = 5; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < 6; ++k) s = sub(s, mul(L[k][i], d[k]));
        d[i] = dvd(s, L[i][i]);
      }
    }
    // the point's step: C^-1 (g - E^T d)
    float newX[3], newpose[6];
    {
      float gq[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float q = mul(E[0][i], d[0]);
#pragma unroll
        for (int j = 1; j < 6; ++j) q = add(q, mul(E[j][i], d[j]));
        gq[i] = sub(g[i], q);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        newX[i] = add(X[i], add(add(mul(Ci[i * 3], gq[0]), mul(Ci[i * 3 + 1], gq[1])),
                                mul(Ci[i * 3 + 2], gq[2])));
#pragma unroll
      for (int i = 0; i < 6; ++i) newpose[i] = add(pose6[i], d[i]);
    }
    // 4. the new pose's rotation, residuals and cost; the accept rule
    rodrigues(newpose, rot);
    PointEval cand;
    eval_point(rot, newpose + 3, newX, Kl, Kr, obs, cand);
    const float new_cost = block_sum(live ? point_cost(cand.r, w) : 0.0f, warp_cost, warps);
    if (new_cost < cost) {
#pragma unroll
      for (int i = 0; i < 6; ++i) pose6[i] = newpose[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) X[i] = newX[i];
#pragma unroll
      for (int e = 0; e < 9; ++e) R[e] = rot.R[e];
      cur = cand;
      cost = new_cost;
      lam = clamp_min(mul(lam, P.lambda_down), P.min_lambda);
    } else {
      lam = clamp_max(mul(lam, P.lambda_up), P.max_lambda);
    }
    if (it + 1 == P.iterations - P.window) before = cost;
  }

  if (live) {
    float* out = P.points + static_cast<size_t>(prob) * 3 * N;
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i * N + n] = X[i];
  }
  if (n == 0) {
    const float* T = pose6 + 3;
    float Sk[9], E[9], Kli[9], Kri[9], KriT[9], tmp[9], F[9];
    skew(T, Sk);
    matmul3(Sk, R, E);
    inv3(Kl, Kli);
    inv3(Kr, Kri);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) KriT[r * 3 + c] = Kri[c * 3 + r];
    matmul3(KriT, E, tmp);
    matmul3(tmp, Kli, F);
    float ss = mul(F[0], F[0]);
#pragma unroll
    for (int k = 1; k < 9; ++k) ss = add(ss, mul(F[k], F[k]));
    const float norm = sqrt_rn(ss);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      P.fundamental[prob * 9 + k] = dvd(F[k], norm);
      P.rotation[prob * 9 + k] = R[k];
    }
    float* pose = P.pose + prob * 16;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) pose[r * 4 + c] = R[r * 3 + c];
      pose[r * 4 + 3] = T[r];
      P.translation[prob * 3 + r] = T[r];
    }
    pose[12] = pose[13] = pose[14] = 0.0f;
    pose[15] = 1.0f;
    P.initial_cost[prob] = c0;
    P.final_cost[prob] = cost;
    P.converged[prob] = sub(before, cost) <= mul(P.settle_rtol, before);
  }
}

}  // namespace ba
}  // namespace stpu
