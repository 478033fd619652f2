// Launcher of the pose layer's bundle adjustment (kernel and design notes:
// ba.cuh), with a plain C interface for ctypes.

#include "ba.cuh"

// The most points a problem may have (BundleAdjustmentConfig.num_points).
extern "C" int stpu_ba_max_points() { return stpu::ba::kMaxPoints; }

// Bundle adjustment of B pairs from S starts each, one CTA a problem, in
// one launch on `stream`; returns the first cudaError_t that is not 0,
// else 0. `ptrs` holds 16 device pointers in the order of
// stpu::ba::Params (inputs kl, kr, Kl, Kr, w, R0, T0, X0; the BAResult
// fields), each contiguous; `dims` is B, S, N, iterations, window, huber;
// `scalars` is huber_delta, init_lambda, lambda_up, lambda_down,
// min_lambda, max_lambda, settle_rtol.
extern "C" int stpu_ba(void* const* ptrs, const int* dims, const float* scalars,
                       void* stream) {
  using namespace stpu::ba;
  Params P;
  P.kl = static_cast<const float*>(ptrs[0]);
  P.kr = static_cast<const float*>(ptrs[1]);
  P.Kl = static_cast<const float*>(ptrs[2]);
  P.Kr = static_cast<const float*>(ptrs[3]);
  P.w = static_cast<const float*>(ptrs[4]);
  P.R0 = static_cast<const float*>(ptrs[5]);
  P.T0 = static_cast<const float*>(ptrs[6]);
  P.X0 = static_cast<const float*>(ptrs[7]);
  P.rotation = static_cast<float*>(ptrs[8]);
  P.translation = static_cast<float*>(ptrs[9]);
  P.pose = static_cast<float*>(ptrs[10]);
  P.points = static_cast<float*>(ptrs[11]);
  P.initial_cost = static_cast<float*>(ptrs[12]);
  P.final_cost = static_cast<float*>(ptrs[13]);
  P.fundamental = static_cast<float*>(ptrs[14]);
  P.converged = static_cast<uint8_t*>(ptrs[15]);
  P.B = dims[0];
  P.S = dims[1];
  P.N = dims[2];
  P.iterations = dims[3];
  P.window = dims[4];
  P.huber = dims[5];
  P.huber_delta = scalars[0];
  P.init_lambda = scalars[1];
  P.lambda_up = scalars[2];
  P.lambda_down = scalars[3];
  P.min_lambda = scalars[4];
  P.max_lambda = scalars[5];
  P.settle_rtol = scalars[6];
  if (P.B < 1 || P.S < 1 || P.N < 1 || P.N > kMaxPoints || P.iterations < 0 || P.window < 0 ||
      static_cast<long long>(P.B) * P.S > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  int warps = 1;
  while (32 * warps < P.N) warps *= 2;
  ba_kernel<<<P.B * P.S, 32 * warps, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
