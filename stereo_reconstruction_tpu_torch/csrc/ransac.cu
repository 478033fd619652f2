// Launcher of the pose layer's RANSAC (kernels and design notes:
// ransac.cuh), with a plain C interface for ctypes.

#include "ransac.cuh"

// The most points a sample or a refit takes (sample_size, refine_support).
extern "C" int stpu_ransac_max_points() { return stpu::ransac::kMaxPoints; }

// The most matches a pair may have with no key scratch (stpu_ransac's `keys`).
extern "C" int stpu_ransac_shared_keys() { return stpu::ransac::kSharedKeys; }

// Floats and ints a hypothesis holds in the scratch (the ints before its
// sample of sample_size indices).
extern "C" int stpu_ransac_hyp_floats() { return stpu::ransac::kHypFloats; }
extern "C" int stpu_ransac_hyp_ints() { return stpu::ransac::kHypInts; }

// The name of a cudaError_t that stpu_ransac returned.
extern "C" const char* stpu_ransac_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// RANSAC of B pairs on `stream`, in two launches; returns the first
// cudaError_t that is not 0, else 0. `ptrs` holds 21 device pointers in
// the order of stpu::ransac::Params (inputs ml, mr, Kl, Kr, n_valid, u;
// scratch hyp_f, hyp_i, picked, keys; the RansacResult fields), each
// contiguous, keys (B, N) uint32 where N > stpu_ransac_shared_keys(), else
// any;
// `dims` is B, N, K, sample_size, refine_rounds, refine_support.
extern "C" int stpu_ransac(void* const* ptrs, const int* dims, float threshold,
                           float threshold_sq, void* stream) {
  using namespace stpu::ransac;
  Params P;
  P.ml = static_cast<const float*>(ptrs[0]);
  P.mr = static_cast<const float*>(ptrs[1]);
  P.Kl = static_cast<const float*>(ptrs[2]);
  P.Kr = static_cast<const float*>(ptrs[3]);
  P.n_valid = static_cast<const long long*>(ptrs[4]);
  P.u = static_cast<const float*>(ptrs[5]);
  P.hyp_f = static_cast<float*>(ptrs[6]);
  P.hyp_i = static_cast<int*>(ptrs[7]);
  P.picked = static_cast<int*>(ptrs[8]);
  P.keys = static_cast<unsigned*>(ptrs[9]);
  P.rotation = static_cast<float*>(ptrs[10]);
  P.translation = static_cast<float*>(ptrs[11]);
  P.essential = static_cast<float*>(ptrs[12]);
  P.pose = static_cast<float*>(ptrs[13]);
  P.sample_indices = static_cast<long long*>(ptrs[14]);
  P.inlier_count = static_cast<long long*>(ptrs[15]);
  P.mean_error = static_cast<float*>(ptrs[16]);
  P.success = static_cast<uint8_t*>(ptrs[17]);
  P.valid = static_cast<uint8_t*>(ptrs[18]);
  P.fit_pose = static_cast<float*>(ptrs[19]);
  P.fit_error = static_cast<float*>(ptrs[20]);
  P.B = dims[0];
  P.N = dims[1];
  P.K = dims[2];
  P.s = dims[3];
  P.rounds = dims[4];
  P.support = dims[5];
  P.threshold = threshold;
  P.threshold_sq = threshold_sq;
  if (P.B < 1 || P.B > 65535 || P.K < 1 || P.s < 1 || P.s > kMaxPoints || P.support < 1 ||
      P.support > kMaxPoints || P.s > P.N || P.support > P.N || P.rounds < 0 ||
      (P.N > kSharedKeys && P.keys == nullptr) ||
      static_cast<long long>(P.B) * P.K > 2147483647LL - kWarps)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  hypotheses_kernel<<<(P.B * P.K + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  refine_kernel<<<P.B, 32, 0, st>>>(P);
  err = cudaGetLastError();
  return (int)err;
}
