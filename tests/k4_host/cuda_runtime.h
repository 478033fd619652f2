// Host stand-in for the CUDA runtime, enough to build csrc/perceptual_scan.cu
// with a C++20 compiler (tests/test_torch_perceptual_scan_host.py): K1b's
// stand-in (one std::thread per CUDA thread, a warp's lanes meeting at each
// warp-wide operation) with what K4 adds, a CTA-wide __syncthreads, warp
// reductions and a launch that runs the CTAs one after another.
#pragma once
#include "../k1b_host/cuda_runtime.h"

#include <cstdlib>

#define __host__
#define __align__(n) alignas(n)
#define __shared__ static           // one CTA runs at a time

enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }

namespace host {
inline std::unique_ptr<std::barrier<>> cta_bar;

// Runs the CTAs of a launch one after another, each with `smem_bytes` of
// dynamic shared memory filled with NaN bytes; false if a wait timed out.
template <class F> bool launch_ctas(dim3 g, dim3 b, size_t smem_bytes, cudaStream_t, F f) {
  gridDim = g;
  blockDim = b;
  failed = false;
  const unsigned n = b.x * b.y, ctas = g.x * g.y * g.z;
  smem.assign(g.x, {});
  for (unsigned c = 0; c < ctas && !failed; ++c) {
    const dim3 cta(c % g.x, c / g.x % g.y, c / (g.x * g.y));
    warps.clear();
    for (unsigned i = 0; i < (n + 31) / 32; ++i) warps.emplace_back(new Warp);
    smem[cta.x].assign(smem_bytes, (char)0xff);
    cta_bar.reset(new std::barrier<>(n));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < n; ++t)
      ts.emplace_back([=] {
        blockIdx = cta;
        threadIdx = dim3(t % b.x, t / b.x);
        my_warp = warps[t / 32].get();
        f();
      });
    for (auto& t : ts) t.join();
    smem[cta.x].clear();
  }
  return !failed;
}
}  // namespace host

inline void __syncthreads() { host::cta_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { host::my_warp->bar.arrive_and_wait(); }

// every lane of the warp writes, then reads
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int mask) {
  auto* w = host::my_warp;
  const int lane = threadIdx.x & 31;
  w->buf[lane] = v;
  w->bar.arrive_and_wait();
  const unsigned r = w->buf[lane ^ mask];
  w->bar.arrive_and_wait();
  return r;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  auto* w = host::my_warp;
  w->buf[threadIdx.x & 31] = v;
  w->bar.arrive_and_wait();
  const unsigned r = *std::min_element(w->buf, w->buf + 32);
  w->bar.arrive_and_wait();
  return r;
}
