// Host stand-in for the CUDA runtime, enough to build csrc/row_scan.cu with
// a C++20 compiler (tests/test_torch_row_scan_host.py): one std::thread per
// CUDA thread, every CTA of a launch running at once as a cluster's CTAs
// do, and a warp's lanes meeting at each shuffle.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 719 };
typedef void* cudaStream_t;
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }

inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
template <class T> T __ldg(const T* p) { return *p; }
using std::isfinite;
using std::max;
using std::min;

namespace host {
struct Warp { std::barrier<> bar{32}; unsigned buf[32]; };
inline std::vector<std::unique_ptr<Warp>> warps;
inline std::vector<std::vector<char>> smem;       // each CTA's shared memory
inline std::unique_ptr<std::barrier<>> cluster_bar;
inline std::atomic<bool> failed{false};            // a wait timed out, or a barrier over-arrived
inline thread_local Warp* my_warp;
inline char* smem_of(unsigned cta) { return smem[cta].data(); }

template <class F> void launch(dim3 g, dim3 b, F f) {
  gridDim = g;
  blockDim = b;
  warps.clear();
  for (unsigned i = 0; i < g.x * b.x / 32; ++i) warps.emplace_back(new Warp);
  smem.assign(g.x, std::vector<char>(1 << 16, 0));
  cluster_bar.reset(new std::barrier<>(g.x * b.x));
  failed = false;
  std::vector<std::thread> ts;
  for (unsigned c = 0; c < g.x; ++c)
    for (unsigned t = 0; t < b.x; ++t)
      ts.emplace_back([=] {
        blockIdx = dim3(c);
        threadIdx = dim3(t);
        my_warp = warps[(c * b.x + t) / 32].get();
        f();
      });
  for (auto& t : ts) t.join();
}
}  // namespace host

// every lane of the warp writes, then reads
inline unsigned __shfl_up_sync(unsigned, unsigned v, int off) {
  auto* w = host::my_warp;
  const int lane = threadIdx.x & 31;
  w->buf[lane] = v;
  w->bar.arrive_and_wait();
  const unsigned r = lane >= off ? w->buf[lane - off] : v;
  w->bar.arrive_and_wait();
  return r;
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  auto* w = host::my_warp;
  w->buf[threadIdx.x & 31] = v;
  w->bar.arrive_and_wait();
  const unsigned r = w->buf[src];
  w->bar.arrive_and_wait();
  return r;
}

// refuses what a one-cluster launch of K1b may not ask for: a grid other
// than the cluster, more than 8 CTAs (the portable size), more than 512
// threads a CTA or a partial warp
template <typename... Exp, typename... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(Exp...),
                               Act&&... args) {
  if (cfg->numAttrs != 1 || cfg->attrs[0].id != cudaLaunchAttributeClusterDimension ||
      cfg->attrs[0].val.clusterDim.x != cfg->gridDim.x || cfg->gridDim.x > 8 ||
      cfg->blockDim.x > 512 || cfg->blockDim.x % 32 != 0)
    return cudaErrorInvalidValue;
  host::launch(cfg->gridDim, cfg->blockDim, [&] { k(args...); });
  return host::failed ? cudaErrorLaunchFailure : cudaSuccess;
}
