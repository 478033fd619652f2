// Host stand-in for the CUDA runtime, enough to build csrc/sift.cu with a C++
// compiler (tests/test_torch_sift_host.py): the BA kernel's stand-in (a
// CTA's threads as fibers that meet at every __syncthreads), int min and
// max, and dynamic shared memory. The test rewrites each kernel's
// `extern __shared__ float smem[];` to `float* const smem =
// host::dynamic_smem();` and each launch to host::launch_smem, which keeps
// its byte count.
#pragma once
#include "../ba_host/cuda_runtime.h"

#include <atomic>

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

namespace host {
inline size_t smem_bytes = 0;
inline std::atomic<unsigned long long> generation{0};

// The CTA's dynamic shared memory: one buffer a host thread, which holds
// one CTA at a time, filled with NaN when that thread starts a new CTA, so
// that a read of a word no thread wrote shows.
inline float* dynamic_smem() {
  thread_local std::vector<float> buf;
  thread_local unsigned long long owner = ~0ull;
  const unsigned long long cta = generation.load() << 32 | block_idx.x;
  if (owner != cta) {
    buf.assign(smem_bytes / sizeof(float) + 1, NAN);
    owner = cta;
  }
  return buf.data();
}

template <class F> void launch_smem(dim3 g, dim3 b, size_t bytes, F f) {
  smem_bytes = bytes;
  ++generation;
  launch(g, b, f);
}
}  // namespace host
