// Host stand-in for the CUDA runtime, enough to build csrc/ba.cu with a C++
// compiler (tests/test_torch_ba_host.py): the RANSAC kernel's stand-in (a
// CTA's threads as fibers that meet at every warp-wide operation) and
// __syncthreads. At a barrier each fiber yields until the CTA's last one
// arrives; that one yields once too, so that all of them leave it in the
// same pass and the lanes of a warp meet at their next shuffle together.
#pragma once
#include "../ransac_host/cuda_runtime.h"

namespace host {
struct Barrier {
  unsigned count = 0, generation = 0;
};
inline thread_local Barrier barrier;
}  // namespace host

inline void __syncthreads() {
  host::Barrier& b = host::barrier;
  const unsigned generation = b.generation;
  if (++b.count == host::block_dim.x) {
    b.count = 0;
    ++b.generation;
    host::yield();
  } else {
    while (b.generation == generation) host::yield();
  }
}
