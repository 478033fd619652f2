// Host stand-in for the CUDA runtime, enough to build csrc/ransac.cu with a
// C++ compiler (tests/test_torch_ransac_host.py). A CTA's threads are
// fibers (ucontext) on one host thread, resumed in turn: each runs to its
// next __syncwarp or shuffle and yields, so the lanes of a warp meet at
// every warp-wide operation as they do on the card, without an OS thread
// each. CTAs are spread over a few host threads; __shared__ is per host
// thread, which holds one CTA at a time.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <ucontext.h>

#include <algorithm>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static thread_local

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }

inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = sqrtf(a); return r; }
inline float __frcp_rn(float a) { volatile float r = 1.0f / a; return r; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }

namespace host {

struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  dim3 idx;
  unsigned shuffles = 0;
  bool done = false;
};

struct Cta {
  ucontext_t sched;
  std::vector<Fiber> fibers;
  Fiber* cur = nullptr;
  std::vector<uint64_t> shfl;           // per warp, two slots of 32 lanes
  const std::function<void()>* body = nullptr;
};

inline thread_local Cta* cta;
inline thread_local dim3 block_idx;
inline dim3 grid_dim, block_dim;

inline void yield() { swapcontext(&cta->cur->ctx, &cta->sched); }

inline void entry() {
  (*cta->body)();
  cta->cur->done = true;
}

// Runs CTAs first, first + step, ... of the grid on this host thread.
inline void run_ctas(unsigned first, unsigned step, const std::function<void()>& body) {
  Cta c;
  cta = &c;
  c.body = &body;
  const unsigned n = block_dim.x;
  c.fibers.resize(n);
  c.shfl.assign((n + 31) / 32 * 64, 0);
  for (auto& f : c.fibers) f.stack.resize(1 << 16);
  for (unsigned b = first; b < grid_dim.x; b += step) {
    block_idx = dim3(b);
    for (unsigned t = 0; t < n; ++t) {
      Fiber& f = c.fibers[t];
      f.idx = dim3(t);
      f.shuffles = 0;
      f.done = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = &c.sched;
      makecontext(&f.ctx, entry, 0);
    }
    for (bool live = true; live;) {
      live = false;
      for (auto& f : c.fibers) {
        if (f.done) continue;
        c.cur = &f;
        swapcontext(&c.sched, &f.ctx);
        live = live || !f.done;
      }
    }
  }
}

template <class F> void launch(dim3 g, dim3 b, F f) {
  grid_dim = g;
  block_dim = b;
  const std::function<void()> body = f;
  const unsigned threads = std::min(4u, g.x);
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t) ts.emplace_back(run_ctas, t, threads, std::cref(body));
  for (auto& t : ts) t.join();
}

}  // namespace host

#define threadIdx (::host::cta->cur->idx)
#define blockIdx (::host::block_idx)
#define blockDim (::host::block_dim)
#define gridDim (::host::grid_dim)

inline void __syncwarp(unsigned = 0xffffffffu) { host::yield(); }

// Every lane writes its value into the warp's slot of this shuffle's
// parity, yields until the whole warp has written, then reads. A lane
// reuses a slot two shuffles on, by which time every lane has read it.
template <class T> T shuffle_from(T v, int src) {
  host::Fiber* f = host::cta->cur;
  const unsigned lane = f->idx.x & 31, warp = f->idx.x >> 5;
  uint64_t* slot = &host::cta->shfl[(warp * 2 + (f->shuffles++ & 1)) * 32];
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  slot[lane] = bits;
  host::yield();
  T r;
  memcpy(&r, &slot[src & 31], sizeof(T));
  return r;
}

template <class T> T __shfl_sync(unsigned, T v, int src) { return shuffle_from(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) {
  return shuffle_from(v, (int)(host::cta->cur->idx.x & 31) ^ mask);
}
