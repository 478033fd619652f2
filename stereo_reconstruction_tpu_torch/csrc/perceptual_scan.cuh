// K4 — the perceptual matcher's windowed smoother, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the lax.scan + lax.while_loop of stereo_reconstruction_tpu/
// perceptual/cost.py:292-346, windowed_smooth_argmin (not a Pallas kernel:
// on the TPU it was an XLA loop). From the (H, D, W) float32 LPIPS cost
// volume it runs the reference notebook's chunked multiplicative smoothing
// (cell 10) and writes the (H, W) float32 argmin indices:
//
//   c[d] = (cost[y, d, x] * T[|d - disp[y-1, x]|]) * T[|d - mean|],
//   mean = min(disp[y, x-1], min(D, W - x)),
//
// the first factor for y > 0 only, the second only where x is not the first
// pixel of its chunk of `chunk` columns; disp[y, x] = argmin_d c[d] with
// jnp.argmin's order (NaN first, then the smaller value, then the smaller
// index). T[k] = (1 - exp(-k / sigma)) + bias is a table of D + 1 floats
// made by the wrapper: every argument of the weight is an integer in
// [0, D], so the kernel and its plain twin (perceptual/scan.py::
// window_scan_plain) multiply by the same numbers and agree bit for bit.
//
// What binds: pixel (y, p) of a chunk's strip needs (y-1, p), its up, and
// (y, p-1), its left, so a strip is a chain of dependent argmins over D.
// Walked row by row and left to right it is H x len steps long (7,500 at
// 375x450, chunk 20); walked by anti-diagonals t = y + p, whose pixels are
// independent, it is H + len - 1 steps (394). The bytes (the volume read
// once: 0.02 ms at 375x450, D=100) and the 3 operations an entry are far
// below that chain. What binds now is each warp's own work a diagonal,
// ~1 us for one strip alone on an H100 at 700 W, ~0.7 us of it without the
// staging copies; the diagonal's barrier and the two redux are a few per
// cent (perf/k4_variants/: no_copy, no_wait, no_redux).
//
// Design: a layout pass, then one CTA per strip walking its diagonals.
//
//   * perceptual_layout_kernel copies the volume to (H, W, D) in scratch
//     (32 x 32 tiles through shared memory; each pixel's run padded to 16
//     bytes), so a position's row is one contiguous run that a lane
//     copies 16 bytes at a time, not D gathers of 4 bytes strided by W
//     (perf/k4_variants/gather.patch).
//   * Warp w owns the positions p = w, w + nw, ... (nw = min(32, chunk)
//     warps); at diagonal t position p resolves row t - p. Lanes run over
//     d. A position's up is its own result of the previous diagonal and
//     its left is position p-1's, both in a ring of two rows of `chunk`
//     indices in shared memory, indexed by diagonal parity. One mbarrier of
//     nw arrivals closes each diagonal: lane 0 of a warp arrives once its
//     results are stored, the warp issues its copies, then waits for the
//     diagonal's phase before the next step.
//   * The copies: each position's row S diagonals ahead goes with cp.async
//     into the position's ring of S rows in shared memory (S = kMaxStages,
//     or the most that fit); the warp waits for the row S - 1 diagonals
//     later, then syncs, so each lane sees the others' 16 bytes. When not
//     even one row of the strip fits, the scan reads the copy directly
//     (the `kStaged = false` instance).
//   * The step: c = (cost * T[|d - up|]) * T[|d - mean|], an absent factor
//     a product with 1.0 (a table of ones), 4 candidates a lane at a time
//     with no branch, so their loads issue together (perf/k4_variants/
//     unroll4, divergent and masked_branch: the loops it replaced). The
//     argmin compares an order-preserving 32-bit key: every NaN maps to 0,
//     -0.0 and +0.0 to one key (the cost + 0.0), numbers in order above;
//     strict < over a lane's ascending d keeps the first index, and two
//     redux.sync.min (the key, then the index among lanes holding it)
//     finish the warp.
//
// Shared memory: the barrier, 2 x chunk indices, the table, the ones and S
// x chunk x padded(D) costs; only the first four must fit in 227 KB (chunk
// <= ~29,000 at D = 1, D <= ~29,000 at chunk 1), the rest is what is left.
// Device scratch: the (H, W, D) copy, as large as the volume (padded).
//
// Exactness: the products are __fmul_rn in the twin's order (cost times
// the row weight, then times the pixel weight; a product with 1.0 is
// exact), no --use_fast_math.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace stpu {
namespace k4 {

// a block may use 227 KB of dynamic shared memory on Hopper
constexpr long long kMaxSmem = 232448;
constexpr int kMaxStages = 4;     // rows of the volume a position stages (a power of 2)
constexpr int kPerWarp = 1;       // positions a warp owns: nw = min(32, ceil(chunk / kPerWarp))

__host__ __device__ inline long long align16(long long b) { return (b + 15) / 16 * 16; }

// a pixel's run of D costs in the copy and in the ring, padded to 16 bytes
__host__ __device__ inline long long padded(long long D) { return (D + 3) / 4 * 4; }

// Dynamic shared memory of a CTA: the diagonal barrier (16 bytes), two
// diagonals of chunk indices, the D + 1 weights and D + 1 ones, then S
// rows of padded(D) costs for each of chunk positions.
__host__ __device__ inline long long table_offset(long long chunk) {
  return align16(16 + 8 * chunk);
}
__host__ __device__ inline long long ring_offset(long long D, long long chunk) {
  return align16(table_offset(chunk) + 8 * (D + 1));
}
// S: the most staged rows that fit, a power of 2 up to kMaxStages; 0 if
// none does
__host__ __device__ inline int stages(long long D, long long chunk) {
  const long long free = kMaxSmem - ring_offset(D, chunk);
  int s = kMaxStages;
  while (s > 0 && s * 4 * padded(D) * chunk > free) s /= 2;
  return s;
}
__host__ __device__ inline long long smem_bytes(long long D, long long chunk) {
  return ring_offset(D, chunk) + 4 * padded(D) * chunk * stages(D, chunk);
}
// device scratch of the copy: H x W runs of padded(D) floats
__host__ __device__ inline long long scratch_bytes(long long H, long long D, long long W) {
  return 4 * H * W * padded(D);
}

// ---- PTX primitives (sm_90; tests/k4_host/ holds their host stand-ins) ----
__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(a), "r"(count) : "memory");
}

// one arrival, release at CTA scope
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(a) : "memory");
}

// until the phase of parity `parity` has completed; acquire at CTA scope
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// 16 bytes, both addresses 16-byte aligned
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most `pending` (S - 1: 0, 1 or 3) of this thread's newest
// groups are in flight
__device__ __forceinline__ void wait_async(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}
// ---- end of PTX primitives ----

// jnp.argmin's order as unsigned order: NaN (any) 0, then the numbers in
// order, -0.0 and +0.0 one key
__device__ __forceinline__ unsigned order_key(float c) {
  const unsigned u = __float_as_uint(__fadd_rn(c, 0.0f));
  const unsigned k = u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
  return isnan(c) ? 0u : k;
}

}  // namespace k4

// The layout pass: the (H, D, W) volume into `cols`, its (H, W, D) copy,
// so each pixel's D costs are one contiguous run for the scan's copies.
// Grid: (ceil(W / 32), ceil(D / 32), up to 65535 rows, looped); 32 x 8
// threads transpose a 32 x 32 tile of (d, x) through shared memory.
__global__ void __launch_bounds__(256)
perceptual_layout_kernel(const float* __restrict__ cost, float* __restrict__ cols, int H,
                         int D, int W) {
  __shared__ float tile[32][33];
  const int x0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const size_t Dp = k4::padded(D);
  for (int y = blockIdx.z; y < H; y += gridDim.z) {
    for (int i = threadIdx.y; i < 32; i += 8) {
      const int d = d0 + i, x = x0 + threadIdx.x;
      if (d < D && x < W) tile[i][threadIdx.x] = cost[((size_t)y * D + d) * W + x];
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8) {
      const int x = x0 + i, d = d0 + threadIdx.x;
      if (d < D && x < W) cols[((size_t)y * W + x) * Dp + d] = tile[threadIdx.x][i];
    }
    __syncthreads();
  }
}

// The scan over `cols`. Grid: one CTA per chunk strip; blockDim.x = 32 x
// nw. S rows staged per position (kStaged), or none: `cols` is read in the
// step.
template <bool kStaged>
__global__ void __launch_bounds__(1024)
perceptual_scan_kernel(const float* __restrict__ cols, const float* __restrict__ table,
                       float* __restrict__ out, int H, int D, int W, int chunk, int S) {
  using namespace k4;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bar = reinterpret_cast<unsigned long long*>(smem);
  int* res = reinterpret_cast<int*>(smem + 16);                        // [2][chunk]
  float* tab = reinterpret_cast<float*>(smem + table_offset(chunk));
  float* ones = tab + D + 1;              // the weight of an absent factor
  float* ring = reinterpret_cast<float*>(smem + ring_offset(D, chunk));  // [chunk][S][Dp]
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int x0 = blockIdx.x * chunk;
  const int len = min(chunk, W - x0);     // this strip's columns
  const int diagonals = H + len - 1;
  const int nj = (D + 31) / 32;           // candidates a lane
  const int Dp = (int)padded(D);
  for (int i = threadIdx.x; i <= D; i += blockDim.x) {
    tab[i] = table[i];
    ones[i] = 1.0f;
  }
  if (threadIdx.x == 0) bar_init(bar, nw);
  __syncthreads();

  // row y of position p: its D costs and its ring slot
  auto column = [&](int p, int y) { return cols + ((size_t)y * W + x0 + p) * Dp; };
  auto slot = [&](int p, int y) { return ring + ((size_t)p * S + (y & (S - 1))) * Dp; };

  // after diagonal t's arrival: copy each position's row t - p + S into the
  // slot that row t - p leaves, then wait for row t + 1 - p (copied S - 1
  // diagonals ago)
  auto ahead = [&](int t) {
    for (int p = warp; p < len; p += nw) {
      const int y = t - p + S;
      if (y >= 0 && y < H) {
        const float* src = column(p, y);
        float* dst = slot(p, y);
        for (int e = 4 * lane; e < Dp; e += 128) copy_async(dst + e, src + e);
      }
    }
    commit_async();                       // one group a diagonal, empty or not
    wait_async(S - 1);
    __syncwarp();                         // each lane's 16 bytes, to the lanes that read them
  };

  // diagonal t: position p resolves row t - p
  auto step = [&](int t) {
    const int* prev = res + ((t + 1) & 1) * chunk;    // diagonal t - 1
    int* cur = res + (t & 1) * chunk;
    for (int p = warp; p < len; p += nw) {
      const int y = t - p;
      if (y < 0 || y >= H) continue;      // the same in every lane
      const float* wu = y > 0 ? tab : ones;                   // T[|d - up|]
      const float* wl = p > 0 ? tab : ones;                   // T[|d - mean|]
      const int up = y > 0 ? prev[p] : 0;
      const int mean = p > 0 ? min(prev[p - 1], min(D, W - x0 - p)) : 0;
      const float* src = kStaged ? slot(p, y) : column(p, y);
      // 4 candidates a lane at a time with no branch, so their loads
      // issue together; a candidate past D reads candidate D - 1 and is
      // dropped
      unsigned bk = UINT_MAX, bi = 0;
      for (int d0 = lane; d0 < nj * 32; d0 += 128) {
#pragma unroll
        for (int d = d0; d < d0 + 128; d += 32) {
          const int dc = min(d, D - 1);
          const float v = kStaged ? src[dc] : __ldg(src + dc);
          const float c = __fmul_rn(__fmul_rn(v, wu[abs(dc - up)]), wl[abs(dc - mean)]);
          // dropped past D by a mask: `d < D ? order_key(c) : UINT_MAX`
          // compiles to a branch a candidate, which serialises the loads
          const unsigned k = order_key(c) | (d < D ? 0u : UINT_MAX);
          bi = k < bk ? (unsigned)d : bi;
          bk = min(k, bk);
        }
      }
      const unsigned m = __reduce_min_sync(full, bk);
      const unsigned i = __reduce_min_sync(full, bk == m ? bi : UINT_MAX);
      if (lane == 0) {
        cur[p] = (int)i;
        out[(size_t)y * W + x0 + p] = (float)i;
      }
    }
  };

  if constexpr (kStaged)
    for (int t = -S; t < 0; ++t) ahead(t);
  for (int t = 0; t < diagonals; ++t) {
    if (t > 0) bar_wait(bar, (t - 1) & 1);
    step(t);
    __syncwarp();                         // every lane is done with diagonal t - 1
    if (lane == 0) bar_arrive(bar);
    if constexpr (kStaged) ahead(t);
  }
}

}  // namespace stpu
