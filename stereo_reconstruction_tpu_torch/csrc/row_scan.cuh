// K1b — the exact smoothing row scan, CUDA C++ for Hopper (sm_90a).
//
// Replaces the lax.scan of stereo_reconstruction_tpu/ops/smoothing.py::
// smoothed_argmin_from_inputs (not a Pallas kernel: on the TPU it was an
// XLA loop). From the five planes of K1 (m0, a0, c_zero, diag_up, diag_lf)
// and the black mask it runs the Right variant's smoothing recurrence
// (BlockSearch.cpp:160-171) row by row, exactly:
//
//   * the up neighbour is the previous row's final disparity, so rows are
//     sequential; row 0 has none. Seeded rows (the sharded matcher's row
//     tiles, JAX's first_flags / init_prev): a row whose `first` flag is
//     set has no up neighbour, and row 0's up neighbour is the row
//     `init_prev` when its flag is clear. Null pointers mean row 0 alone
//     is first and the seed is 0;
//   * inside a row the left neighbour acts through a 3-state automaton
//     (left chose none of the special values / 0 / the sentinel -x). Each
//     pixel's disparity under each of the 3 input cases (d_none, d_zero,
//     d_sent) depends on the row above only, and its case transition packs
//     into 6 bits; an inclusive scan of the composition (b o a)[c] = b[a[c]]
//     gives every pixel's true input case.
//
// Design: column strips pipelined row by row across a thread-block
// cluster. Pixel (y, x) depends on the row above only at its own column,
// so a strip of columns needs its own previous row and one 2-bit input
// from outside, the case entering its first column on the same row. One
// warp owns one strip of kStripCols = 64 columns (lane l the kCols columns
// x0 + 2l, x0 + 2l + 1) and keeps the strip's previous row in registers.
// Per row it takes the case entering its first column from the strip on
// its left, forms each column's three candidates and 6-bit transition
// (they need the row above only), scans the lanes' maps with 5 shuffles
// into the strip's 3 -> 3 map, applies it to the entering case, selects
// and stores, and passes the case leaving its last column to the strip on
// its right. Strip j thus works on row y while strip j + 1 is a step
// behind, and the chain is H strip-steps plus (strips - 1) hand-offs
// instead of H whole-row steps on one SM.
//
//   * One launch is one cluster of up to 8 CTAs (portable size), each of
//     up to 16 consecutive strips, so W <= 8 x 16 x 64 = 8192; a 1-column
//     image is one CTA of one warp. No CTA-wide barrier runs in the row
//     loop, and nothing spins on global memory: a cluster's CTAs are
//     resident together.
//   * The hand-off goes through distributed shared memory: lane 0 of the
//     left strip st.async's the leaving case into a slot of the right
//     strip's ring (a shared::cluster address from mapa, the same path for
//     a neighbour in its own CTA), completing 4 bytes of that slot's
//     mbarrier transaction; the right strip's lane 0 arms the barrier
//     (arrive.expect_tx), waits on it, and st.async's an acknowledgement to
//     the left strip's "empty" barrier, so the left strip runs at most
//     kRing rows ahead. st.async carries no fence: a release arrive at
//     cluster scope would wait, every row, for the warp's output stores to
//     drain.
//   * Loads: each lane loads its columns kAhead rows ahead into registers,
//     coalesced across the warp, and keeps them as loaded until their row
//     (converting a0 or testing black at load time would make the warp
//     wait for the load at once).
//   * The candidates are compared as disparities d_first + index (exact
//     floats: "lower index wins a tie" is "lower disparity wins"), with
//     selects written as selp, so the step stays branch-free whatever nvcc
//     decides.
//
// perf/k1b_variants/ holds the edits of this design that were tried and
// dropped, and the script that times them against it.
//
// Bound: the bytes are 25 per pixel (five planes, the mask, the output):
// 40 MB at 1128x1408, 0.012 ms at 3.35 TB/s, and the arithmetic is tens of
// operations per pixel. Neither binds: the chain does, H strip-steps of
// latency in one warp (dependent compares and selects for the
// candidates, the 5-step scan, a shuffle and a 6-operation composition
// each, and the select), ~0.56 us a row for one strip alone on an H100
// SXM at 700 W (chip_smoke.py's chain line). The canvas of 22 strips adds
// ~0.35 ms at 1128x1408: the hand-offs ~0.14 ms of it (the canvas timed
// without them, perf/k1b_variants/no_handoff.patch), the fill and three
// warps sharing each SM the rest.
//
// Exactness: the products are __fmul_rn in the plain version's order
// (up_val * sf, then * extra; lf_val * sf, then * extra), the ties keep the
// lexicographic (value, index) rule with the -1 index of the "none" case,
// the x = 0 sentinel -0.0 equals 0.0 so the zero test comes first, and
// IEEE specials compare as in torch (inf * 0 = NaN compares false), so the
// output equals ops/smoothing.py::smoothed_argmin_from_inputs bit for bit
// on any input.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace stpu {
namespace k1b {

constexpr int kCols = 2;                    // columns per lane
constexpr int kStripCols = 32 * kCols;      // a strip: one warp
constexpr int kMaxCluster = 8;              // CTAs a launch (portable)
constexpr int kMaxWarps = 16;               // strips a CTA
constexpr int kMaxWidth = kMaxCluster * kMaxWarps * kStripCols;   // 8192
constexpr int kRing = 8;                    // hand-off slots a strip
constexpr int kAhead = 4;                   // rows loaded ahead of their use
constexpr unsigned kIdentity = 0u | (1u << 2) | (2u << 4);

// The hand-off rings of a CTA's strips, in its shared memory: the case
// entering strip w on row y arrives in slot[w][y % kRing] and completes
// full[w][..]; its right neighbour's acknowledgements land in ack[w][..]
// and complete empty[w][..].
struct Rings {
  unsigned slot[kMaxWarps][kRing];
  unsigned long long full[kMaxWarps][kRing];
  unsigned long long empty[kMaxWarps][kRing];
  unsigned ack[kMaxWarps][kRing];
};

// ---- PTX primitives (sm_90; tests/k1b_host/ holds their host stand-ins) ----
// p ? a : b as one selp: a branch there would diverge on real data
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\tselp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r) : "f"(a), "f"(b), "r"((unsigned)p));
  return r;
}

using caddr = std::uint32_t;    // a shared::cluster address

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; release / acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;"
               ::: "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(a) : "memory");
}

// after bar_init, before the cluster_sync that publishes the barriers
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// `p` (this CTA's shared memory) as it lies in CTA `rank` of the cluster
__device__ __forceinline__ caddr peer(const void* p, unsigned rank) {
  caddr r;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// one arrival on this CTA's barrier that also expects `bytes` to land
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(a), "r"(bytes) : "memory");
}

// stores v into a word of any CTA of the cluster and counts its 4 bytes
// on that CTA's barrier `bar`: no fence, so it does not wait for this
// thread's stores to the output
__device__ __forceinline__ void peer_send(caddr slot, unsigned v, caddr bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               :: "r"(slot), "r"(v), "r"(bar) : "memory");
}

// until the phase of parity `parity` of this CTA's barrier has completed;
// the words a peer_send counted on it are visible after
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

__device__ __forceinline__ unsigned slot_load(const unsigned* p) {
  return *(const volatile unsigned*)p;
}
// ---- end of PTX primitives ----

__device__ __forceinline__ unsigned map_at(unsigned m, unsigned c) {
  return (m >> (2 * c)) & 3u;
}

// (b o a)[c] = b[a[c]]: a first, then b
__device__ __forceinline__ unsigned compose(unsigned b, unsigned a) {
  return map_at(b, a & 3u) | (map_at(b, (a >> 2) & 3u) << 2) |
         (map_at(b, (a >> 4) & 3u) << 4);
}

// The pixel's disparity when its left neighbour offers (lf_val, f_lf):
// lexicographic min of the plain argmin, the up candidate and the left one.
// Candidates carry their disparity d_first + index (an exact float) in
// place of the index: the tie rule "lower index" is "lower disparity".
__device__ __forceinline__ float resolve(float m0, float f_a0, float v_u, float f_up,
                                         float lf_val, float f_lf, float sf,
                                         float sentinel, bool black) {
  const bool both = f_lf == f_up && isfinite(v_u) && isfinite(lf_val);
  const float extra = sel(both, sf, 1.0f);
  const float v2 = __fmul_rn(v_u, extra);
  const bool take2 = v2 < m0 || (v2 == m0 && f_up < f_a0);
  const float best2 = sel(take2, v2, m0);
  const float d2 = sel(take2, f_up, f_a0);
  const float v3 = __fmul_rn(__fmul_rn(lf_val, sf), extra);
  const bool take3 = v3 < best2 || (v3 == best2 && f_lf < d2);
  const float best = sel(take3, v3, best2);
  const float disp = sel(isfinite(best), sel(take3, f_lf, d2), sentinel);
  return sel(black, 0.0f, disp);
}

// resolve with no left candidate (+inf, index -1): the left entry can win
// only a tie at +inf, and then the pixel is the sentinel all the same
__device__ __forceinline__ float resolve_none(float m0, float f_a0, float v_u, float f_up,
                                              float sentinel, bool black) {
  const bool take2 = v_u < m0 || (v_u == m0 && f_up < f_a0);
  const float disp = sel(isfinite(sel(take2, v_u, m0)), sel(take2, f_up, f_a0), sentinel);
  return sel(black, 0.0f, disp);
}

__device__ __forceinline__ unsigned case_of(float d, float sentinel) {
  return d == 0.0f ? 1u : (d == sentinel ? 2u : 0u);
}


}  // namespace k1b

// kSeeded: the instance that reads `first` / `init_prev` (either may still
// be null); the whole-image scan runs the other and reads no per-row flag.
// Grid: one cluster of gridDim.x CTAs of blockDim.x / 32 warps each; the
// first `strips` = ceil(W / kStripCols) warps hold columns, the rest idle.
template <bool kSeeded>
__global__ void __launch_bounds__(k1b::kMaxWarps * 32)
row_scan_kernel(const float* __restrict__ m0, const int* __restrict__ a0,
                const float* __restrict__ cz, const float* __restrict__ du,
                const float* __restrict__ dl,
                const unsigned char* __restrict__ black,
                const unsigned char* __restrict__ first,    // (H,) or null
                const float* __restrict__ init_prev,        // (W,) or null
                float* __restrict__ out, int H, int W, float sf, int d_first,
                int D, int strips) {
  using namespace k1b;
  constexpr int K = kCols;
  __shared__ Rings rings;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int strip = (int)cluster_rank() * nwarps + warp;
  if (lane == 0) {
    for (int i = 0; i < kRing; ++i) {
      bar_init(&rings.full[warp][i]);
      bar_init(&rings.empty[warp][i]);
    }
    bar_init_fence();
  }
  cluster_sync();                 // every strip's barriers are initialised

  if (strip < strips) {
    const bool has_left = strip > 0, has_right = strip + 1 < strips;
    // the right neighbour's ring, where this warp's exit cases go, and the
    // left neighbour's acknowledgement words and "empty" barriers, where
    // this warp reports each slot it has read
    caddr right_slot = 0, right_full = 0, left_ack = 0, left_empty = 0;
    if (has_right) {
      const unsigned rank = (strip + 1) / nwarps, w = (strip + 1) % nwarps;
      right_slot = peer(&rings.slot[w][0], rank);
      right_full = peer(&rings.full[w][0], rank);
    }
    if (has_left) {
      const unsigned rank = (strip - 1) / nwarps, w = (strip - 1) % nwarps;
      left_ack = peer(&rings.ack[w][0], rank);
      left_empty = peer(&rings.empty[w][0], rank);
    }
    const float kInf = __int_as_float(0x7f800000);
    const unsigned full = 0xffffffffu;
    const int xk = strip * kStripCols + lane * K;       // this lane's first column
    // per column: the sentinel -x, the disparities of the sentinel
    // candidates (up: d = x, left: d = x - 1, indices clamped as the twin
    // does) and the clamped column the loads read (columns past W compute
    // on W - 1's inputs and store nothing)
    float sent[K], f_up_sent[K], f_lf[K];
    int xc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = xk + k;
      sent[k] = -(float)x;
      f_up_sent[k] = (float)(d_first + min(max(x - d_first, 0), D - 1));
      f_lf[k] = (float)(d_first + min(max(x - 1 - d_first, 0), D - 1));
      xc[k] = min(x, W - 1);
    }

    // A row's inputs at this lane's columns, loaded kAhead rows before
    // their use: they do not depend on the scan. Kept as loaded (nothing
    // may read a load's result here, or the warp waits for it).
    struct Row {
      float m0[K], cz[K], du[K], dl[K];
      int a0[K];
      unsigned char blk[K];
      unsigned char first;        // the row's `first` flag
    };
    auto load = [&](Row& r, int y) {
      if (y >= H) return;
      const size_t row = (size_t)y * W;
      if constexpr (kSeeded) r.first = first != nullptr ? __ldg(first + y) : y == 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r.m0[k] = __ldg(m0 + row + xc[k]);
        r.a0[k] = __ldg(a0 + row + xc[k]);
        r.cz[k] = __ldg(cz + row + xc[k]);
        r.du[k] = __ldg(du + row + xc[k]);
        r.dl[k] = __ldg(dl + row + xc[k]);
        r.blk[k] = __ldg(black + row + xc[k]);
      }
    };

    float prev[K];                // this lane's columns of the row above
#pragma unroll
    for (int k = 0; k < K; ++k)
      prev[k] = kSeeded && init_prev != nullptr ? __ldg(init_prev + xc[k]) : 0.0f;

    auto step = [&](int y, const Row& r) {
      // the case entering the strip on this row (x = 0 enters with 0), from
      // the strip on the left, which runs a step ahead: a wait that finds
      // its phase complete is short, one that blocks is not
      const int slot = y % kRing;
      unsigned c_in = 0;
      if (has_left) {
        if (lane == 0) {
          bar_expect(&rings.full[warp][slot], 4);
          bar_wait(&rings.full[warp][slot], (y / kRing) & 1);
          c_in = slot_load(&rings.slot[warp][slot]);
          if (y + kRing < H)             // the slot is free: the acknowledgement
            peer_send(left_ack + 4 * slot, c_in,       // carries the word read,
                      left_empty + 8 * slot);          // so it cannot leave first
        }
        c_in = __shfl_sync(full, c_in, 0);
      }
      // the candidates under each entering case (they need the row above
      // only), the case each leaves, and the lane's map
      float dn[K], dz[K], ds[K];
      unsigned maps = 0;          // K transitions of 6 bits
      unsigned mine = kIdentity;  // their composition
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float p = prev[k];
        const bool up_zero = p == 0.0f;
        const float f_up = sel(up_zero, 0.0f, f_up_sent[k]);
        const float up_val = sel(up_zero, r.cz[k], sel(p == sent[k], r.du[k], kInf));
        const bool has_up = kSeeded ? r.first == 0 : y > 0;
        const float v_u = sel(has_up, __fmul_rn(up_val, sf), kInf);
        const float fa0 = (float)(d_first + r.a0[k]);
        const bool blk = r.blk[k] != 0;
        dn[k] = resolve_none(r.m0[k], fa0, v_u, f_up, sent[k], blk);
        dz[k] = resolve(r.m0[k], fa0, v_u, f_up, r.cz[k], 0.0f, sf, sent[k], blk);
        ds[k] = resolve(r.m0[k], fa0, v_u, f_up, r.dl[k], f_lf[k], sf, sent[k], blk);
        const unsigned g = case_of(dn[k], sent[k]) | (case_of(dz[k], sent[k]) << 2) |
                           (case_of(ds[k], sent[k]) << 4);
        maps |= g << (6 * k);
        mine = compose(g, mine);
      }
      // inclusive scan of the lanes' maps: the strip's map to each lane
      unsigned v = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(full, v, off);
        v = compose(v, lane >= off ? o : kIdentity);      // no branch
      }
      unsigned before = __shfl_up_sync(full, v, 1);     // the lanes below
      before = lane == 0 ? kIdentity : before;
      const unsigned total = __shfl_sync(full, v, 31);
      unsigned c = map_at(before, c_in);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float d = sel(c == 0, dn[k], sel(c == 1, dz[k], ds[k]));
        if (xk + k < W) out[(size_t)y * W + xk + k] = d;
        prev[k] = d;
        c = map_at((maps >> (6 * k)) & 63u, c);
      }
      // the case leaving the strip enters the strip on the right
      if (has_right && lane == 0) {
        if (y >= kRing) {                // its reader is done with row y - kRing
          bar_expect(&rings.empty[warp][slot], 4);
          bar_wait(&rings.empty[warp][slot], ((y / kRing) & 1) ^ 1);
        }
        peer_send(right_slot + 4 * slot, map_at(total, c_in), right_full + 8 * slot);
      }
    };

    Row buf[kAhead];
#pragma unroll
    for (int p = 0; p < kAhead; ++p) load(buf[p], p);
    for (int y0 = 0; y0 < H; y0 += kAhead) {
#pragma unroll
      for (int p = 0; p < kAhead; ++p) {
        const int y = y0 + p;
        if (y < H) {
          step(y, buf[p]);        // in place: a copy would wait on the loads
          load(buf[p], y + kAhead);
        }
      }
    }
  }
  cluster_sync();                 // no CTA leaves while a neighbour may reach it
}

}  // namespace stpu
