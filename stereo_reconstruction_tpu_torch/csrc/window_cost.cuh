// The Right-variant window-cost routine shared by K1, K2 and K3's cost pass,
// CUDA C++ for Hopper (sm_90a).
//
// For every output pixel (y, x) of a 48 x 64 tile of the right image and
// every plane j in [0, j_end) (disparity d = min_d + j) it forms the window
// sum of the reference cost (BlockSearch.cpp:116-158)
//
//   cost = sqrt(SSD over [y-hbs, y+hbs) x [x-hbs, x+hbs) clipped to
//               [0, H-1) x [0, W-1)) * (1 / area),
//   +inf where area <= 0 or x + d + min(W-1-x, hbs) >= WL,
//
// Global rows: the images may be a row tile of a taller image, local row 0
// being global row row0 of H_total rows (the sharded matcher's
// halo-extended tiles; the TPU kernel's geom input [row0, H_total]). The
// window is then clipped to global rows [0, H_total - 1), the area counts
// global rows, and a row outside [0, H_total) has area 0. Rows outside the
// local [0, H) read as zero, so where row0 > 0 (or the tile ends above the
// image bottom) the first (last) 2hbs output rows see that padding as
// image and are the caller's to drop. A whole image is row0 = 0,
// H_total = H: the same code, the same arithmetic.
//
// and hands each thread's 8 window sums of plane j to a sink, which folds
// them (K1), stores the costs (K2) or stores them and keeps each pixel's
// three smallest (K3's cost pass). Planes j >= j_end have no candidate
// anywhere in the tile and are never formed: the sink treats them as +inf.
//
// Arithmetic order (one order for every sink, so K1's planes equal
// volume_reductions(K2) bit for bit on any input): the squared difference
// adds channels 0, 1, 2 from 0; the vertical window sum adds rows
// y-hbs .. y+hbs-1 in order from 0; the horizontal sum adds columns
// x-hbs .. x+hbs-1 of those in order from 0; the sink takes the IEEE sqrt
// and multiplies by 1/area. Every operation is an explicit round-to-nearest
// intrinsic (no FMA contraction). Do not build with --use_fast_math.
//
// Design. One CTA of 384 threads owns a 48 x 64 output tile and walks its
// planes in three phases split by two barriers:
//   A1  the masked dsq of the (48 + 2hbs) x (64 + 2hbs) band: a thread owns
//       one band column and every TC-th band row (TC = 384 / band width,
//       4 at hbs 8). The right band is staged once in shared memory; the
//       left comes from a layout pass (left_layout_kernel: channels 0-1 as
//       float2, channel 2 as float, zero-padded past WL), so a pixel is two
//       coalesced loads. The loads carry no branch, so all of a thread's
//       loads of a plane are in flight together; interior tiles skip the
//       masks. One shared write per dsq.
//   A2  a thread owns (band column, 12 output rows): it reads the 11 + 2hbs
//       dsq of that segment once and forms the 12 vertical sums in
//       registers. One shared write per sum.
//   B   a thread owns 8 consecutive outputs of one row: it reads the
//       7 + 2hbs vertical sums once, forms the 8 horizontal sums in
//       registers and hands them to the sink. The sums' row stride is odd
//       and a warp covers 8 rows x 4 groups, so its reads are free of bank
//       conflicts, and a sink that stores plane j writes one 128-byte row
//       segment per row of the warp.
// That is ~5 shared-memory accesses and 2 barriers per (pixel, plane); the
// taller tile cuts the vertical halo to 1.33x. Two CTAs fit an SM (97.5 KB
// of shared memory each at hbs 8). hbs is a template parameter (0..8,
// block sizes up to 17: the TPU kernel's 24-row bands hold 8 + 2*8 rows at
// most), so every register array has a fixed size.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace stpu {
namespace wc {

constexpr int kTX = 64;        // output columns per CTA
constexpr int kTY = 48;        // output rows per CTA
constexpr int kThreads = 384;
constexpr int kP = 8;          // outputs per thread in phase B
constexpr int kSegs = 4;       // phase-A2 row segments per band column
constexpr int kSegRows = (kTY + kSegs - 1) / kSegs;   // 12
constexpr int kMaxHbs = 8;

template <int HBS>
struct Tile {
  static constexpr int HW = 2 * HBS;
  static constexpr int BR = kTY + HW;            // band rows
  static constexpr int BC = kTX + HW;            // band columns
  static constexpr int TC = kThreads / BC;       // phase-A1 threads per column
  static constexpr int NE = (BR + TC - 1) / TC;  // band rows per A1 thread
  static constexpr int VS = BC | 1;              // odd row stride of the sums
  static constexpr int NV = kSegRows + HW - 1;   // dsq one A2 thread reads
  static constexpr int NH = kP + HW - 1;         // sums one B thread reads
  static constexpr size_t kSmem = sizeof(float) * (4 * BR * BC + kTY * VS);
  static_assert(TC >= 1 && BC * kSegs <= kThreads, "tile too wide");
};

// A phase-B thread's 8 outputs: row y, columns xb .. xb + 7.
struct Pixels {
  int y, xb;
  bool row_out;          // y < H
  float inv_area[kP];
};

// The layout pass's scratch: channels 0-1 as float2 and channel 2 as float,
// (H, WLp) each, WLp >= max(WL, W + min_d + D), 3 * H * WLp floats in all.
inline bool layout_fits(long long H, long long W, long long WL, long long WLp,
                        long long min_d, long long D) {
  return WLp >= WL && WLp >= W + min_d + D && 3 * H * WLp < 2147483647LL;
}

}  // namespace wc

// The layout of the left image: channels 0-1 as float2 and channel 2 as
// float, (H, WLp) each, zero past column WL (where the cost reads 0), so a
// band pixel is one 8-byte and one 4-byte load. (static: every kernel
// source that includes this header launches its own copy.)
static __global__ void left_layout_kernel(const float* __restrict__ left,   // (H, WL, 3)
                                          float2* __restrict__ left_rg,
                                          float* __restrict__ left_b,
                                          int H, int WL, int WLp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * WLp) return;
  const int y = i / WLp, x = i % WLp;
  float2 rg = make_float2(0.0f, 0.0f);
  float b = 0.0f;
  if (x < WL) {
    const float* px = left + ((size_t)y * WL + x) * 3;
    rg = make_float2(px[0], px[1]);
    b = px[2];
  }
  left_rg[i] = rg;
  left_b[i] = b;
}

// The tile (blockIdx.x, blockIdx.y) of 64 x 48 outputs, all its planes,
// each handed to `sink`:
//   sink.begin(px)                      once, before the first plane;
//   sink.plane(px, j, d, h, n_valid)    plane j (d = min_d + j) for
//       j < j_end, in increasing j: h[p] the window sum (>= +0) of output
//       p; outputs p < n_valid have a candidate, the rest cost +inf;
//   sink.finish(px, j_end)              once, after the last plane.
// Every thread of the CTA must call it: it synchronises.
template <int HBS, class Sink>
__device__ __forceinline__ void window_cost_tile(const float2* __restrict__ left_rg,
                                                 const float* __restrict__ left_b,
                                                 const float* __restrict__ right,
                                                 int H, int W, int WL, int WLp,
                                                 int min_d, int D, int row0, int H_total,
                                                 Sink& sink) {
  using wc::kP;
  using wc::kSegRows;
  using wc::kSegs;
  using wc::kThreads;
  using wc::kTX;
  using wc::kTY;
  using T = wc::Tile<HBS>;
  extern __shared__ float smem[];
  float2* right_rg = reinterpret_cast<float2*>(smem);   // BR x BC
  float* right_b = smem + 2 * T::BR * T::BC;            // BR x BC
  float* dsq_s = right_b + T::BR * T::BC;               // BR x BC
  float* vs_s = dsq_s + T::BR * T::BC;                  // kTY x VS
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;

  // phase A1: band column c, band rows r1 + TC * k
  const bool a1 = tid < T::TC * T::BC;
  const int c1 = tid % T::BC;
  const int r1 = tid / T::BC;
  const int gx1 = x0 - HBS + c1;
  const bool col_in = a1 && gx1 >= 0 && gx1 < W - 1;
  // bit k: band row of slot k inside the local [0, H) and the global
  // [0, H_total - 1)
  unsigned row_in = 0;
#pragma unroll
  for (int k = 0; k < T::NE; ++k) {
    const int r = r1 + T::TC * k;
    const int gy = y0 - HBS + r;
    row_in |= (unsigned)(col_in && r < T::BR && gy >= 0 && gy < H && row0 + gy >= 0 &&
                         row0 + gy < H_total - 1) << k;
  }
  for (int i = tid; i < T::BR * T::BC; i += kThreads) {
    const int gy = y0 - HBS + i / T::BC;
    const int gx = x0 - HBS + i % T::BC;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float2 rg = make_float2(0.0f, 0.0f);
    float bl = 0.0f;
    if (in) {
      const float* px = right + ((size_t)gy * W + gx) * 3;
      rg = make_float2(px[0], px[1]);
      bl = px[2];
    }
    right_rg[i] = rg;
    right_b[i] = bl;
  }
  __syncthreads();
  const int lbase = (y0 - HBS + r1) * WLp + gx1;  // left offset of slot 0
  // the whole band inside the local rows, the global [0, H_total - 1) and
  // [0, W-1): no dsq is masked
  const bool interior = x0 >= HBS && x0 + kTX + HBS <= W - 1 && y0 >= HBS &&
                        y0 + kTY + HBS <= H && row0 + y0 >= HBS &&
                        row0 + y0 + kTY + HBS <= H_total - 1;

  // phase A2: band column c2, output rows seg * kSegRows ...
  const bool a2 = tid < T::BC * kSegs;
  const int c2 = tid % T::BC;
  const int seg = tid / T::BC;

  // phase B: output row ob, columns 8 * gb ... 8 * gb + 7; a warp covers
  // 8 rows x 4 groups
  const int warp = tid >> 5, lane = tid & 31;
  const int ob = (warp >> 1) * 8 + (lane >> 2);
  const int gb = (warp & 1) * 4 + (lane & 3);
  wc::Pixels px;
  px.y = y0 + ob;
  px.xb = x0 + kP * gb;
  px.row_out = px.y < H;
  // a window is empty only if the image is one pixel tall or wide, hbs is
  // 0 or the row lies outside the image; then every plane is +inf
  const int yg = row0 + px.y;
  const bool windows = HBS > 0 && H_total > 1 && W > 1 && yg >= 0 && yg < H_total;
  {
    const int up = max(min(yg, HBS), 0);
    const int down = max(min(H_total - 1 - yg, HBS), 0);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int x = px.xb + p;
      const int lft = min(x, HBS);
      const int rgt = min(W - 1 - x, HBS);
      const float area = (float)((lft + rgt) * (up + down));
      px.inv_area[p] = __fdiv_rn(1.0f, fmaxf(area, 1.0f));
    }
  }
  sink.begin(px);

  // x + min(W-1-x, hbs) never decreases with x, so no pixel of the tile has
  // a candidate at j_end or beyond
  const int reach0 = x0 + min(W - 1 - x0, HBS);
  const int j_end = max(0, min(D, WL - reach0 - min_d));
  for (int j = 0; j < j_end; ++j) {
    const int d = min_d + j;

    // A1: the masked dsq of the band
    // branch-free, so the compiler can put every load of the plane in
    // flight at once; masked rows load a valid address and store 0. The
    // left is zero-padded past WL, as the cost reads it. Where TC * NE > BR
    // the last slot of some threads lies below the band, and below the
    // image for a tile whose band ends at row H-2: it loads nothing there
    // on either path.
    auto a1_plane = [&](auto masked) {
#pragma unroll
      for (int k = 0; k < T::NE; ++k) {
        const int r = r1 + T::TC * k;
        const bool in = decltype(masked)::value ? ((row_in >> k) & 1u) != 0
                                                : (k < T::NE - 1 || r < T::BR);
        const int off = in ? lbase + T::TC * k * WLp + d : 0;
        const float2 lrg = __ldg(left_rg + off);
        const float lb = __ldg(left_b + off);
        const float2 rrg = right_rg[r * T::BC + c1];
        const float d0 = __fsub_rn(lrg.x, rrg.x);
        const float d1 = __fsub_rn(lrg.y, rrg.y);
        const float d2 = __fsub_rn(lb, right_b[r * T::BC + c1]);
        // 0 + d0^2 == d0^2 (a square is >= +0)
        const float v = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                  __fmul_rn(d2, d2));
        if (k < T::NE - 1 || r < T::BR) dsq_s[r * T::BC + c1] = in ? v : 0.0f;
      }
    };
    if (a1) {
      if (interior)
        a1_plane(std::false_type{});
      else
        a1_plane(std::true_type{});
    }
    __syncthreads();

    // A2: vertical sums from registers (0 + s == s for the first term:
    // the dsq are >= +0)
    if (a2) {
      float s[T::NV];
#pragma unroll
      for (int i = 0; i < T::NV; ++i) s[i] = dsq_s[(seg * kSegRows + i) * T::BC + c2];
#pragma unroll
      for (int o = 0; o < kSegRows; ++o) {
        float acc = 0.0f;
        if constexpr (T::HW > 0) {
          acc = s[o];
#pragma unroll
          for (int q = 1; q < T::HW; ++q) acc = __fadd_rn(acc, s[o + q]);
        }
        if (seg * kSegRows + o < kTY) vs_s[(seg * kSegRows + o) * T::VS + c2] = acc;
      }
    }
    __syncthreads();

    // B: horizontal sums, handed to the sink
    float v[T::NH];
#pragma unroll
    for (int i = 0; i < T::NH; ++i) v[i] = vs_s[ob * T::VS + kP * gb + i];
    // pixel p has a candidate iff min(W-1, x + hbs) < WL - d: a prefix of p
    const int n_valid = !windows ? 0
                        : W - 1 < WL - d ? kP
                                         : min(max(WL - d - px.xb - HBS, 0), kP);
    float hh[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      float h = 0.0f;
      if constexpr (T::HW > 0) {
        h = v[p];
#pragma unroll
        for (int q = 1; q < T::HW; ++q) h = __fadd_rn(h, v[p + q]);
      }
      hh[p] = fmaxf(h, 0.0f);
    }
    sink.plane(px, j, d, hh, n_valid);
  }
  sink.finish(px, j_end);
}

// The cost of window sum h at 1/area inv_area: sqrt(h) * inv_area.
__device__ __forceinline__ float window_cost(float h, float inv_area) {
  return __fmul_rn(__fsqrt_rn(h), inv_area);
}

// Launches a tile kernel of the routine over the (H, W) output on `stream`.
template <int HBS, class... Params, class... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), int H, int W, cudaStream_t stream,
                         Args... args) {
  constexpr size_t smem = wc::Tile<HBS>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + wc::kTX - 1) / wc::kTX, (H + wc::kTY - 1) / wc::kTY);
  kernel<<<grid, wc::kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Runs the left layout pass into `scratch` (3 * H * WLp floats, 8-byte
// aligned) and sets left_rg / left_b to its two parts.
static inline cudaError_t launch_left_layout(const float* left, float* scratch, int H, int WL,
                                      int WLp, cudaStream_t stream, float2** left_rg,
                                      float** left_b) {
  *left_rg = reinterpret_cast<float2*>(scratch);
  *left_b = scratch + 2 * (size_t)H * WLp;
  const int n = H * WLp;
  left_layout_kernel<<<(n + 255) / 256, 256, 0, stream>>>(left, *left_rg, *left_b, H,
                                                           WL, WLp);
  return cudaGetLastError();
}

// f.template run<HBS>() for the template instance of `hbs` (0..kMaxHbs).
template <class F>
cudaError_t dispatch_hbs(int hbs, F& f) {
  switch (hbs) {
    case 0: return f.template run<0>();
    case 1: return f.template run<1>();
    case 2: return f.template run<2>();
    case 3: return f.template run<3>();
    case 4: return f.template run<4>();
    case 5: return f.template run<5>();
    case 6: return f.template run<6>();
    case 7: return f.template run<7>();
    case 8: return f.template run<8>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stpu
