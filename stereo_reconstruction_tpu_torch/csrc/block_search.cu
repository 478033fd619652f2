// Launcher of K3 (kernels and design notes: block_search.cuh and
// window_cost.cuh), with a plain C interface for ctypes.

#include "block_search.cuh"

namespace {

struct Launch {
  const float2* left_rg;
  const float* left_b;
  const float* right;
  float* cost;
  float* top_v;
  int* top_i;
  int H, W, WL, WLp, min_d, D;
  cudaStream_t stream;

  template <int HBS>
  cudaError_t run() {
    return stpu::launch_tiles<HBS>(stpu::block_search_costs_kernel<HBS>, H, W, stream,
                                   left_rg, left_b, right, cost, top_v, top_i, H, W, WL,
                                   WLp, min_d, D);
  }
};

}  // namespace

// Launches K3 on `stream`: the left image's layout pass into `layout`, the
// cost pass and the row chain. Returns the cudaError_t of the launches
// (0 = ok). Device pointers to contiguous float32 arrays: left (H, WL, 3),
// right (H, W, 3), disp (H, W) out, and the scratch: cost (D, H, W),
// 16-byte aligned; top (6, H, W): three costs, then three int32 indices;
// layout 3 * H * WLp floats (8-byte aligned) with WLp >= max(WL, W + min_d
// + D); rows 8 * W + ceil(W / TW) floats. hbs must lie in
// [1, stpu_matcher_inputs_max_hbs()], D in [1, 0xffff] and 3 * H * WLp
// below 2^31. sign is -1 ("reference"), +1 ("intended") or 0 ("none").
extern "C" int stpu_block_search(const float* left, const float* right, float* disp,
                                 float* cost, float* top, float* layout, float* rows,
                                 int H, int W, int WL, int WLp, int hbs, int min_d,
                                 int D, int TW, float sf, int sign, int iters,
                                 void* stream) {
  if (H <= 0 || W <= 0 || WL <= 0 || min_d < 0 || D <= 0 || D > stpu::kNoPlane ||
      !stpu::wc::layout_fits(H, W, WL, WLp, min_d, D) || hbs < 1 ||
      hbs > stpu::wc::kMaxHbs || TW <= 0 || sign < -1 || sign > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* top_v = top;
  int* top_i = reinterpret_cast<int*>(top + 3 * (size_t)H * W);
  Launch l{nullptr, nullptr, right, cost, top_v, top_i, H, W, WL, WLp, min_d, D, s};
  float2* rg;
  float* b;
  cudaError_t e = stpu::launch_left_layout(left, layout, H, WL, WLp, s, &rg, &b);
  if (e != cudaSuccess) return (int)e;
  l.left_rg = rg;
  l.left_b = b;
  e = stpu::dispatch_hbs(hbs, l);
  if (e != cudaSuccess) return (int)e;
  const stpu::Rows r{cost, H, W, D, min_d, TW, sf, sign};
  const int threads = W < stpu::kRowThreads ? (W + 31) / 32 * 32 : stpu::kRowThreads;
  stpu::block_search_rows_kernel<<<1, threads, 0, s>>>(r, top_v, top_i, right, disp,
                                                       rows, iters);
  return (int)cudaGetLastError();
}
