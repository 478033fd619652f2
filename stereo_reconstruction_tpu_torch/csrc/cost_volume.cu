// Launcher of K2 (kernel and design notes: cost_volume.cuh and
// window_cost.cuh), with a plain C interface for ctypes.

#include "cost_volume.cuh"

namespace {

struct Launch {
  const float2* left_rg;
  const float* left_b;
  const float* right;
  float* cost;
  int H, W, WL, WLp, min_d, D;
  cudaStream_t stream;

  template <int HBS>
  cudaError_t run() {
    return stpu::launch_tiles<HBS>(stpu::cost_volume_kernel<HBS>, H, W, stream,
                                   left_rg, left_b, right, cost, H, W, WL, WLp,
                                   min_d, D);
  }
};

}  // namespace

// Launches K2 on `stream`: the left image's layout pass into `scratch`,
// then the kernel. Returns the cudaError_t of the launches (0 = ok). All
// pointers are device pointers to contiguous float32 arrays: left
// (H, WL, 3), right (H, W, 3), cost (D, H, W) out (16-byte aligned),
// scratch 3 * H * WLp floats (8-byte aligned) with WLp >= max(WL, W + min_d
// + D). hbs must lie in [0, stpu_matcher_inputs_max_hbs()] and 3 * H * WLp
// below 2^31.
extern "C" int stpu_cost_volume(const float* left, const float* right, float* cost,
                                float* scratch, int H, int W, int WL, int WLp, int hbs,
                                int min_d, int D, void* stream) {
  if (H <= 0 || W <= 0 || WL <= 0 || min_d < 0 || D < 0 ||
      !stpu::wc::layout_fits(H, W, WL, WLp, min_d, D) || hbs < 0 ||
      hbs > stpu::wc::kMaxHbs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Launch l{nullptr, nullptr, right, cost, H, W, WL, WLp, min_d, D, s};
  float2* rg;
  float* b;
  const cudaError_t e = stpu::launch_left_layout(left, scratch, H, WL, WLp, s, &rg, &b);
  if (e != cudaSuccess) return (int)e;
  l.left_rg = rg;
  l.left_b = b;
  return (int)stpu::dispatch_hbs(hbs, l);
}
