// Launcher of K1 (kernel and design notes: matcher_inputs.cuh and
// window_cost.cuh), with a plain C interface for ctypes.

#include "matcher_inputs.cuh"

namespace {

struct Launch {
  const float2* left_rg;
  const float* left_b;
  const float* right;
  float* m0;
  int* a0;
  float *cz, *du, *dl;
  int H, W, WL, WLp, min_d, D;
  cudaStream_t stream;

  template <int HBS>
  cudaError_t run() {
    return stpu::launch_tiles<HBS>(stpu::matcher_inputs_kernel<HBS>, H, W, stream,
                                   left_rg, left_b, right, m0, a0, cz, du, dl, H, W,
                                   WL, WLp, min_d, D);
  }
};

}  // namespace

// The largest half block the window-cost routine takes (block sizes up to
// 2 * 8 + 1 = 17) for K1, K2 and K3; the Python wrappers read it from here.
extern "C" int stpu_matcher_inputs_max_hbs() { return stpu::wc::kMaxHbs; }

// Launches K1 on `stream`: the left image's layout pass into `scratch`,
// then the kernel. Returns the cudaError_t of the launches (0 = ok). All
// pointers are device pointers to contiguous float32 / int32 arrays: left
// (H, WL, 3), right (H, W, 3), the five outputs (H, W), scratch 3 * H * WLp
// floats (8-byte aligned) with WLp >= max(WL, W + min_d + D). hbs must lie
// in [0, stpu_matcher_inputs_max_hbs()] and 3 * H * WLp below 2^31.
extern "C" int stpu_matcher_inputs(const float* left, const float* right,
                                   float* m0, int* a0, float* cz, float* du,
                                   float* dl, float* scratch, int H, int W,
                                   int WL, int WLp, int hbs, int min_d, int D,
                                   void* stream) {
  if (H <= 0 || W <= 0 || WL <= 0 || min_d < 0 || D < 0 ||
      !stpu::wc::layout_fits(H, W, WL, WLp, min_d, D) || hbs < 0 ||
      hbs > stpu::wc::kMaxHbs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Launch l{nullptr, nullptr, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s};
  float2* rg;
  float* b;
  const cudaError_t e = stpu::launch_left_layout(left, scratch, H, WL, WLp, s, &rg, &b);
  if (e != cudaSuccess) return (int)e;
  l.left_rg = rg;
  l.left_b = b;
  return (int)stpu::dispatch_hbs(hbs, l);
}
