// Launcher of K1 (kernel and design notes: matcher_inputs.cuh), with a
// plain C interface for ctypes.

#include <climits>

#include "matcher_inputs.cuh"

namespace {

template <int HBS>
cudaError_t launch(const float2* left_rg, const float* left_b, const float* right,
                   float* m0, int* a0, float* cz, float* du, float* dl, int H,
                   int W, int WL, int WLp, int min_d, int D, cudaStream_t stream) {
  using stpu::k1::kThreads;
  using stpu::k1::kTX;
  using stpu::k1::kTY;
  constexpr size_t smem = stpu::k1::Tile<HBS>::kSmem;
  auto kernel = stpu::matcher_inputs_kernel<HBS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY);
  kernel<<<grid, kThreads, smem, stream>>>(left_rg, left_b, right, m0, a0, cz, du,
                                           dl, H, W, WL, WLp, min_d, D);
  return cudaGetLastError();
}

}  // namespace

// The largest half block K1 takes (block sizes up to 2 * 8 + 1 = 17); the
// Python wrapper reads it from here.
extern "C" int stpu_matcher_inputs_max_hbs() { return stpu::k1::kMaxHbs; }

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
  if (H <= 0 || W <= 0 || WL <= 0 || min_d < 0 || D < 0 || WLp < WL ||
      WLp < (long long)W + min_d + D || 3LL * H * WLp >= INT_MAX ||
      hbs < 0 || hbs > stpu::k1::kMaxHbs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float2* rg = reinterpret_cast<float2*>(scratch);
  float* b = scratch + 2 * (size_t)H * WLp;
  const int n = H * WLp;
  stpu::left_layout_kernel<<<(n + 255) / 256, 256, 0, s>>>(left, rg, b, H, WL, WLp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (hbs) {
    case 0: return (int)launch<0>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 1: return (int)launch<1>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 2: return (int)launch<2>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 3: return (int)launch<3>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 4: return (int)launch<4>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 5: return (int)launch<5>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 6: return (int)launch<6>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 7: return (int)launch<7>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    case 8: return (int)launch<8>(rg, b, right, m0, a0, cz, du, dl, H, W, WL, WLp, min_d, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
