// Launchers of K1 and K2 (kernels and design notes: cost_volume.cuh), with
// a plain C interface for ctypes.

#include "cost_volume.cuh"

using stpu::kTileX;
using stpu::kTileY;
using stpu::kThreads;

namespace {

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int H, int W, int WL, int hbs, int min_d,
                    int D, size_t* smem, dim3* grid) {
  if (H <= 0 || W <= 0 || WL <= 0 || hbs < 0 || min_d < 0 || D < 0)
    return cudaErrorInvalidValue;
  *smem = stpu::cost_tile_smem(hbs);
  if (*smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return e;
  }
  *grid = dim3((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  return cudaSuccess;
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers to contiguous float32 / int32 arrays:
// left (H, WL, 3), right (H, W, 3), the five outputs (H, W).
extern "C" int stpu_matcher_inputs(const float* left, const float* right,
                                   float* m0, int* a0, float* cz, float* du,
                                   float* dl, int H, int W, int WL, int hbs,
                                   int min_d, int D, void* stream) {
  size_t smem;
  dim3 grid;
  const cudaError_t e = prepare(stpu::matcher_inputs_kernel, H, W, WL, hbs,
                                min_d, D, &smem, &grid);
  if (e != cudaSuccess) return (int)e;
  stpu::matcher_inputs_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      left, right, m0, a0, cz, du, dl, H, W, WL, hbs, min_d, D);
  return (int)cudaGetLastError();
}

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// left (H, WL, 3) and right (H, W, 3) float32 in, cost (D, H, W) float32
// out, all contiguous on the device.
extern "C" int stpu_cost_volume(const float* left, const float* right,
                                float* cost, int H, int W, int WL, int hbs,
                                int min_d, int D, void* stream) {
  size_t smem;
  dim3 grid;
  const cudaError_t e = prepare(stpu::cost_volume_kernel, H, W, WL, hbs,
                                min_d, D, &smem, &grid);
  if (e != cudaSuccess) return (int)e;
  stpu::cost_volume_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      left, right, cost, H, W, WL, hbs, min_d, D);
  return (int)cudaGetLastError();
}
