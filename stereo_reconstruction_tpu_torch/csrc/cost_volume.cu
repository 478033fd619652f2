// Launcher of K2 (kernel and design notes: cost_volume.cuh), with a plain C
// interface for ctypes.

#include "cost_volume.cuh"

using stpu::kThreads;
using stpu::kTileX;
using stpu::kTileY;

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// left (H, WL, 3) and right (H, W, 3) float32 in, cost (D, H, W) float32
// out, all contiguous on the device.
extern "C" int stpu_cost_volume(const float* left, const float* right,
                                float* cost, int H, int W, int WL, int hbs,
                                int min_d, int D, void* stream) {
  if (H <= 0 || W <= 0 || WL <= 0 || hbs < 0 || min_d < 0 || D < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stpu::cost_tile_smem(hbs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stpu::cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  stpu::cost_volume_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      left, right, cost, H, W, WL, hbs, min_d, D);
  return (int)cudaGetLastError();
}
