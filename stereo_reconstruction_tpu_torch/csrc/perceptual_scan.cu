// Launcher of K4 (kernel and design notes: perceptual_scan.cuh), with a
// plain C interface for ctypes.

#include "perceptual_scan.cuh"

// Dynamic shared memory K4 needs for D candidates and chunks of `chunk`
// columns, and the most a CTA may have; the Python wrapper reads both.
extern "C" long long stpu_perceptual_scan_smem_bytes(int D, int chunk) {
  return stpu::k4::smem_bytes(D, chunk);
}

extern "C" long long stpu_perceptual_scan_max_smem() { return stpu::k4::kMaxSmem; }

// Launches K4 on `stream`; returns the cudaError_t of the launch (0 = ok).
// `cost` is a contiguous (H, D, W) float32 device array, `table` D + 1
// float32 weights, `out` a contiguous (H, W) float32 device array.
extern "C" int stpu_perceptual_scan(const float* cost, const float* table, float* out,
                                    int H, int D, int W, int chunk, void* stream) {
  if (H <= 0 || D <= 0 || W <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const long long smem = stpu::k4::smem_bytes(D, chunk);
  if (smem > stpu::k4::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stpu::perceptual_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (W + chunk - 1) / chunk;
  stpu::perceptual_scan_kernel<<<blocks, 32, (size_t)smem, (cudaStream_t)stream>>>(
      cost, table, out, H, D, W, chunk);
  return (int)cudaGetLastError();
}
