// Launcher of K4 (kernel and design notes: perceptual_scan.cuh), with a
// plain C interface for ctypes.

#include "perceptual_scan.cuh"

// Dynamic shared memory K4 takes for D candidates and chunks of `chunk`
// columns (chunk <= W), and the most a CTA may have; the Python wrapper
// reads both.
extern "C" long long stpu_perceptual_scan_smem_bytes(int D, int chunk) {
  return stpu::k4::smem_bytes(D, chunk);
}

extern "C" long long stpu_perceptual_scan_max_smem() { return stpu::k4::kMaxSmem; }

// Device scratch K4 takes for an (H, D, W) volume: its copy in (H, W, D)
// order, each pixel's run padded to 16 bytes.
extern "C" long long stpu_perceptual_scan_scratch_bytes(int H, int D, int W) {
  return stpu::k4::scratch_bytes(H, D, W);
}

// Launches K4 on `stream`, the layout pass then the scan; returns the
// cudaError_t of the launches (0 = ok). `cost` is a contiguous (H, D, W)
// float32 device array, `table` D + 1 float32 weights, `cols`
// stpu_perceptual_scan_scratch_bytes of 16-byte aligned device scratch and
// `out` a contiguous (H, W) float32 device array.
extern "C" int stpu_perceptual_scan(const float* cost, const float* table, float* cols,
                                    float* out, int H, int D, int W, int chunk, void* stream) {
  using namespace stpu::k4;
  if (H <= 0 || D <= 0 || W <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  chunk = chunk < W ? chunk : W;
  const long long smem = smem_bytes(D, chunk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int S = stages(D, chunk);
  void (*kernel)(const float*, const float*, float*, int, int, int, int, int) =
      S > 0 ? stpu::perceptual_scan_kernel<true> : stpu::perceptual_scan_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = (chunk + kPerWarp - 1) / kPerWarp < 32 ? (chunk + kPerWarp - 1) / kPerWarp
                                                           : 32;
  const dim3 tiles((W + 31) / 32, (D + 31) / 32, H < 65535 ? H : 65535);
  stpu::perceptual_layout_kernel<<<tiles, dim3(32, 8), 0, (cudaStream_t)stream>>>(cost, cols,
                                                                                  H, D, W);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = (W + chunk - 1) / chunk;
  kernel<<<blocks, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(cols, table, out, H, D,
                                                                      W, chunk, S);
  return (int)cudaGetLastError();
}
