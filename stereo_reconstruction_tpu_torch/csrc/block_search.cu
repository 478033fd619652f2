// Launcher of K3 (kernel and design notes: block_search.cuh), with a plain
// C interface for ctypes.

#include "block_search.cuh"

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Device pointers to contiguous float32 arrays: left (H, WL, 3), right
// (H, W, 3), disp (H, W) out, and the scratch ring (2*hbs, D, TW), cst
// (D, TW), boundary (H,) and, float64, colsum (D, TW). sign is -1
// ("reference"), +1 ("intended") or 0 ("none").
extern "C" int stpu_block_search(const float* left, const float* right,
                                 float* disp, float* ring, float* cst,
                                 float* boundary, double* colsum, int H,
                                 int W, int WL, int hbs, int min_d, int D,
                                 int TW, float sf, int sign, int iters,
                                 void* stream) {
  if (H <= 0 || W <= 0 || WL <= 0 || hbs < 1 || min_d < 0 || D <= 0 ||
      TW <= 0 || TW > stpu::kSearchMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stpu::block_search_smem(TW, hbs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stpu::block_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (TW + 31) / 32 * 32;
  stpu::block_search_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      left, right, disp, ring, cst, boundary, colsum, H, W, WL, hbs, min_d, D,
      TW, sf, sign, iters);
  return (int)cudaGetLastError();
}
