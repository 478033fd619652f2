// Launcher of K1b (kernel and design notes: row_scan.cuh), with a plain C
// interface for ctypes.

#include "row_scan.cuh"

namespace {

template <int K>
cudaError_t launch(const float* m0, const int* a0, const float* cz,
                   const float* du, const float* dl, const unsigned char* black,
                   float* out, int H, int W, float sf, int d_first, int D,
                   cudaStream_t stream) {
  const int threads = ((W + K - 1) / K + 31) / 32 * 32;
  stpu::row_scan_kernel<K><<<1, threads, 0, stream>>>(m0, a0, cz, du, dl, black, out,
                                                       H, W, sf, d_first, D);
  return cudaGetLastError();
}

}  // namespace

// The widest row K1b takes (4096); the Python wrapper reads it from here.
extern "C" int stpu_row_scan_max_width() {
  return stpu::k1b::kMaxThreads * stpu::k1b::kMaxCols;
}

// Launches K1b on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers to contiguous (H, W) arrays: float32
// m0, c_zero, diag_up, diag_lf and out, int32 a0, uint8 black. W must lie
// in [1, stpu_row_scan_max_width()].
extern "C" int stpu_row_scan(const float* m0, const int* a0, const float* cz,
                             const float* du, const float* dl,
                             const unsigned char* black, float* out, int H,
                             int W, float sf, int d_first, int D, void* stream) {
  using stpu::k1b::kMaxThreads;
  if (H <= 0 || W <= 0 || W > stpu_row_scan_max_width() || D <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((W + kMaxThreads - 1) / kMaxThreads) {
    case 1: return (int)launch<1>(m0, a0, cz, du, dl, black, out, H, W, sf, d_first, D, s);
    case 2: return (int)launch<2>(m0, a0, cz, du, dl, black, out, H, W, sf, d_first, D, s);
    case 3: return (int)launch<3>(m0, a0, cz, du, dl, black, out, H, W, sf, d_first, D, s);
    default: return (int)launch<4>(m0, a0, cz, du, dl, black, out, H, W, sf, d_first, D, s);
  }
}
