// Launcher of K1b (kernel and design notes: row_scan.cuh), with a plain C
// interface for ctypes.

#include "row_scan.cuh"

namespace {

// One cluster: `strips` warps spread over at most kMaxCluster CTAs of at
// most kMaxWarps warps each, as few warps a CTA as that allows.
template <bool kSeeded>
cudaError_t launch(const float* m0, const int* a0, const float* cz,
                   const float* du, const float* dl, const unsigned char* black,
                   const unsigned char* first, const float* init_prev, float* out,
                   int H, int W, float sf, int d_first, int D, cudaStream_t stream) {
  using namespace stpu::k1b;
  const int strips = (W + kStripCols - 1) / kStripCols;
  const int warps = (strips + kMaxCluster - 1) / kMaxCluster;
  const int ctas = (strips + warps - 1) / warps;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(32 * warps);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, stpu::row_scan_kernel<kSeeded>, m0, a0, cz, du, dl, black, first,
      init_prev, out, H, W, sf, d_first, D, strips);
  const cudaError_t last = cudaGetLastError();      // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

}  // namespace

// The widest row K1b takes (8192: 8 CTAs x 16 strips x 64 columns); the
// Python wrapper reads it from here.
extern "C" int stpu_row_scan_max_width() { return stpu::k1b::kMaxWidth; }

// The name of a cudaError_t that stpu_row_scan returned.
extern "C" const char* stpu_row_scan_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches K1b on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers to contiguous (H, W) arrays: float32
// m0, c_zero, diag_up, diag_lf and out, int32 a0, uint8 black; `first`
// (H,) uint8 flags the rows with no up neighbour and `init_prev` (W,)
// float32 is row 0's up neighbour where its flag is clear; either may be
// null (row 0 alone first, seed 0). W must lie in [1,
// stpu_row_scan_max_width()].
extern "C" int stpu_row_scan(const float* m0, const int* a0, const float* cz,
                             const float* du, const float* dl,
                             const unsigned char* black, const unsigned char* first,
                             const float* init_prev, float* out, int H, int W,
                             float sf, int d_first, int D, void* stream) {
  if (H <= 0 || W <= 0 || W > stpu_row_scan_max_width() || D <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (first != nullptr || init_prev != nullptr)
    return (int)launch<true>(m0, a0, cz, du, dl, black, first, init_prev, out, H, W, sf,
                             d_first, D, s);
  return (int)launch<false>(m0, a0, cz, du, dl, black, first, init_prev, out, H, W, sf,
                            d_first, D, s);
}
