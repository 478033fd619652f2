// The one error helper of the kernel library, with a plain C interface for
// ctypes: every launcher returns a cudaError_t, named here.

#include <cuda_runtime.h>

// The name of a cudaError_t that an entry point returned.
extern "C" const char* stpu_error_name(int err) { return cudaGetErrorString((cudaError_t)err); }
