// Shared C entry points of the kernel library (built by ops/common.py).
#include <cuda_runtime.h>

extern "C" const char* byol_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
