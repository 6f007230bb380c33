// Error text for the codes the kernel entries return (cudaError_t values).
#include "common.cuh"

extern "C" const char* leoam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
