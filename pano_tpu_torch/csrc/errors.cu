// Error text for the codes the kernel entry points return.
#include "common.cuh"

PANO_API const char* pano_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
