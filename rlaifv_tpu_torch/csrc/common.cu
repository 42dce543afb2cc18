// Error text for the cudaError_t codes the entry points of this library
// return, so the Python wrappers can raise with a readable message.
#include <cuda_runtime.h>

extern "C" const char *rlaifv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
