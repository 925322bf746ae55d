// Error names for the Python wrappers' messages.
#include "common.cuh"

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
