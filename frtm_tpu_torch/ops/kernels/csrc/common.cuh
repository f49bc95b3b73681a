// Shared by the port's kernels: a plain C interface (no PyTorch headers),
// so each source compiles with nvcc alone in seconds and is bound with
// ctypes. Every entry point selects the caller's device, launches on the
// caller's stream, and returns cudaGetLastError() (0 = launched).
#pragma once
#include <cuda_runtime.h>

#define FRTM_EXPORT extern "C" __attribute__((visibility("default")))

FRTM_EXPORT const char* frtm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
