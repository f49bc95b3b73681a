// Shared by the port's kernels: a plain C interface (no PyTorch headers),
// so each source compiles with nvcc alone in seconds and is bound with
// ctypes. Every entry point selects the caller's device, launches on the
// caller's stream, and returns cudaGetLastError() (0 = launched).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FRTM_EXPORT extern "C" __attribute__((visibility("default")))

FRTM_EXPORT const char* frtm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Asynchronous global -> shared copies of 4 or 8 bytes (sm_80+), both
// addresses aligned to the copy's size; with src_bytes = 0 nothing is read
// and `dst` is zero-filled. 4 bytes is the least cp.async moves: one float or
// two bfloat16 values.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes = 8) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// An element of either working type as float, and back (bfloat16 rounds to
// nearest even, as torch's `.to(torch.bfloat16)` does).
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
