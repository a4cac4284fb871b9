// Shared helpers of the stark_tpu_torch CUDA kernels.
//
// Every kernel is built with nvcc for sm_90a into one shared library with a
// plain C interface (loaded through ctypes by stark_tpu_torch/ops/build.py).
// Each entry point launches on the stream it is given (PyTorch's current
// stream), allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define STK_API extern "C" __attribute__((visibility("default")))

static inline int stk_blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

static inline int stk_launch_status() { return (int)cudaGetLastError(); }

// Round-to-nearest arithmetic that nvcc may not contract into FMAs. A kernel
// whose comparisons must decide as its plain twin decides (kernels F, G, H)
// evaluates them with these, in the twin's operation order.
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rn_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
