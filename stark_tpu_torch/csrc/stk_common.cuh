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
