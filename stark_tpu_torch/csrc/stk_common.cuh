// Shared helpers of the stark_tpu_torch CUDA kernels.
//
// Every kernel is built with nvcc for sm_90a into one shared library with a
// plain C interface (loaded through ctypes by stark_tpu_torch/ops/build.py).
// Each entry point launches on the stream it is given (PyTorch's current
// stream), allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define STK_HD __host__ __device__ __forceinline__
#else
// The element math of kernels M-W (egh_*.cu) also builds as plain C++17
// with g++ for the CPU tests; there these are ordinary inline functions.
#include <cmath>
#define STK_HD inline
using std::fmaf;
using std::fma;
using std::log;
using std::sqrt;
#endif

#define STK_API extern "C" __attribute__((visibility("default")))

#ifdef __CUDACC__
static inline int stk_blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

static inline int stk_launch_status() { return (int)cudaGetLastError(); }
#endif

// Round-to-nearest arithmetic that nvcc may not contract into FMAs. A kernel
// whose comparisons must decide as its plain twin decides (kernels F, G, H)
// evaluates them with these, in the twin's operation order. The host forms
// (g++ with -ffp-contract=off) round the same way.
#ifdef __CUDA_ARCH__
#define STK_RN(dev, host) return dev
#else
#define STK_RN(dev, host) return host
#endif
STK_HD float rn_mul(float a, float b) { STK_RN(__fmul_rn(a, b), a * b); }
STK_HD float rn_add(float a, float b) { STK_RN(__fadd_rn(a, b), a + b); }
STK_HD float rn_sub(float a, float b) { STK_RN(__fsub_rn(a, b), a - b); }
STK_HD float rn_fma(float a, float b, float c) {
  STK_RN(__fmaf_rn(a, b, c), fmaf(a, b, c));
}
STK_HD double rn_mul(double a, double b) { STK_RN(__dmul_rn(a, b), a * b); }
STK_HD double rn_add(double a, double b) { STK_RN(__dadd_rn(a, b), a + b); }
STK_HD double rn_sub(double a, double b) { STK_RN(__dsub_rn(a, b), a - b); }
STK_HD double rn_fma(double a, double b, double c) {
  STK_RN(__fma_rn(a, b, c), fma(a, b, c));
}
#undef STK_RN
