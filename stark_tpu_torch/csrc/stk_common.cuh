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

// Kernel E's two-level exclusive scan (compact.cu), which kernels F, I and
// K run over their long count arrays: a block per STK_SCAN_CHUNK counts,
// whose sums go to `partials`, stk_scan_partials(m) ints for m counts.
#define STK_SCAN_CHUNK 4096
static inline long long stk_scan_partials(long long m) { return m / STK_SCAN_CHUNK + 1; }
#ifdef __CUDACC__
int stk_exclusive_scan_i32_blocks(const int* counts, long long m, int* offsets, int* total,
                                  int* partials, cudaStream_t stream);
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

// The allowed-mask reads of the dense pair grids (kernels F and I).

// bit k set where byte k of w is nonzero (k = 0..3)
STK_HD uint32_t nz4(uint32_t w) {
  uint32_t x = w | (w >> 4);
  x |= x >> 2;
  x |= x >> 1;
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// bit k set where allowed[base + k] != 0, for k < valid (<= 16); total is
// the mask's length. One 16-byte-aligned pair of vector loads on the card.
STK_HD uint32_t lane_mask16(const uint8_t* allowed, long long total, long long base,
                            int valid) {
  if (valid <= 0) return 0u;
  if (valid > 16) valid = 16;
  uint32_t m = 0u;
  bool done = false;
#ifdef __CUDA_ARCH__
  const uint8_t* at = allowed + base;
  const int a = (int)((uintptr_t)at & 15);
  const uint8_t* p = at - a;
  if (p >= allowed && p + 32 <= allowed + total) {
    const uint4 c0 = *reinterpret_cast<const uint4*>(p);
    const uint4 c1 = *reinterpret_cast<const uint4*>(p + 16);
    const uint32_t lo = nz4(c0.x) | nz4(c0.y) << 4 | nz4(c0.z) << 8 | nz4(c0.w) << 12;
    const uint32_t hi = nz4(c1.x) | nz4(c1.y) << 4 | nz4(c1.z) << 8 | nz4(c1.w) << 12;
    m = ((lo | hi << 16) >> a) & 0xFFFFu;
    done = true;
  }
#endif
  if (!done)
    for (int k = 0; k < valid; ++k)
      if (base + k < total && allowed[base + k] != 0) m |= 1u << k;
  return valid < 16 ? m & ((1u << valid) - 1u) : m;
}

// the set bits of a word
STK_HD int stk_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// the place of bit b among the set bits of w (the set bits below it): where
// an emit from bit words (kernels F and L) writes bit b of a word
STK_HD int stk_rank(uint32_t w, int b) { return stk_popc(w & ((1u << b) - 1u)); }
