// Kernel A: ordered segmented sum of an (R, W) payload by row id.
//
// Replaces stark_tpu/solver/assembly.py `_scatter_rows_payload` (:50-61, the
// one-hot MXU matmul / segment_sum that reduces energy_grad_hess's (R, 9)
// [g, g^2, |H| row sum] payload per block), the segment_sum of `diag_bucket`
// (:574-589) and the scatter-add of `assemble_dense_scatter` (:696-719),
// keyed there by block-pair id.
//
// Input is a CSR (ops/segment_reduce.py build_csr): `perm` lists the payload
// rows in a stable sort of their row ids (rows with id >= n_seg come last,
// past offsets[n_seg], and are dropped) and `offsets[s]..offsets[s+1]` is
// segment s. Thread
// (s, w) sums payload[perm[k], w] over its segment IN CSR ORDER, from 0, so
// the result is deterministic (no atomics: CUDA's index_add_ is not) and an
// empty segment gives 0.
//
// Bound: bytes. Each launch reads the kept payload rows once (K*W values for
// the K = offsets[n_seg] rows the CSR keeps; dropped rows are never read), the CSR
// once, and writes n_seg*W values; it does one add per value read.
// Design: one thread per output value keeps the loop trivially ordered;
// neighbouring threads read neighbouring columns of the same payload row, so
// a warp's loads fall on few cache lines when W is 9. Making the row reads
// fully coalesced (a warp per segment, shuffles to reduce) is later work.
#include "stk_common.cuh"

template <typename T>
__global__ void segment_reduce_kernel(const T* __restrict__ payload, int width,
                                      const int* __restrict__ perm,
                                      const int* __restrict__ offsets,
                                      int n_seg, T* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_seg * width) return;
  int s = (int)(t / width);
  int w = (int)(t - (long long)s * width);
  int k0 = offsets[s];
  int k1 = offsets[s + 1];
  T acc = T(0);
  for (int k = k0; k < k1; ++k) {
    acc += payload[(long long)perm[k] * width + w];
  }
  out[t] = acc;
}

template <typename T>
static int launch_segment_reduce(const T* payload, int width, const int* perm,
                                 const int* offsets, int n_seg, T* out,
                                 cudaStream_t stream) {
  long long n = (long long)n_seg * width;
  if (n == 0) return stk_launch_status();
  const int threads = 256;
  segment_reduce_kernel<T><<<stk_blocks(n, threads), threads, 0, stream>>>(
      payload, width, perm, offsets, n_seg, out);
  return stk_launch_status();
}

STK_API int stk_segment_reduce_f32(const float* payload, int width,
                                   const int* perm, const int* offsets,
                                   int n_seg, float* out, cudaStream_t stream) {
  return launch_segment_reduce<float>(payload, width, perm, offsets, n_seg, out,
                                      stream);
}

STK_API int stk_segment_reduce_f64(const double* payload, int width,
                                   const int* perm, const int* offsets,
                                   int n_seg, double* out,
                                   cudaStream_t stream) {
  return launch_segment_reduce<double>(payload, width, perm, offsets, n_seg,
                                       out, stream);
}
