// Kernel A: ordered segmented sum of an (R, W) payload by row id.
//
// Replaces stark_tpu/solver/assembly.py `_scatter_rows_payload` (:50-61, the
// one-hot MXU matmul / segment_sum that reduces energy_grad_hess's (R, 9)
// [g, g^2, |H| row sum] payload per block), the segment_sum of `diag_bucket`
// (:574-589) and the scatter-add of `assemble_dense_scatter` (:696-719),
// keyed there by block-pair id. DirectLLT's dense matrix (the direct site)
// has an entry point of its own, at the end of this file.
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

// Kernel A's direct site: DirectLLT's dense (3n, 3n) Hessian (stark_tpu
// solver/newton.py `_direct_stage`, :194-203), written straight into JAX's
// block-major layout (row 3i + r is component r of block i).
//
// Input: the (R, 9) payload of every element's 3x3 block pairs in JAX's
// scatter order, and a stable sort of their pair keys i * n + j (`key`
// sorted, `perm` the payload rows in that order; a dropped pair is keyed
// n * n and sorts last). The entry point zero-fills `out` on the stream
// (cudaMemsetAsync, at the memory's rate), then launches: thread k looks at sorted position k; if it starts a run (k == 0 or
// key[k-1] != key[k]) and the run's key is kept, it sums the run's payload
// rows IN SORTED ORDER, from 0, for all 9 components, and writes them to
// rows 3i..3i+2, columns 3j..3j+2. The stable sort keeps JAX's order inside
// each pair, as the CSR of the segmented sum did, so each entry adds the
// same terms in the same order: the matrix equals the CSR-and-permute one
// bit for bit. No atomics, no CSR over the n^2 pairs, no permute copy.
//
// Bound: bytes. The fill writes 9 n^2 values; the kernel reads the payload
// (9 values per row, a row's 36 or 72 contiguous bytes in one thread) and
// the keys and the permutation once. One add per payload value.
template <typename T>
__global__ void direct_dense_kernel(const T* __restrict__ payload,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ key, int R, int n,
                                    T* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= R) return;
  const int kk = key[k];
  if ((long long)kk >= (long long)n * n || kk < 0) return;
  if (k > 0 && key[k - 1] == kk) return;
  // the run's end first (its keys share cache lines), so that the sum's
  // loop has a known trip count and its unrolled loads issue together
  long long end = k + 1;
  while (end < R && key[end] == kk) ++end;
  T acc[9];
#pragma unroll
  for (int w = 0; w < 9; ++w) acc[w] = T(0);
#pragma unroll 4
  for (long long m = k; m < end; ++m) {
    const T* row = payload + (long long)perm[m] * 9;
#pragma unroll
    for (int w = 0; w < 9; ++w) acc[w] += row[w];
  }
  const int i = kk / n;
  const int j = kk - i * n;
  const long long ld = 3LL * n;
  T* dst = out + 3LL * i * ld + 3LL * j;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) dst[r * ld + c] = acc[3 * r + c];
  }
}

template <typename T>
static int launch_direct_dense(const T* payload, const int* perm, const int* key,
                               int R, int n, T* out, cudaStream_t stream) {
  const size_t bytes = (size_t)9 * n * n * sizeof(T);
  if (bytes > 0) cudaMemsetAsync(out, 0, bytes, stream);
  if (R == 0) return stk_launch_status();
  const int threads = 256;
  direct_dense_kernel<T><<<stk_blocks(R, threads), threads, 0, stream>>>(
      payload, perm, key, R, n, out);
  return stk_launch_status();
}

STK_API int stk_direct_dense_f32(const float* payload, const int* perm,
                                 const int* key, int R, int n, float* out,
                                 cudaStream_t stream) {
  return launch_direct_dense<float>(payload, perm, key, R, n, out, stream);
}

STK_API int stk_direct_dense_f64(const double* payload, const int* perm,
                                 const int* key, int R, int n, double* out,
                                 cudaStream_t stream) {
  return launch_direct_dense<double>(payload, perm, key, R, n, out, stream);
}
