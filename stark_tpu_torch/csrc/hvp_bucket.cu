// Kernel B: the CG Hessian-vector product q = H p, fused gather + element
// matvec + ordered per-block reduce.
//
// Replaces stark_tpu/solver/assembly.py `hvp_bucket` (:559-572) with its
// `_scatter_q` one-hot matmul (:514-522): there p is gathered to an (E, 3b)
// array, multiplied by the (E, 3b, 3b) element Hessians and the (E*b, 3)
// products scattered to blocks.
//
// Here thread (j, i) computes component i of block j directly: it walks the
// CSR entries (e, a) with conn[e, a] == j (the same CSR as kernel A's
// diag_bucket site, in stable row order) and accumulates the dot product of
// row 3a+i of H_e with p gathered at conn[e, :]. A column whose conn is the
// dummy block (>= n_blocks) is skipped, which is exactly the product with
// p_pad's zero dummy row (assembly.py:563). No (E, 3b) intermediate is
// stored and the sum order is fixed, so q is deterministic.
//
// Bound: bytes. Each H_e row slice is read by exactly one thread, and only
// the rows and columns of non-dummy entries are read: sum_e 9*n_e^2 values
// for an element with n_e real blocks (~9.8 MB in f32 for the 64x64 cloth,
// against 14.2 MB for the whole padded bucket), plus conn, the CSR and p,
// and 2 flops per value read. Design: one thread per
// output component keeps the reduction ordered without atomics; the reads of
// one H row are contiguous per thread but not across a warp, so this simple
// form runs well under the bandwidth bound. Coalescing it (a warp per block,
// lanes across the row) is later work.
#include "stk_common.cuh"

template <typename T>
__global__ void hvp_bucket_kernel(const T* __restrict__ H,
                                  const int* __restrict__ conn, int b,
                                  const T* __restrict__ p, int n_blocks,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ offsets,
                                  T* __restrict__ q) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3LL * n_blocks) return;
  int j = (int)(t / 3);
  int i = (int)(t - 3LL * j);
  int d = 3 * b;
  T acc = T(0);
  for (int k = offsets[j]; k < offsets[j + 1]; ++k) {
    int flat = perm[k];
    int e = flat / b;
    int a = flat - e * b;
    const T* row = H + ((long long)e * d + 3 * a + i) * d;
    const int* ce = conn + (long long)e * b;
    for (int c = 0; c < b; ++c) {
      int node = ce[c];
      if (node >= n_blocks) continue;
      const T* pn = p + 3LL * node;
      acc += row[3 * c] * pn[0];
      acc += row[3 * c + 1] * pn[1];
      acc += row[3 * c + 2] * pn[2];
    }
  }
  q[t] = acc;
}

template <typename T>
static int launch_hvp_bucket(const T* H, const int* conn, int b, const T* p,
                             int n_blocks, const int* perm, const int* offsets,
                             T* q, cudaStream_t stream) {
  long long n = 3LL * n_blocks;
  if (n == 0) return stk_launch_status();
  const int threads = 128;
  hvp_bucket_kernel<T><<<stk_blocks(n, threads), threads, 0, stream>>>(
      H, conn, b, p, n_blocks, perm, offsets, q);
  return stk_launch_status();
}

STK_API int stk_hvp_bucket_f32(const float* H, const int* conn, int b,
                               const float* p, int n_blocks, const int* perm,
                               const int* offsets, float* q,
                               cudaStream_t stream) {
  return launch_hvp_bucket<float>(H, conn, b, p, n_blocks, perm, offsets, q,
                                  stream);
}

STK_API int stk_hvp_bucket_f64(const double* H, const int* conn, int b,
                               const double* p, int n_blocks, const int* perm,
                               const int* offsets, double* q,
                               cudaStream_t stream) {
  return launch_hvp_bucket<double>(H, conn, b, p, n_blocks, perm, offsets, q,
                                   stream);
}
