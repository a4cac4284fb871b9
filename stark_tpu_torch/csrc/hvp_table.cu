// Kernel AB: q = H p by the gather table (stark_tpu/solver/assembly.py
// `hvp_table`, :239-249).
//
// JAX computes every element's q_e = H_e p_e, appends a zero row and sums
// q_pad[entry[i, k]] over k for each block i. Here thread (i, c) walks block
// i's table row in table order and, for each entry r < R (the flat row
// r = e * b + a of element e's slot a), forms component c of q_e's row a as
// the dot of H_e's row 3a + c with the element's gathered p (a dummy block,
// id n_blocks, reads zero) and adds it. Each flat row is in exactly one
// block's table, so every q_e row is formed once, in the thread that sums
// it: no q_e buffer and no second pass.
//
// Bound: bytes. The kept element rows of H are read once (3 x 3b values per
// table entry) with p (gathered, from L2) and the table; q is written once.
// One add per value read. Design: one thread per output value, sums in
// table order, no atomics, so the result is deterministic.
#include "stk_common.cuh"

template <typename T>
__global__ void hvp_table_kernel(const T* __restrict__ H, const int* __restrict__ conn, int b,
                                 const T* __restrict__ p, int n_blocks,
                                 const int* __restrict__ entry, int K, int R,
                                 T* __restrict__ q) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_blocks * 3) return;
  const int i = (int)(t / 3);
  const int c = (int)(t - (long long)i * 3);
  const int d = 3 * b;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int r = entry[(long long)i * K + k];
    if (r >= R) continue;
    const long long e = r / b;
    const int a = r - (int)(e * b);
    const T* row = H + (e * d + 3 * a + c) * d;
    const int* ce = conn + e * b;
    T v = T(0);
    for (int j = 0; j < d; ++j) {
      const int blk = ce[j / 3];
      const T pj = blk < n_blocks ? p[3 * blk + j % 3] : T(0);
      v += row[j] * pj;
    }
    acc += v;
  }
  q[t] = acc;
}

template <typename T>
static int launch_hvp_table(const T* H, const int* conn, int b, const T* p, int n_blocks,
                            const int* entry, int K, int R, T* q, cudaStream_t stream) {
  const long long n = (long long)n_blocks * 3;
  if (n == 0) return stk_launch_status();
  hvp_table_kernel<T><<<stk_blocks(n, 128), 128, 0, stream>>>(H, conn, b, p, n_blocks, entry,
                                                              K, R, q);
  return stk_launch_status();
}

STK_API int stk_hvp_table_f32(const float* H, const int* conn, int b, const float* p,
                              int n_blocks, const int* entry, int K, int R, float* q,
                              cudaStream_t stream) {
  return launch_hvp_table<float>(H, conn, b, p, n_blocks, entry, K, R, q, stream);
}

STK_API int stk_hvp_table_f64(const double* H, const int* conn, int b, const double* p,
                              int n_blocks, const int* entry, int K, int R, double* q,
                              cudaStream_t stream) {
  return launch_hvp_table<double>(H, conn, b, p, n_blocks, entry, K, R, q, stream);
}
