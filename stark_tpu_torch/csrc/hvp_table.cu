// Kernel AB: q = H p by the gather table (stark_tpu/solver/assembly.py
// `hvp_table`, :239-249).
//
// JAX computes every element's q_e = H_e p_e, appends a zero row and sums
// q_pad[entry[i, k]] over k for each block i. Here one warp owns block i's
// table row: lane l takes the entries k = l, l + 32, ... and stops at its
// first pad (r >= R; the valid entries of a row are a prefix, kernel AA's
// table), so pads cost one load per lane at most. For an entry r (the flat
// row r = e * b + a of element e's slot a) the lane gathers the element's p
// once (b blocks; a dummy block, id n_blocks, reads zero) and forms the 3
// components of q_e's row a from H_e's rows 3a..3a+2, 3 x 3b contiguous
// values. Each flat row is in exactly one block's table, so every q_e row
// is formed once, in the warp that sums it: no q_e buffer, no second pass.
// The lanes' partial sums meet in a fixed xor-shuffle tree and lane 0
// writes q[i]: a fixed assignment and a fixed tree give the same bits on
// every launch (no atomics). The sum order differs from the twin's.
//
// Bound: bytes. The kept element rows of H are read once (3 x 3b values per
// table entry) with p (gathered, from L2) and the table; q is written once.
// Two flops per H value read. Design: a warp per block row keeps 32 of the
// row's entries in flight at once and reads no slot past the first pad
// (3 lanes per entry, one H row each, measured slower on an H100).
#include "stk_common.cuh"

constexpr int kHvpTableWarps = 8;

template <typename T>
__global__ void hvp_table_kernel(const T* __restrict__ H, const int* __restrict__ conn, int b,
                                 const T* __restrict__ p, int n_blocks,
                                 const int* __restrict__ entry, int K, int R,
                                 T* __restrict__ q) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kHvpTableWarps + (threadIdx.x >> 5);
  if (i >= n_blocks) return;  // warp-uniform
  const int d = 3 * b;
  const int* row = entry + i * K;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  for (int k = lane; k < K; k += 32) {
    const int r = row[k];
    if (r >= R) break;
    const long long e = r / b;
    const int a = r - (int)(e * b);
    const int* ce = conn + e * b;
    const T* h = H + (e * d + 3 * a) * d;
    T v0 = T(0), v1 = T(0), v2 = T(0);
    for (int s = 0; s < b; ++s) {
      const int blk = ce[s];
      const bool real = blk < n_blocks;
      const T p0 = real ? p[3 * blk] : T(0);
      const T p1 = real ? p[3 * blk + 1] : T(0);
      const T p2 = real ? p[3 * blk + 2] : T(0);
      const T* h0 = h + 3 * s;
      v0 += h0[0] * p0 + h0[1] * p1 + h0[2] * p2;
      v1 += h0[d] * p0 + h0[d + 1] * p1 + h0[d + 2] * p2;
      v2 += h0[2 * d] * p0 + h0[2 * d + 1] * p1 + h0[2 * d + 2] * p2;
    }
    acc0 += v0;
    acc1 += v1;
    acc2 += v2;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
    acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
    acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
  }
  if (lane == 0) {
    q[3 * i] = acc0;
    q[3 * i + 1] = acc1;
    q[3 * i + 2] = acc2;
  }
}

template <typename T>
static int launch_hvp_table(const T* H, const int* conn, int b, const T* p, int n_blocks,
                            const int* entry, int K, int R, T* q, cudaStream_t stream) {
  if (n_blocks == 0) return stk_launch_status();
  const int threads = 32 * kHvpTableWarps;
  hvp_table_kernel<T><<<stk_blocks(n_blocks, kHvpTableWarps), threads, 0, stream>>>(
      H, conn, b, p, n_blocks, entry, K, R, q);
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
