// Kernel B: the CG Hessian-vector product q = H p over up to eight groups
// of element Hessians in one launch: gather + element matvec + ordered
// per-block reduce.
//
// Replaces stark_tpu/solver/assembly.py `hvp_bucket` (:559-572) with its
// `_scatter_q` one-hot matmul (:514-522), and `hvp_ctx` (:186-196), which
// adds one segment_sum per arity group. A group is (conn (E, b) int32 with
// dummy id >= n_blocks, H (E, 3b, 3b), the CSR of conn's flat entries by
// block); the fused solve passes the static bucket and the live pool, the
// staged solve one group per arity, ascending. Each block's q is the sum of
// the groups' partial products, added in the groups' order, as hvp_ctx adds
// them.
//
// A product over more than eight groups takes one launch per eight: each
// later launch starts every row from the earlier launches' q (q_in), so the
// groups are still added in order.
//
// A warp owns block j's row: for each group, lane l takes the CSR entries
// offsets[j] + l, + 32, ... of that group. An entry (e, a) forms the 3
// components of row a of H_e p_e from H_e's rows 3a..3a+2 (3 x 3b
// contiguous values); a column whose conn is the dummy block is skipped,
// which is the product with p_pad's zero row (assembly.py:563). The lanes'
// sums meet in a fixed xor-shuffle tree and the group's partial is added to
// the row's sum. A fixed assignment and a fixed tree give the same bits on
// every launch, without atomics; the sum order differs from the twin's (per
// group a sequential sum over the CSR).
//
// Bound: bytes. Each kept CSR entry reads 9 values of H per real column
// block of its element (the rows of non-dummy entries, their non-dummy
// columns), plus conn, p (gathered, from L2), the CSR and q once; 2 flops
// per H value read. Design: a warp per row keeps 32 of the row's entries in
// flight at once, where one thread per component walked the row alone. The
// rigid bodies' rows are the longest (every contact and friction row that
// touches the body): at most 128 entries in the scenes of chip_smoke.py,
// four passes of a warp, which does not set the launch's time.
#include "stk_common.cuh"

#define STK_HVP_MAX_GROUPS 8
constexpr int kHvpWarps = 8;

template <typename T>
struct HvpGroup {
  const T* H;
  const int* conn;
  const int* perm;
  const int* offsets;
  int b;
};

template <typename T>
struct HvpGroups {
  HvpGroup<T> g[STK_HVP_MAX_GROUPS];
  int n;
};

// Adds the 3 components of row a of H_e p_e (flat entry e * b + a) to v.
template <typename T>
__device__ __forceinline__ void hvp_entry(const HvpGroup<T>& G, int flat,
                                          const T* __restrict__ p, int n_blocks,
                                          T& v0, T& v1, T& v2) {
  const int b = G.b;
  const int d = 3 * b;
  const long long e = flat / b;
  const int a = flat - (int)(e * b);
  const int* ce = G.conn + e * b;
  const T* h = G.H + (e * d + 3 * a) * d;
  T u0 = T(0), u1 = T(0), u2 = T(0);
  for (int s = 0; s < b; ++s) {
    const int blk = ce[s];
    if (blk >= n_blocks) continue;
    const T p0 = p[3 * blk], p1 = p[3 * blk + 1], p2 = p[3 * blk + 2];
    const T* h0 = h + 3 * s;
    u0 += h0[0] * p0 + h0[1] * p1 + h0[2] * p2;
    u1 += h0[d] * p0 + h0[d + 1] * p1 + h0[d + 2] * p2;
    u2 += h0[2 * d] * p0 + h0[2 * d + 1] * p1 + h0[2 * d + 2] * p2;
  }
  v0 += u0;
  v1 += u1;
  v2 += u2;
}

template <typename T>
__device__ __forceinline__ void warp_sum3(T& a0, T& a1, T& a2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kHvpWarps)
hvp_bucket_kernel(const HvpGroups<T> gs, const T* __restrict__ p, int n_blocks,
                  const T* __restrict__ q_in, T* __restrict__ q) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kHvpWarps + (threadIdx.x >> 5);
  if (j >= n_blocks) return;  // warp-uniform
  T q0 = T(0), q1 = T(0), q2 = T(0);
  if (q_in != nullptr) {
    q0 = q_in[3 * j];
    q1 = q_in[3 * j + 1];
    q2 = q_in[3 * j + 2];
  }
  for (int g = 0; g < gs.n; ++g) {
    const HvpGroup<T> G = gs.g[g];
    const int end = G.offsets[j + 1];
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int k = G.offsets[j] + lane; k < end; k += 32)
      hvp_entry(G, G.perm[k], p, n_blocks, a0, a1, a2);
    warp_sum3(a0, a1, a2);
    q0 += a0;
    q1 += a1;
    q2 += a2;
  }
  if (lane == 0) {
    q[3 * j] = q0;
    q[3 * j + 1] = q1;
    q[3 * j + 2] = q2;
  }
}

template <typename T>
static int launch_hvp_bucket(const void* const* H, const void* const* conn, const int* b,
                             const void* const* perm, const void* const* offsets,
                             int n_groups, const T* p, int n_blocks, const T* q_in,
                             T* q, cudaStream_t stream) {
  if (n_groups < 1 || n_groups > STK_HVP_MAX_GROUPS) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return stk_launch_status();
  HvpGroups<T> gs;
  gs.n = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    gs.g[g].H = static_cast<const T*>(H[g]);
    gs.g[g].conn = static_cast<const int*>(conn[g]);
    gs.g[g].perm = static_cast<const int*>(perm[g]);
    gs.g[g].offsets = static_cast<const int*>(offsets[g]);
    gs.g[g].b = b[g];
  }
  hvp_bucket_kernel<T><<<stk_blocks(n_blocks, kHvpWarps), 32 * kHvpWarps, 0, stream>>>(
      gs, p, n_blocks, q_in, q);
  return stk_launch_status();
}

// Host arrays of n_groups entries each (read before the launch returns):
// the groups' H, conn, arity, CSR perm and offsets, in the order their
// partial products are added. q_in is null, or the q of the product's
// earlier groups, to which these groups are added (it must not alias q).
STK_API int stk_hvp_bucket_f32(const void* const* H, const void* const* conn, const int* b,
                               const void* const* perm, const void* const* offsets,
                               int n_groups, const float* p, int n_blocks, const float* q_in,
                               float* q, cudaStream_t stream) {
  return launch_hvp_bucket<float>(H, conn, b, perm, offsets, n_groups, p, n_blocks, q_in, q,
                                  stream);
}

STK_API int stk_hvp_bucket_f64(const void* const* H, const void* const* conn, const int* b,
                               const void* const* perm, const void* const* offsets,
                               int n_groups, const double* p, int n_blocks, const double* q_in,
                               double* q, cudaStream_t stream) {
  return launch_hvp_bucket<double>(H, conn, b, perm, offsets, n_groups, p, n_blocks, q_in, q,
                                   stream);
}
