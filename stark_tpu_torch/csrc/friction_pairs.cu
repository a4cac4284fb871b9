// Kernel I: the lagged-friction pair lists over the dense candidate grids.
//
// Replaces the dense branch of stark_tpu/models/interactions/
// contact_engine.py `friction_tables` (:1549-1577, with `_pt_dense_d` :1019
// and `_ee_dense_d` :1031). Over every (q, t) of a primitive grid (points x
// triangles, or edges x edges) it keeps the pairs with
//     allowed[q, t]  &&  mu[mesh_q[q], mesh_t[t]] != 0  &&  d(q, t) <= dhat,
//     dhat = th[mesh_q[q]] + th[mesh_t[t]],
// and lists them in row-major (q, t) order into (q, t, d, dhat) of capacity
// cap, with the exact total count (it may exceed cap; rows past it are 0).
// JAX builds the full (N, M) distance matrix, lifts mu onto it with one-hot
// matmuls (`_lift_mesh_pair`, an MXU device) and compacts the mask; here mu
// is read through the per-primitive mesh ids and no N x M array is written.
// The scaffolding is kernel F's (ball_wide.cu):
//   1. count: one warp per row q tests its pairs and stores the row's count;
//   2. the exclusive scan of kernel E (compact.cu) turns the counts into row
//      offsets and the total;
//   3. emit: one warp per row tests the pairs again, 32 at a time, and writes
//      each kept pair at the row offset + the popcount of the ballot below
//      its lane: the twin's nonzero order.
// The distance is narrow.cuh's, which rounds as the twin does (no FMA
// contraction, the twin's operation order), so a pair at d ~ dhat gets the
// twin's verdict and the lists equal the twin's.
//
// Bound: operations. Every allowed pair with mu != 0 costs one exact
// distance (the region test and one formula: 117-139 flops for PT, 65-99
// for EE, counted per region in chip_smoke.py) per pass, and
// the mask is read once per pass (Nq*Nt bytes).
#include "narrow.cuh"

int stk_exclusive_scan_i32(const int* counts, int m, int* offsets, int* total,
                           cudaStream_t stream);

#define FP_WARPS 8

template <typename T>
struct PtGrid {
  typedef T Real;
  const T* V;
  const int* tris;
  const uint8_t* allowed;
  const int* mesh_q;
  const int* mesh_t;
  const T* mu;
  const T* th;
  int M, Nq, Nt;

  __device__ __forceinline__ bool keep(int i, int j, T* d, T* dhat) const {
    if (!allowed[(long long)i * Nt + j]) return false;
    const int mq = mesh_q[i], mt = mesh_t[j];
    if (mu[mq * M + mt] == T(0)) return false;
    const int* tri = tris + 3LL * j;
    *d = point_triangle_distance(ld3(V + 3LL * i), ld3(V + 3LL * tri[0]),
                                 ld3(V + 3LL * tri[1]), ld3(V + 3LL * tri[2]));
    *dhat = rn_add(th[mq], th[mt]);
    return *d <= *dhat;
  }
};

template <typename T>
struct EeGrid {
  typedef T Real;
  const T* V;
  const int* edges;
  const uint8_t* allowed;
  const int* mesh;
  const T* mu;
  const T* th;
  int M, Nq, Nt;
  T ptol;

  __device__ __forceinline__ bool keep(int i, int j, T* d, T* dhat) const {
    if (!allowed[(long long)i * Nt + j]) return false;
    const int ma = mesh[i], mb = mesh[j];
    if (mu[ma * M + mb] == T(0)) return false;
    const int* ea = edges + 2LL * i;
    const int* eb = edges + 2LL * j;
    *d = edge_edge_distance(ld3(V + 3LL * ea[0]), ld3(V + 3LL * ea[1]),
                            ld3(V + 3LL * eb[0]), ld3(V + 3LL * eb[1]), ptol);
    *dhat = rn_add(th[ma], th[mb]);
    return *d <= *dhat;
  }
};

template <class G>
__global__ void fp_count_kernel(G g, int* __restrict__ row_counts) {
  const int i = blockIdx.x * FP_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= g.Nq) return;
  typename G::Real d, dhat;
  int c = 0;
  for (int j = lane; j < g.Nt; j += 32) c += g.keep(i, j, &d, &dhat) ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) row_counts[i] = c;
}

template <class G>
__global__ void fp_emit_kernel(G g, const int* __restrict__ row_offsets, int cap,
                               int* __restrict__ q, int* __restrict__ t,
                               typename G::Real* __restrict__ d_out,
                               typename G::Real* __restrict__ dhat_out) {
  const int i = blockIdx.x * FP_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= g.Nq) return;
  int off = row_offsets[i];
  if (off >= cap) return;
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < g.Nt; j0 += 32) {
    const int j = j0 + lane;
    typename G::Real d = 0, dhat = 0;
    const bool hit = j < g.Nt && g.keep(i, j, &d, &dhat);
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    const int pos = off + __popc(bal & below);
    if (hit && pos < cap) {
      q[pos] = i;
      t[pos] = j;
      d_out[pos] = d;
      dhat_out[pos] = dhat;
    }
    off += __popc(bal);
    if (off >= cap) break;
  }
}

// scratch: 2 * Nq ints (row counts, row offsets).
template <class G>
static int launch_pairs(const G& g, int cap, int* q, int* t,
                        typename G::Real* d, typename G::Real* dhat, int* count,
                        int* scratch, cudaStream_t stream) {
  typedef typename G::Real T;
  if (cap > 0) {
    cudaMemsetAsync(q, 0, (size_t)cap * sizeof(int), stream);
    cudaMemsetAsync(t, 0, (size_t)cap * sizeof(int), stream);
    cudaMemsetAsync(d, 0, (size_t)cap * sizeof(T), stream);
    cudaMemsetAsync(dhat, 0, (size_t)cap * sizeof(T), stream);
  }
  if (g.Nq == 0 || g.Nt == 0) {
    cudaMemsetAsync(count, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  int* row_counts = scratch;
  int* row_offsets = scratch + g.Nq;
  const int blocks = (g.Nq + FP_WARPS - 1) / FP_WARPS;
  fp_count_kernel<G><<<blocks, 32 * FP_WARPS, 0, stream>>>(g, row_counts);
  int rc = stk_exclusive_scan_i32(row_counts, g.Nq, row_offsets, count, stream);
  if (rc != 0) return rc;
  fp_emit_kernel<G><<<blocks, 32 * FP_WARPS, 0, stream>>>(g, row_offsets, cap, q, t,
                                                          d, dhat);
  return stk_launch_status();
}

template <typename T>
static int launch_pt(const T* V, const int* tris, int Np, int Nt,
                     const uint8_t* allowed, const int* mesh_p, const int* mesh_t,
                     const T* mu, const T* th, int M, int cap, int* q, int* t, T* d,
                     T* dhat, int* count, int* scratch, cudaStream_t stream) {
  PtGrid<T> g{V, tris, allowed, mesh_p, mesh_t, mu, th, M, Np, Nt};
  return launch_pairs(g, cap, q, t, d, dhat, count, scratch, stream);
}

template <typename T>
static int launch_ee(const T* V, const int* edges, int Ne, const uint8_t* allowed,
                     const int* mesh_e, const T* mu, const T* th, int M, double ptol,
                     int cap, int* a, int* b, T* d, T* dhat, int* count, int* scratch,
                     cudaStream_t stream) {
  EeGrid<T> g{V, edges, allowed, mesh_e, mu, th, M, Ne, Ne, (T)ptol};
  return launch_pairs(g, cap, a, b, d, dhat, count, scratch, stream);
}

STK_API int stk_friction_pairs_pt_f32(const float* V, const int* tris, int Np, int Nt,
                                      const uint8_t* allowed, const int* mesh_p,
                                      const int* mesh_t, const float* mu,
                                      const float* th, int M, int cap, int* q, int* t,
                                      float* d, float* dhat, int* count, int* scratch,
                                      cudaStream_t stream) {
  return launch_pt<float>(V, tris, Np, Nt, allowed, mesh_p, mesh_t, mu, th, M, cap, q,
                          t, d, dhat, count, scratch, stream);
}

STK_API int stk_friction_pairs_pt_f64(const double* V, const int* tris, int Np, int Nt,
                                      const uint8_t* allowed, const int* mesh_p,
                                      const int* mesh_t, const double* mu,
                                      const double* th, int M, int cap, int* q, int* t,
                                      double* d, double* dhat, int* count,
                                      int* scratch, cudaStream_t stream) {
  return launch_pt<double>(V, tris, Np, Nt, allowed, mesh_p, mesh_t, mu, th, M, cap,
                           q, t, d, dhat, count, scratch, stream);
}

STK_API int stk_friction_pairs_ee_f32(const float* V, const int* edges, int Ne,
                                      const uint8_t* allowed, const int* mesh_e,
                                      const float* mu, const float* th, int M,
                                      double ptol, int cap, int* a, int* b, float* d,
                                      float* dhat, int* count, int* scratch,
                                      cudaStream_t stream) {
  return launch_ee<float>(V, edges, Ne, allowed, mesh_e, mu, th, M, ptol, cap, a, b,
                          d, dhat, count, scratch, stream);
}

STK_API int stk_friction_pairs_ee_f64(const double* V, const int* edges, int Ne,
                                      const uint8_t* allowed, const int* mesh_e,
                                      const double* mu, const double* th, int M,
                                      double ptol, int cap, int* a, int* b, double* d,
                                      double* dhat, int* count, int* scratch,
                                      cudaStream_t stream) {
  return launch_ee<double>(V, edges, Ne, allowed, mesh_e, mu, th, M, ptol, cap, a,
                           b, d, dhat, count, scratch, stream);
}
