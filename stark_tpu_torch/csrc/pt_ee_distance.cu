// Kernel G: exact point-triangle and edge-edge distances over flat
// candidate rows, with the keep mask the next compaction (kernel E) reads.
//
// Replaces the vmapped narrow-phase calls of stark_tpu's contact engine over
// its flat candidate lists: stark_tpu/collision/narrow_phase.py:162
// `point_triangle_distance` (+ `point_triangle_region` :130) and :328
// `edge_edge_distance` (+ `edge_edge_region` :257), as called from
// contact_engine.py `broad_fn` (:1271-1294), `pairs_fn` (:1365-1392) and the
// dense branch of `_isect_stage1` (:1718). One thread per row: it gathers
// the row's 4 vertices, classifies the region, evaluates that region's
// formula only, and writes
//     d[r]    = distance,
//     keep[r] = act[r] && d[r] - off[r] <= bound[r]
// (act, off optional); a row with act[r] = 0 gets d = 0 and keep = 0 and
// costs no distance (the (Nq, K) candidate grids of the hash-grid path are
// mostly padding). The JAX version evaluates all 7 (PT) or 9 (EE)
// candidate formulas per row and selects by one-hot sum; the twin keeps
// that form because it must stay differentiable.
//
// Bound: bytes. Per row: the 2 row indices, up to 4 gathered 3-vectors
// (with their table entries), act/off/bound, and d and keep written.
#include "narrow.cuh"

template <typename T>
__global__ void pt_distance_kernel(const T* __restrict__ P, const T* __restrict__ V,
                                   const int* __restrict__ tris,
                                   const int* __restrict__ q,
                                   const int* __restrict__ t, int R,
                                   const uint8_t* __restrict__ act,
                                   const T* __restrict__ off,
                                   const T* __restrict__ bound, T* __restrict__ d,
                                   uint8_t* __restrict__ keep) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  if (act != nullptr && !act[r]) {   // a padding row: no distance
    d[r] = T(0);
    if (keep != nullptr) keep[r] = 0;
    return;
  }
  const int* tri = tris + 3LL * t[r];
  const T dist = point_triangle_distance(ld3(P + 3LL * q[r]), ld3(V + 3LL * tri[0]),
                                         ld3(V + 3LL * tri[1]),
                                         ld3(V + 3LL * tri[2]));
  d[r] = dist;
  if (keep != nullptr) {
    const T lhs = off != nullptr ? dist - off[r] : dist;
    keep[r] = (act == nullptr || act[r]) && lhs <= bound[r];
  }
}

template <typename T>
__global__ void ee_distance_kernel(const T* __restrict__ V,
                                   const int* __restrict__ edges,
                                   const int* __restrict__ a,
                                   const int* __restrict__ b, int R, T ptol,
                                   const uint8_t* __restrict__ act,
                                   const T* __restrict__ bound, T* __restrict__ d,
                                   uint8_t* __restrict__ keep) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  if (act != nullptr && !act[r]) {   // a padding row: no distance
    d[r] = T(0);
    if (keep != nullptr) keep[r] = 0;
    return;
  }
  const int* ea = edges + 2LL * a[r];
  const int* eb = edges + 2LL * b[r];
  const T dist = edge_edge_distance(ld3(V + 3LL * ea[0]), ld3(V + 3LL * ea[1]),
                                    ld3(V + 3LL * eb[0]), ld3(V + 3LL * eb[1]),
                                    ptol);
  d[r] = dist;
  if (keep != nullptr) keep[r] = (act == nullptr || act[r]) && dist <= bound[r];
}

template <typename T>
static int launch_pt(const T* P, const T* V, const int* tris, const int* q,
                     const int* t, int R, const uint8_t* act, const T* off,
                     const T* bound, T* d, uint8_t* keep, cudaStream_t stream) {
  if (R == 0) return stk_launch_status();
  const int threads = 128;
  pt_distance_kernel<T><<<stk_blocks(R, threads), threads, 0, stream>>>(
      P, V, tris, q, t, R, act, off, bound, d, keep);
  return stk_launch_status();
}

template <typename T>
static int launch_ee(const T* V, const int* edges, const int* a, const int* b,
                     int R, double ptol, const uint8_t* act, const T* bound, T* d,
                     uint8_t* keep, cudaStream_t stream) {
  if (R == 0) return stk_launch_status();
  const int threads = 128;
  ee_distance_kernel<T><<<stk_blocks(R, threads), threads, 0, stream>>>(
      V, edges, a, b, R, (T)ptol, act, bound, d, keep);
  return stk_launch_status();
}

STK_API int stk_pt_distance_f32(const float* P, const float* V, const int* tris,
                                const int* q, const int* t, int R,
                                const uint8_t* act, const float* off,
                                const float* bound, float* d, uint8_t* keep,
                                cudaStream_t stream) {
  return launch_pt<float>(P, V, tris, q, t, R, act, off, bound, d, keep, stream);
}

STK_API int stk_pt_distance_f64(const double* P, const double* V,
                                const int* tris, const int* q, const int* t,
                                int R, const uint8_t* act, const double* off,
                                const double* bound, double* d, uint8_t* keep,
                                cudaStream_t stream) {
  return launch_pt<double>(P, V, tris, q, t, R, act, off, bound, d, keep,
                           stream);
}

STK_API int stk_ee_distance_f32(const float* V, const int* edges, const int* a,
                                const int* b, int R, double ptol,
                                const uint8_t* act, const float* bound,
                                float* d, uint8_t* keep, cudaStream_t stream) {
  return launch_ee<float>(V, edges, a, b, R, ptol, act, bound, d, keep, stream);
}

STK_API int stk_ee_distance_f64(const double* V, const int* edges, const int* a,
                                const int* b, int R, double ptol,
                                const uint8_t* act, const double* bound,
                                double* d, uint8_t* keep, cudaStream_t stream) {
  return launch_ee<double>(V, edges, a, b, R, ptol, act, bound, d, keep,
                           stream);
}
