// Kernel J: the per-row lagged-friction anchors.
//
// Replaces the per-stem row pass of stark_tpu/models/interactions/
// contact_engine.py `friction_tables` (:1588-1630). One thread per friction
// pair row: it classifies the row's distance region (narrow.cuh), then
// evaluates that region's friction geometry only, translated from
// stark_tpu/collision/narrow_phase.py and its twin in
// stark_tpu_torch/collision/narrow_phase.py:
//   PT: barycentric weights of the closest point (`point_triangle_bary`
//       :172) and the 2x3 tangent basis (`point_triangle_T` :238);
//   EE: line parameters (s, t) of the closest points (`edge_edge_params`
//       :333, with its relative `degen` test at the dtype's default
//       tolerance) and the tangent basis (`edge_edge_T` :367);
// and for every row mu = mu[mesh_a, mesh_b] and the normal force
// fn = barrier_force(d, dhat, k) (contact_energies.py:85, Cubic or the
// corrected Log). The twin evaluates all 7 or 9 candidates and selects one
// with a one-hot sum; the row's own candidate is the same arithmetic, done
// here in the twin's operation order with narrow.cuh's round-to-nearest
// helpers, so the region and its branches (the n_z < 0.99 axis switch of
// the point-point basis, the floor of a near-zero normalization, the
// parallel test) go the twin's way.
//
// Rows at or past min(*count, R) write zeros and region -1.
//
// Bound: bytes. Per row the two indices, d, dhat and the gathered vertices
// are read, and 12 values written; 159-200 flops for a PT row and 107-140
// for an EE row with the Cubic force (the region test and the region's
// branch; chip_smoke.py counts them per region).
#include "narrow.cuh"

template <typename T>
__device__ __forceinline__ V3<T> scale3(V3<T> v, T s) {
  return V3<T>{v.x / s, v.y / s, v.z / s};
}

// maths.normalized: v / sqrt(max(|v|^2, 1e-12))
template <typename T>
__device__ __forceinline__ V3<T> normalized(V3<T> v) {
  const T n2 = dot(v, v);
  return scale3(v, sqrt(n2 > T(1e-12) ? n2 : T(1e-12)));
}

template <typename T>
__device__ __forceinline__ void store_T(T* out, V3<T> u, V3<T> v) {
  out[0] = u.x; out[1] = u.y; out[2] = u.z;
  out[3] = v.x; out[4] = v.y; out[5] = v.z;
}

template <typename T>
__device__ __forceinline__ void proj_point_point(V3<T> p, V3<T> q, T* out) {
  const V3<T> n = normalized(sub(p, q));
  const V3<T> e = n.z < T(0.99) ? V3<T>{T(0), T(0), T(1)} : V3<T>{T(1), T(0), T(0)};
  const V3<T> u = normalized(cross(e, n));
  store_T(out, u, normalized(cross(u, n)));
}

template <typename T>
__device__ __forceinline__ void proj_point_edge(V3<T> p, V3<T> a, V3<T> b, T* out) {
  const V3<T> u = normalized(sub(b, a));
  store_T(out, u, normalized(cross(u, sub(p, a))));
}

template <typename T>
__device__ __forceinline__ void proj_triangle(V3<T> a, V3<T> b, V3<T> c, T* out) {
  const V3<T> v01 = sub(a, c);
  const V3<T> v02 = sub(b, c);
  const V3<T> u = normalized(v01);
  store_T(out, u, normalized(cross(cross(v01, v02), u)));
}

template <typename T>
__device__ __forceinline__ void proj_edge_edge(V3<T> a, V3<T> b, V3<T> p, V3<T> q,
                                               T* out) {
  const V3<T> u = normalized(sub(b, a));
  store_T(out, u, normalized(cross(u, cross(u, sub(q, p)))));
}

// alpha of the closest point of p on the line (a, b): dot(p-a, ab)/max(|ab|^2, tiny)
template <typename T>
__device__ __forceinline__ T edge_alpha(V3<T> p, V3<T> a, V3<T> b) {
  const V3<T> ab = sub(b, a);
  const T den = dot(ab, ab);
  return dot(sub(p, a), ab) / (den > T(STK_TINY) ? den : T(STK_TINY));
}

template <typename T>
__device__ __forceinline__ T barrier_force(T d, T dhat, T k, int log_barrier) {
  T gap = rn_sub(dhat, d);
  gap = gap > T(0) ? gap : T(0);
  if (!log_barrier) return rn_mul(k, rn_mul(gap, gap));
  const T ds = d > T(1e-35) ? d : T(1e-35);
  T ratio = ds / dhat;
  ratio = ratio < T(1) ? ratio : T(1);
  const T inner = rn_sub(gap, rn_mul(rn_mul(T(2), ds), log(ratio)));
  return rn_mul(rn_mul(k, gap), inner) / ds;
}

template <typename T>
__global__ void pt_rows_kernel(const T* __restrict__ V, const int* __restrict__ tris,
                               const int* __restrict__ q, const int* __restrict__ t,
                               int R, const int* __restrict__ count,
                               const T* __restrict__ d, const T* __restrict__ dhat,
                               const int* __restrict__ mesh_p,
                               const int* __restrict__ mesh_t, const T* __restrict__ mu,
                               int M, const T* __restrict__ k, int log_barrier,
                               int* __restrict__ region, T* __restrict__ bary,
                               T* __restrict__ Tm, T* __restrict__ mu_out,
                               T* __restrict__ fn) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  T* b = bary + 3LL * r;
  T* Tr = Tm + 6LL * r;
  const int n = *count;
  if (r >= (n < R ? n : R)) {
    region[r] = -1;
    b[0] = b[1] = b[2] = T(0);
    for (int i = 0; i < 6; ++i) Tr[i] = T(0);
    mu_out[r] = T(0);
    fn[r] = T(0);
    return;
  }
  const int* tri = tris + 3LL * t[r];
  const V3<T> p = ld3(V + 3LL * q[r]);
  const V3<T> t0 = ld3(V + 3LL * tri[0]);
  const V3<T> t1 = ld3(V + 3LL * tri[1]);
  const V3<T> t2 = ld3(V + 3LL * tri[2]);
  const int reg = point_triangle_region(p, t0, t1, t2);
  region[r] = reg;
  T w0 = T(0), w1 = T(0), w2 = T(0), al;
  switch (reg) {
    case 0: w0 = T(1); proj_point_point(p, t0, Tr); break;
    case 1: w1 = T(1); proj_point_point(p, t1, Tr); break;
    case 2: w2 = T(1); proj_point_point(p, t2, Tr); break;
    case 3:
      al = edge_alpha(p, t0, t1);
      w0 = rn_sub(T(1), al); w1 = al;
      proj_point_edge(p, t0, t1, Tr);
      break;
    case 4:
      al = edge_alpha(p, t1, t2);
      w1 = rn_sub(T(1), al); w2 = al;
      proj_point_edge(p, t1, t2, Tr);
      break;
    case 5:
      al = edge_alpha(p, t2, t0);
      w2 = rn_sub(T(1), al); w0 = al;
      proj_point_edge(p, t2, t0, Tr);
      break;
    default: {
      // the full (Ericson) barycentric of the face region
      const V3<T> e0 = sub(t1, t0), e1 = sub(t2, t0), e2 = sub(p, t0);
      const T d00 = dot(e0, e0), d01 = dot(e0, e1), d11 = dot(e1, e1);
      const T d20 = dot(e2, e0), d21 = dot(e2, e1);
      T den = rn_sub(rn_mul(d00, d11), rn_mul(d01, d01));
      den = den > T(STK_TINY) ? den : T(STK_TINY);
      w1 = rn_sub(rn_mul(d11, d20), rn_mul(d01, d21)) / den;
      w2 = rn_sub(rn_mul(d00, d21), rn_mul(d01, d20)) / den;
      w0 = rn_sub(rn_sub(T(1), w1), w2);
      proj_triangle(t0, t1, t2, Tr);
    }
  }
  b[0] = w0; b[1] = w1; b[2] = w2;
  mu_out[r] = mu[mesh_p[q[r]] * M + mesh_t[t[r]]];
  fn[r] = barrier_force(d[r], dhat[r], *k, log_barrier);
}

template <typename T>
__global__ void ee_rows_kernel(const T* __restrict__ V, const int* __restrict__ edges,
                               const int* __restrict__ a, const int* __restrict__ b,
                               int R, const int* __restrict__ count,
                               const T* __restrict__ d, const T* __restrict__ dhat,
                               const int* __restrict__ mesh, const T* __restrict__ mu,
                               int M, const T* __restrict__ k, int log_barrier, T ptol,
                               int* __restrict__ region, T* __restrict__ st,
                               T* __restrict__ Tm, T* __restrict__ mu_out,
                               T* __restrict__ fn) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  T* Tr = Tm + 6LL * r;
  const int n = *count;
  if (r >= (n < R ? n : R)) {
    region[r] = -1;
    st[2LL * r] = st[2LL * r + 1] = T(0);
    for (int i = 0; i < 6; ++i) Tr[i] = T(0);
    mu_out[r] = T(0);
    fn[r] = T(0);
    return;
  }
  const int* ea = edges + 2LL * a[r];
  const int* eb = edges + 2LL * b[r];
  const V3<T> a0 = ld3(V + 3LL * ea[0]), a1 = ld3(V + 3LL * ea[1]);
  const V3<T> b0 = ld3(V + 3LL * eb[0]), b1 = ld3(V + 3LL * eb[1]);
  const int reg = edge_edge_region(a0, a1, b0, b1, ptol);
  region[r] = reg;
  T s = T(0), tt = T(0);
  switch (reg) {
    case 0: proj_point_point(a0, b0, Tr); break;
    case 1: tt = T(1); proj_point_point(a0, b1, Tr); break;
    case 2: s = T(1); proj_point_point(a1, b0, Tr); break;
    case 3: s = T(1); tt = T(1); proj_point_point(a1, b1, Tr); break;
    case 4: s = edge_alpha(b0, a0, a1); proj_point_edge(b0, a0, a1, Tr); break;
    case 5: s = edge_alpha(b1, a0, a1); tt = T(1); proj_point_edge(b1, a0, a1, Tr); break;
    case 6: tt = edge_alpha(a0, b0, b1); proj_point_edge(a0, b0, b1, Tr); break;
    case 7: s = T(1); tt = edge_alpha(a1, b0, b1); proj_point_edge(a1, b0, b1, Tr); break;
    default: {
      // the unclamped line-line parameters; 0.5 each for parallel edges
      const V3<T> da = sub(a1, a0), db = sub(b1, b0), rr = sub(a0, b0);
      const T A = dot(da, da), E = dot(db, db), F = dot(db, rr);
      const T B = dot(da, db), C = dot(da, rr);
      const T den = rn_sub(rn_mul(A, E), rn_mul(B, B));
      if (den < rn_mul(rn_mul(default_parallel_tol<T>(), A), E)) {
        s = T(0.5);
        tt = T(0.5);
      } else {
        s = rn_sub(rn_mul(B, F), rn_mul(C, E)) / den;
        tt = rn_add(rn_mul(B, s), F) / (E > T(STK_TINY) ? E : T(STK_TINY));
      }
      proj_edge_edge(a0, a1, b0, b1, Tr);
    }
  }
  st[2LL * r] = s;
  st[2LL * r + 1] = tt;
  mu_out[r] = mu[mesh[a[r]] * M + mesh[b[r]]];
  fn[r] = barrier_force(d[r], dhat[r], *k, log_barrier);
}

template <typename T>
static int launch_pt_rows(const T* V, const int* tris, const int* q, const int* t,
                          int R, const int* count, const T* d, const T* dhat,
                          const int* mesh_p, const int* mesh_t, const T* mu, int M,
                          const T* k, int log_barrier, int* region, T* bary, T* Tm,
                          T* mu_out, T* fn, cudaStream_t stream) {
  if (R == 0) return stk_launch_status();
  const int threads = 128;
  pt_rows_kernel<T><<<stk_blocks(R, threads), threads, 0, stream>>>(
      V, tris, q, t, R, count, d, dhat, mesh_p, mesh_t, mu, M, k, log_barrier, region,
      bary, Tm, mu_out, fn);
  return stk_launch_status();
}

template <typename T>
static int launch_ee_rows(const T* V, const int* edges, const int* a, const int* b,
                          int R, const int* count, const T* d, const T* dhat,
                          const int* mesh, const T* mu, int M, const T* k,
                          int log_barrier, double ptol, int* region, T* st, T* Tm,
                          T* mu_out, T* fn, cudaStream_t stream) {
  if (R == 0) return stk_launch_status();
  const int threads = 128;
  ee_rows_kernel<T><<<stk_blocks(R, threads), threads, 0, stream>>>(
      V, edges, a, b, R, count, d, dhat, mesh, mu, M, k, log_barrier, (T)ptol, region,
      st, Tm, mu_out, fn);
  return stk_launch_status();
}

STK_API int stk_friction_rows_pt_f32(const float* V, const int* tris, const int* q,
                                     const int* t, int R, const int* count,
                                     const float* d, const float* dhat,
                                     const int* mesh_p, const int* mesh_t,
                                     const float* mu, int M, const float* k,
                                     int log_barrier, int* region, float* bary,
                                     float* Tm, float* mu_out, float* fn,
                                     cudaStream_t stream) {
  return launch_pt_rows<float>(V, tris, q, t, R, count, d, dhat, mesh_p, mesh_t, mu, M,
                               k, log_barrier, region, bary, Tm, mu_out, fn, stream);
}

STK_API int stk_friction_rows_pt_f64(const double* V, const int* tris, const int* q,
                                     const int* t, int R, const int* count,
                                     const double* d, const double* dhat,
                                     const int* mesh_p, const int* mesh_t,
                                     const double* mu, int M, const double* k,
                                     int log_barrier, int* region, double* bary,
                                     double* Tm, double* mu_out, double* fn,
                                     cudaStream_t stream) {
  return launch_pt_rows<double>(V, tris, q, t, R, count, d, dhat, mesh_p, mesh_t, mu,
                                M, k, log_barrier, region, bary, Tm, mu_out, fn,
                                stream);
}

STK_API int stk_friction_rows_ee_f32(const float* V, const int* edges, const int* a,
                                     const int* b, int R, const int* count,
                                     const float* d, const float* dhat,
                                     const int* mesh, const float* mu, int M,
                                     const float* k, int log_barrier, double ptol,
                                     int* region, float* st, float* Tm, float* mu_out,
                                     float* fn, cudaStream_t stream) {
  return launch_ee_rows<float>(V, edges, a, b, R, count, d, dhat, mesh, mu, M, k,
                               log_barrier, ptol, region, st, Tm, mu_out, fn, stream);
}

STK_API int stk_friction_rows_ee_f64(const double* V, const int* edges, const int* a,
                                     const int* b, int R, const int* count,
                                     const double* d, const double* dhat,
                                     const int* mesh, const double* mu, int M,
                                     const double* k, int log_barrier, double ptol,
                                     int* region, double* st, double* Tm,
                                     double* mu_out, double* fn, cudaStream_t stream) {
  return launch_ee_rows<double>(V, edges, a, b, R, count, d, dhat, mesh, mu, M, k,
                                log_barrier, ptol, region, st, Tm, mu_out, fn, stream);
}
