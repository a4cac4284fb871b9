// Device forms of the branchless IPC narrow phase (kernels G and H).
//
// Line-for-line translations of stark_tpu/collision/narrow_phase.py and of
// the port's twin stark_tpu_torch/collision/narrow_phase.py: the same region
// classification (first true condition wins, as jnp.select), the same
// squared-distance formulas per region, and the same f32-safe guards
// (_TINY = 1e-35, the relative parallel cutoff). Only the selected formula is
// evaluated here; the twin evaluates every candidate and selects with a
// one-hot mask so that torch.func derivatives stay finite.
//
// Every operation rounds as the twin's does, in the twin's order, so that a
// region test, a keep mask or an inclusive Moller-Trumbore bound decides the
// same way on a row that sits on its boundary (an edge that shares a vertex
// with the triangle, for one): products, sums and differences round to
// nearest with no FMA contraction (rn_* of stk_common.cuh); a dot product is
// (x0*y0 + x1*y1) + x2*y2, as torch.sum over the last axis adds; and a cross
// product component is fma(a_i, b_j, -(a_j*b_i)), which is how
// torch.linalg.cross evaluates it.
#pragma once

#include "stk_common.cuh"

#define STK_TINY 1e-35

// the dtype's default relative parallel cutoff (narrow_phase._parallel_tol)
template <typename T>
__device__ __forceinline__ T default_parallel_tol();
template <>
__device__ __forceinline__ float default_parallel_tol<float>() { return 1e-4f; }
template <>
__device__ __forceinline__ double default_parallel_tol<double>() { return 1e-20; }

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> ld3(const T* p) {
  return V3<T>{p[0], p[1], p[2]};
}
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return V3<T>{rn_sub(a.x, b.x), rn_sub(a.y, b.y), rn_sub(a.z, b.z)};
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return rn_add(rn_add(rn_mul(a.x, b.x), rn_mul(a.y, b.y)), rn_mul(a.z, b.z));
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return V3<T>{rn_fma(a.y, b.z, -rn_mul(a.z, b.y)),
               rn_fma(a.z, b.x, -rn_mul(a.x, b.z)),
               rn_fma(a.x, b.y, -rn_mul(a.y, b.x))};
}

template <typename T>
__device__ __forceinline__ T guarded_div(T num, T den, T floor) {
  return den > floor ? num / den : T(0);
}

template <typename T>
__device__ __forceinline__ T sq_point_point(V3<T> p, V3<T> q) {
  V3<T> d = sub(p, q);
  return dot(d, d);
}

template <typename T>
__device__ __forceinline__ T sq_point_line(V3<T> p, V3<T> a, V3<T> b) {
  V3<T> ab = sub(b, a);
  V3<T> ap = sub(p, a);
  T e = dot(ap, ab);
  return rn_sub(dot(ap, ap), guarded_div(rn_mul(e, e), dot(ab, ab), T(STK_TINY)));
}

template <typename T>
__device__ __forceinline__ T sq_point_plane(V3<T> p, V3<T> a, V3<T> b, V3<T> c) {
  V3<T> n = cross(sub(a, c), sub(b, c));
  T d = dot(sub(p, a), n);
  return guarded_div(rn_mul(d, d), dot(n, n), T(STK_TINY));
}

// the guard floor uses the dtype default, whatever cutoff the classifier got
template <typename T>
__device__ __forceinline__ T sq_line_line(V3<T> a, V3<T> b, V3<T> p, V3<T> q) {
  V3<T> u = sub(b, a);
  V3<T> v = sub(q, p);
  V3<T> n = cross(u, v);
  T l = dot(sub(p, a), n);
  T floor = rn_mul(rn_mul(default_parallel_tol<T>(), dot(u, u)), dot(v, v));
  return guarded_div(rn_mul(l, l), dot(n, n),
                     floor > T(STK_TINY) ? floor : T(STK_TINY));
}

template <typename T>
__device__ __forceinline__ void edge_param(V3<T> p, V3<T> e0, V3<T> e1, V3<T> n,
                                           T* s, T* o) {
  V3<T> e = sub(e1, e0);
  T ee = dot(e, e);
  *s = dot(sub(p, e0), e) / (ee > T(STK_TINY) ? ee : T(STK_TINY));
  *o = dot(sub(p, e0), cross(e, n));
}

// PT region codes: 0,1,2 vertices t0/t1/t2; 3,4,5 edges (t0t1),(t1t2),(t2t0);
// 6 face.
template <typename T>
__device__ __forceinline__ int point_triangle_region(V3<T> p, V3<T> t0, V3<T> t1,
                                                     V3<T> t2) {
  V3<T> n = cross(sub(t1, t0), sub(t2, t0));
  T s0, o0, s1, o1, s2, o2;
  edge_param(p, t0, t1, n, &s0, &o0);
  edge_param(p, t1, t2, n, &s1, &o1);
  edge_param(p, t2, t0, n, &s2, &o2);
  if (s0 > T(0) && s0 < T(1) && o0 >= T(0)) return 3;
  if (s1 > T(0) && s1 < T(1) && o1 >= T(0)) return 4;
  if (s2 > T(0) && s2 < T(1) && o2 >= T(0)) return 5;
  if (s0 <= T(0) && s2 >= T(1)) return 0;
  if (s1 <= T(0) && s0 >= T(1)) return 1;
  if (s2 <= T(0) && s1 >= T(1)) return 2;
  return 6;
}

template <typename T>
__device__ __forceinline__ T point_triangle_distance(V3<T> p, V3<T> t0, V3<T> t1,
                                                     V3<T> t2) {
  T sq;
  switch (point_triangle_region(p, t0, t1, t2)) {
    case 0: sq = sq_point_point(p, t0); break;
    case 1: sq = sq_point_point(p, t1); break;
    case 2: sq = sq_point_point(p, t2); break;
    case 3: sq = sq_point_line(p, t0, t1); break;
    case 4: sq = sq_point_line(p, t1, t2); break;
    case 5: sq = sq_point_line(p, t2, t0); break;
    default: sq = sq_point_plane(p, t0, t1, t2); break;
  }
  return sqrt(sq > T(STK_TINY) ? sq : T(STK_TINY));
}

// EE region codes (ipc bit layout): 0 EA0_EB0, 1 EA0_EB1, 2 EA1_EB0,
// 3 EA1_EB1, 4 EA_EB0, 5 EA_EB1, 6 EA0_EB, 7 EA1_EB, 8 EA_EB.
template <typename T>
__device__ __forceinline__ int edge_edge_region(V3<T> ea0, V3<T> ea1, V3<T> eb0,
                                                V3<T> eb1, T ptol) {
  V3<T> u = sub(ea1, ea0);
  V3<T> v = sub(eb1, eb0);
  V3<T> w = sub(ea0, eb0);
  T a = dot(u, u), b = dot(u, v), c = dot(v, v), d = dot(u, w), e = dot(v, w);
  T D = rn_sub(rn_mul(a, c), rn_mul(b, b));
  D = D > T(0) ? D : T(0);
  V3<T> uv = cross(u, v);
  T cross_sq = dot(uv, uv);
  if (cross_sq < rn_mul(rn_mul(ptol, a), c)) {
    T am = a > T(STK_TINY) ? a : T(STK_TINY);
    T alpha = dot(sub(eb0, ea0), u) / am;
    T beta = dot(sub(eb1, ea0), u) / am;
    bool b01 = T(0) <= beta && beta <= T(1);
    int eac, ebc;
    if (alpha < T(0)) {
      eac = b01 ? 2 : 0;
      ebc = beta <= alpha ? 0 : (beta <= T(1) ? 1 : 2);
    } else if (alpha > T(1)) {
      eac = b01 ? 2 : 1;
      ebc = beta >= alpha ? 0 : (T(0) <= beta ? 1 : 2);
    } else {
      eac = 2;
      ebc = 0;
    }
    return ebc < 2 ? ((eac << 1) | ebc) : 6 + eac;
  }
  T sN = rn_sub(rn_mul(b, e), rn_mul(c, d));
  bool low = sN <= T(0);
  bool high = sN >= D;
  T tN = low ? e : (high ? rn_add(e, b) : rn_sub(rn_mul(a, e), rn_mul(b, d)));
  T tD = (low || high) ? c : D;
  int code = low ? 6 : (high ? 7 : 8);
  if (tN <= T(0)) return -d <= T(0) ? 0 : (-d >= a ? 2 : 4);
  const T bd = rn_add(-d, b);
  if (tN >= tD) return bd <= T(0) ? 1 : (bd >= a ? 3 : 5);
  return code;
}

template <typename T>
__device__ __forceinline__ T edge_edge_distance(V3<T> ea0, V3<T> ea1, V3<T> eb0,
                                                V3<T> eb1, T ptol) {
  T sq;
  switch (edge_edge_region(ea0, ea1, eb0, eb1, ptol)) {
    case 0: sq = sq_point_point(ea0, eb0); break;
    case 1: sq = sq_point_point(ea0, eb1); break;
    case 2: sq = sq_point_point(ea1, eb0); break;
    case 3: sq = sq_point_point(ea1, eb1); break;
    case 4: sq = sq_point_line(eb0, ea0, ea1); break;
    case 5: sq = sq_point_line(eb1, ea0, ea1); break;
    case 6: sq = sq_point_line(ea0, eb0, eb1); break;
    case 7: sq = sq_point_line(ea1, eb0, eb1); break;
    default: sq = sq_line_line(ea0, ea1, eb0, eb1); break;
  }
  return sqrt(sq > T(STK_TINY) ? sq : T(STK_TINY));
}

// Moller-Trumbore, inclusive, with the relative parallel test.
template <typename T>
__device__ __forceinline__ bool segment_triangle_intersects(V3<T> p0, V3<T> p1,
                                                            V3<T> t0, V3<T> t1,
                                                            V3<T> t2, T ptol) {
  V3<T> d = sub(p1, p0);
  V3<T> e1 = sub(t1, t0);
  V3<T> e2 = sub(t2, t0);
  V3<T> h = cross(d, e2);
  T a = dot(e1, h);
  T scale_sq = rn_mul(dot(e1, e1), dot(h, h));
  T lim = rn_mul(ptol, scale_sq);
  bool not_parallel = rn_mul(a, a) > (lim > T(STK_TINY) ? lim : T(STK_TINY));
  if (!not_parallel) return false;
  T f = T(1) / a;
  V3<T> s = sub(p0, t0);
  T u = rn_mul(f, dot(s, h));
  V3<T> q = cross(s, e1);
  T v = rn_mul(f, dot(d, q));
  T t = rn_mul(f, dot(e2, q));
  return u >= T(0) && v >= T(0) && rn_add(u, v) <= T(1) && t >= T(0) && t <= T(1);
}
