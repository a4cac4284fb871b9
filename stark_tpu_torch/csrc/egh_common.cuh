// Element math shared by kernels M-W: per-element energy, gradient and dense
// Hessian of the incremental potential's families (K11).
//
// Replaces stark_tpu/solver/assembly.py:117-135, which takes every element
// derivative from jax.vmap(jax.hessian(e_fn)) (the port's plain twin is
// torch.func's vmap(grad_and_value) / vmap(hessian), ops/egh.py `plain`).
//
// Design: each element energy is written once, as a template over its
// scalar type S. With S = T (float or double) it is the value-only form
// that Evaluators.energy launches; with S = Dual<T, N>, a second-order
// forward-mode dual (the value, the N-gradient and the packed upper
// triangle of the NxN Hessian), the same code yields e, g and H in one
// pass, as jax.hessian does. Both forms perform the same float operations
// on the value, in the same order, and the sources build with -fmad=false,
// so the e of an egh launch is bit for bit the e of a value-only launch at
// the same iterate (solver/fused.py reuses egh's E as the Armijo reference).
//
// Kinks take the branch torch.func takes in the twin: clamp_min passes the
// derivative where x >= min, clamp_max where x <= max, a where() on a value
// test selects one branch's derivatives whole, and a guarded division is
// zero (with zero derivatives) where the twin's guard fails.
//
// Everything here is __host__ __device__ (STK_HD) and compiles as plain
// C++17 too: the CPU tests build the egh_*.cu element functions with g++
// (ops/build.py host_library) and hold them against the twins and JAX.
#pragma once

#include <type_traits>

#include "narrow.cuh"

#ifdef __CUDACC__
#define STK_NOINLINE __host__ __device__ __noinline__
#else
#define STK_NOINLINE inline
#endif

namespace egh {

// ---------------------------------------------------------------------------
// second-order forward-mode dual numbers
// ---------------------------------------------------------------------------
template <typename T, int N>
struct Dual {
  static constexpr int NH = N * (N + 1) / 2;
  T v;
  T g[N];
  T h[NH];   // upper triangle, row by row: (0,0) (0,1) .. (0,N-1) (1,1) ..
};

template <typename T>
struct ident {
  using type = T;
};
template <typename T>
using nd = typename ident<T>::type;   // a parameter that takes no part in deduction

template <typename T>
STK_HD T val(T x) {
  return x;
}
template <typename T, int N>
STK_HD T val(const Dual<T, N>& x) {
  return x.v;
}

template <typename T>
STK_HD void set_const(T& x, T c) {
  x = c;
}
template <typename T, int N>
STK_HD void set_const(Dual<T, N>& x, T c) {
  x.v = c;
  for (int i = 0; i < N; ++i) x.g[i] = T(0);
  for (int k = 0; k < Dual<T, N>::NH; ++k) x.h[k] = T(0);
}
template <typename S, typename T>
STK_HD S konst(T c) {
  S x;
  set_const(x, c);
  return x;
}

// x = value, with d x / d var_i = 1 (an independent variable)
template <typename T>
STK_HD void seed(T& x, T value, int) {
  x = value;
}
template <typename T, int N>
STK_HD void seed(Dual<T, N>& x, T value, int i) {
  set_const(x, value);
  x.g[i] = T(1);
}

template <typename T, int N>
STK_HD Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] + b.g[i];
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = a.h[k] + b.h[k];
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] - b.g[i];
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = a.h[k] - b.h[k];
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
  for (int i = 0; i < N; ++i) r.g[i] = -a.g[i];
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = -a.h[k];
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator+(const Dual<T, N>& a, nd<T> c) {
  Dual<T, N> r = a;
  r.v = a.v + c;
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator+(nd<T> c, const Dual<T, N>& a) {
  Dual<T, N> r = a;
  r.v = c + a.v;
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator-(const Dual<T, N>& a, nd<T> c) {
  Dual<T, N> r = a;
  r.v = a.v - c;
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator-(nd<T> c, const Dual<T, N>& a) {
  Dual<T, N> r = -a;
  r.v = c - a.v;
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator*(const Dual<T, N>& a, nd<T> c) {
  Dual<T, N> r;
  r.v = a.v * c;
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * c;
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = a.h[k] * c;
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator*(nd<T> c, const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c * a.v;
  for (int i = 0; i < N; ++i) r.g[i] = c * a.g[i];
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = c * a.h[k];
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
  for (int i = 0; i < N; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
  int k = 0;
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j, ++k)
      r.h[k] = (a.v * b.h[k] + b.v * a.h[k]) + (a.g[i] * b.g[j] + a.g[j] * b.g[i]);
  }
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator/(const Dual<T, N>& a, nd<T> c) {
  Dual<T, N> r;
  r.v = a.v / c;
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / c;
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = a.h[k] / c;
  return r;
}
// q = a / b: the value is a.v / b.v (as the value-only form divides);
// dq = (da - q db) / b, d2q = (d2a - q d2b - dq db' - db dq') / b
template <typename T, int N>
STK_HD Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  const T ib = T(1) / b.v;
  for (int i = 0; i < N; ++i) r.g[i] = (a.g[i] - r.v * b.g[i]) * ib;
  int k = 0;
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j, ++k)
      r.h[k] = ((a.h[k] - r.v * b.h[k]) - (r.g[i] * b.g[j] + r.g[j] * b.g[i])) * ib;
  }
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> operator/(nd<T> c, const Dual<T, N>& b) {
  return konst<Dual<T, N>>(c) / b;
}

template <typename T>
STK_HD T sqrt_(T x) {
  return sqrt(x);
}
// sqrt and log write f'' g g^T as (f' g)(f' g)^T / s and (f' g)(f' g)^T:
// f'' alone overflows float32 where the argument is a clamp's floor
// (1e-35), and inf * 0 would poison a constant's zero derivatives
template <typename T, int N>
STK_HD Dual<T, N> sqrt_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt(a.v);
  const T f1 = T(0.5) / r.v;
  for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
  int k = 0;
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j, ++k) r.h[k] = f1 * a.h[k] - (r.g[i] * r.g[j]) / r.v;
  }
  return r;
}
template <typename T>
STK_HD T log_(T x) {
  return log(x);
}
template <typename T, int N>
STK_HD Dual<T, N> log_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = log(a.v);
  const T f1 = T(1) / a.v;
  for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
  int k = 0;
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j, ++k) r.h[k] = f1 * a.h[k] - r.g[i] * r.g[j];
  }
  return r;
}

// a * c + b: in float32 with one rounding (an FMA, as an explicit one
// survives -fmad=false), as the twin's cuBLAS products round on the card;
// rounded apart, the float32 strain gradient at the 64x64 cloth and a
// rigid edge's energies lay 3-6x farther from float64 than the twin's (an
// H100). Float64 keeps the two roundings, with which the card's f64 cloth
// stays within tests/test_torch_cuda.py's 1e-8 m of the CPU port.
template <typename T>
STK_HD T fma_(T a, nd<T> c, T b) {
  if constexpr (std::is_same<T, float>::value) return rn_fma(a, c, b);
  return a * c + b;
}
template <typename T, int N>
STK_HD Dual<T, N> fma_(const Dual<T, N>& a, const Dual<T, N>& b, const Dual<T, N>& c) {
  Dual<T, N> r;
  r.v = fma_(a.v, b.v, c.v);
  for (int i = 0; i < N; ++i) r.g[i] = (a.v * b.g[i] + b.v * a.g[i]) + c.g[i];
  int k = 0;
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j, ++k)
      r.h[k] = ((a.v * b.h[k] + b.v * a.h[k]) + (a.g[i] * b.g[j] + a.g[j] * b.g[i])) + c.h[k];
  }
  return r;
}
template <typename T, int N>
STK_HD Dual<T, N> fma_(const Dual<T, N>& a, nd<T> c, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = fma_(a.v, c, b.v);
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * c + b.g[i];
  for (int k = 0; k < Dual<T, N>::NH; ++k) r.h[k] = a.h[k] * c + b.h[k];
  return r;
}

// torch.clamp_min / clamp_max: the derivative passes where x >= lo / x <= hi
template <typename S, typename T>
STK_HD S clamp_min_(const S& x, T lo) {
  return val(x) >= lo ? x : konst<S>(lo);
}
template <typename S, typename T>
STK_HD S clamp_max_(const S& x, T hi) {
  return val(x) <= hi ? x : konst<S>(hi);
}

// ---------------------------------------------------------------------------
// 3-vectors over S
// ---------------------------------------------------------------------------
template <typename S>
struct Vec {
  S x, y, z;
};
template <typename S>
STK_HD Vec<S> vsub(const Vec<S>& a, const Vec<S>& b) {
  return Vec<S>{a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename S>
STK_HD Vec<S> vadd(const Vec<S>& a, const Vec<S>& b) {
  return Vec<S>{a.x + b.x, a.y + b.y, a.z + b.z};
}
// (x0*y0 + x1*y1) + x2*y2, as torch.sum over the last axis adds
template <typename S>
STK_HD S vdot(const Vec<S>& a, const Vec<S>& b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
// a component as fma_(a_i, b_j, -(a_j b_i)), as torch.linalg.cross rounds on
// the card (narrow.cuh)
template <typename S>
STK_HD Vec<S> vcross(const Vec<S>& a, const Vec<S>& b) {
  return Vec<S>{fma_(a.y, b.z, -(a.z * b.y)), fma_(a.z, b.x, -(a.x * b.z)),
                fma_(a.x, b.y, -(a.y * b.x))};
}
template <typename T>
STK_HD Vec<T> vld(const T* p) {
  return Vec<T>{p[0], p[1], p[2]};
}

// ---------------------------------------------------------------------------
// maths.py (the port's stark_tpu_torch/maths.py; JAX maths.py:52, :239)
// ---------------------------------------------------------------------------
#define STK_EPSILON 1e-12

template <typename S>
STK_HD S safe_sqrt(const S& x) {
  using T = decltype(val(x));
  return sqrt_(clamp_min_(x, T(STK_EPSILON)));
}
template <typename S>
STK_HD S safe_norm(const Vec<S>& v) {
  return safe_sqrt(vdot(v, v));
}
// where(x > 0, k x^3 / 3, 0)
template <typename S, typename T>
STK_HD S cubic_one_sided(const S& x, T k) {
  return val(x) > T(0) ? ((k * x) * x * x) / T(3) : konst<S>(T(0));
}
// the closed-form eigenvalues (mean -+ disc) of [[a, b], [b, d]]
template <typename S>
STK_HD void eigenvalues_sym_2x2(const S& a, const S& b, const S& d, S* s0, S* s1) {
  using T = decltype(val(a));
  const S mean = T(0.5) * (a + d);
  const S disc = safe_sqrt((T(0.25) * (a - d)) * (a - d) + b * b);
  *s0 = mean - disc;
  *s1 = mean + disc;
}

// ---------------------------------------------------------------------------
// the rigid map x(v, w) = t0 + dt v + R(q(w)) loc (JAX maths.py:119-135)
// ---------------------------------------------------------------------------
// maths.quat_to_rotation of a unit quaternion (w, x, y, z)
template <typename S>
STK_HD void quat_to_rotation(const S* q, S* R) {
  using T = decltype(val(q[0]));
  const S tx = q[1] + q[1], ty = q[2] + q[2], tz = q[3] + q[3];
  const S twx = tx * q[0], twy = ty * q[0], twz = tz * q[0];
  const S txx = tx * q[1], txy = ty * q[1], txz = tz * q[1];
  const S tyy = ty * q[2], tyz = tz * q[2];
  const S tzz = tz * q[3];
  R[0] = T(1) - (tyy + tzz);
  R[1] = txy - twz;
  R[2] = txz + twy;
  R[3] = txy + twz;
  R[4] = T(1) - (txx + tzz);
  R[5] = tyz - twx;
  R[6] = txz - twy;
  R[7] = tyz + twx;
  R[8] = T(1) - (txx + tyy);
}

// R(q1), q1 = normalize(q0 + (0.5 dt) (0, w) x q0): the Hamilton product as
// the twin's L((0, w)) @ q0, a row an fma_ chain in column order (its zero
// entry dropped), the norm through safe_norm, the rotation as
// maths.quat_to_rotation
template <typename S, typename T>
STK_HD void rigid_rotation(const T* q0, const S* w, T dt, S* R) {
  const S qm0 = fma_(-w[2], q0[3], fma_(-w[1], q0[2], (-w[0]) * q0[1]));
  const S qm1 = fma_(w[1], q0[3], fma_(-w[2], q0[2], w[0] * q0[0]));
  const S qm2 = fma_(-w[0], q0[3], fma_(w[2], q0[1], w[1] * q0[0]));
  const S qm3 = fma_(w[0], q0[2], fma_(-w[1], q0[1], w[2] * q0[0]));
  const T hdt = T(0.5) * dt;
  S q[4] = {q0[0] + hdt * qm0, q0[1] + hdt * qm1, q0[2] + hdt * qm2,
            q0[3] + hdt * qm3};
  const S n = safe_sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  for (int c = 0; c < 4; ++c) q[c] = q[c] / n;
  quat_to_rotation(q, R);
}
// R @ loc, each row through fma_ (R_k0 l0, + R_k1 l1, + R_k2 l2): a body
// point sits ~0.1 m out while the barrier reads distances of ~1e-3 m
template <typename S, typename T>
STK_HD Vec<S> rotate(const S* R, const T* l) {
  return Vec<S>{fma_(R[2], l[2], fma_(R[1], l[1], R[0] * l[0])),
                fma_(R[5], l[2], fma_(R[4], l[1], R[3] * l[0])),
                fma_(R[8], l[2], fma_(R[7], l[1], R[6] * l[0]))};
}

// ---------------------------------------------------------------------------
// the IPC distances over S, per region (the formulas of narrow.cuh and of
// the twin, collision/narrow_phase.py); the region comes from narrow.cuh's
// classifiers on the values, which round as the twin's, so a kernel
// differentiates the candidate the twin's one-hot select keeps
// ---------------------------------------------------------------------------
template <typename S, typename T>
STK_HD S guarded_div_(const S& num, const S& den, T floor) {
  return val(den) > floor ? num / den : konst<S>(T(0));
}
template <typename S>
STK_HD S sq_pp(const Vec<S>& p, const Vec<S>& q) {
  const Vec<S> d = vsub(p, q);
  return vdot(d, d);
}
// the squared distance to the line (a, b) as |ap - s ab|^2, s = ap.ab /
// |ab|^2 (the twin's narrow_phase._sq_point_line_projected): the reference's
// |ap|^2 - (ap.ab)^2 / |ab|^2 loses ~eps |ap|^2 to cancellation, the whole
// square of a gap of a few mm beside a 2 m edge in float32
template <typename S>
STK_HD S sq_pl(const Vec<S>& p, const Vec<S>& a, const Vec<S>& b) {
  using T = decltype(val(p.x));
  const Vec<S> ab = vsub(b, a);
  const Vec<S> ap = vsub(p, a);
  const S s = guarded_div_(vdot(ap, ab), vdot(ab, ab), T(STK_TINY));
  const Vec<S> c{ap.x - s * ab.x, ap.y - s * ab.y, ap.z - s * ab.z};
  return vdot(c, c);
}
template <typename S>
STK_HD S sq_pf(const Vec<S>& p, const Vec<S>& a, const Vec<S>& b, const Vec<S>& c) {
  using T = decltype(val(p.x));
  const Vec<S> n = vcross(vsub(a, c), vsub(b, c));
  const S d = vdot(vsub(p, a), n);
  return guarded_div_(d * d, vdot(n, n), T(STK_TINY));
}
// the guard's floor is the dtype default whatever cutoff the classifier got
template <typename S>
STK_HD S sq_ll(const Vec<S>& a, const Vec<S>& b, const Vec<S>& p, const Vec<S>& q) {
  using T = decltype(val(a.x));
  const Vec<S> u = vsub(b, a);
  const Vec<S> v = vsub(q, p);
  const Vec<S> n = vcross(u, v);
  const S l = vdot(vsub(p, a), n);
  const T floor = (default_parallel_tol<T>() * val(vdot(u, u))) * val(vdot(v, v));
  return guarded_div_(l * l, vdot(n, n), floor > T(STK_TINY) ? floor : T(STK_TINY));
}

// The face and line-line distance, the twin's sqrt(guarded_div(l^2, n.n)):
// the same guards, below the floor sqrt(_TINY) with zero derivatives, and
// the twin's value; the derivatives are those of |l| / |n|. The squared
// form's Hessian, f' h_sq - g g^T / d, cancels two terms of order 1/d as
// d -> 0 (float32 rows near contact lost ~500 eps of max|H| to it), while
// |l| / |n| has no 1/d term; its value, though, sat 2x farther from
// float64 than the twin's on cloth edge-edge rows (an H100).
template <typename T>
STK_HD void set_value(T& x, T v) {
  x = v;
}
template <typename T, int N>
STK_HD void set_value(Dual<T, N>& x, T v) {
  x.v = v;
}
template <typename S, typename T>
STK_HD S plane_distance(const S& l, const S& nn, T floor) {
  const T sq = val(nn) > floor ? (val(l) * val(l)) / val(nn) : T(0);
  if (!(sq >= T(STK_TINY))) return konst<S>(T(sqrt(T(STK_TINY))));
  S d = (val(l) >= T(0) ? l : -l) / sqrt_(nn);
  set_value(d, T(sqrt(sq)));
  return d;
}

// PT squared distance of the region (narrow.cuh's codes)
template <typename S>
STK_HD S pt_sq_distance(const Vec<S>* x, int region) {
  const Vec<S>&p = x[0], &t0 = x[1], &t1 = x[2], &t2 = x[3];
  switch (region) {
    case 0: return sq_pp(p, t0);
    case 1: return sq_pp(p, t1);
    case 2: return sq_pp(p, t2);
    case 3: return sq_pl(p, t0, t1);
    case 4: return sq_pl(p, t1, t2);
    case 5: return sq_pl(p, t2, t0);
    default: return sq_pf(p, t0, t1, t2);
  }
}
// EE squared distance of the region (narrow.cuh's codes)
template <typename S>
STK_HD S ee_sq_distance(const Vec<S>* x, int region) {
  const Vec<S>&a0 = x[0], &a1 = x[1], &b0 = x[2], &b1 = x[3];
  switch (region) {
    case 0: return sq_pp(a0, b0);
    case 1: return sq_pp(a0, b1);
    case 2: return sq_pp(a1, b0);
    case 3: return sq_pp(a1, b1);
    case 4: return sq_pl(b0, a0, a1);
    case 5: return sq_pl(b1, a0, a1);
    case 6: return sq_pl(a0, b0, b1);
    case 7: return sq_pl(a1, b0, b1);
    default: return sq_ll(a0, a1, b0, b1);
  }
}

// the distance of the region: sqrt(max(sq, _TINY)), the face (PT) and
// line-line (EE) regions as |l| / |n|
template <typename S>
STK_HD S pt_distance(const Vec<S>* x, int region) {
  using T = decltype(val(x[0].x));
  if (region == 6) {
    const Vec<S> n = vcross(vsub(x[1], x[3]), vsub(x[2], x[3]));
    return plane_distance(vdot(vsub(x[0], x[1]), n), vdot(n, n), T(STK_TINY));
  }
  return sqrt_(clamp_min_(pt_sq_distance(x, region), T(STK_TINY)));
}
template <typename S>
STK_HD S ee_distance(const Vec<S>* x, int region) {
  using T = decltype(val(x[0].x));
  if (region == 8) {
    const Vec<S> u = vsub(x[1], x[0]);
    const Vec<S> v = vsub(x[3], x[2]);
    const Vec<S> n = vcross(u, v);
    const T floor = (default_parallel_tol<T>() * val(vdot(u, u))) * val(vdot(v, v));
    return plane_distance(vdot(vsub(x[2], x[0]), n), vdot(n, n),
                          floor > T(STK_TINY) ? floor : T(STK_TINY));
  }
  return sqrt_(clamp_min_(ee_sq_distance(x, region), T(STK_TINY)));
}

// the barrier of contact_energies.barrier for an active row: Cubic (log_barrier
// = 0) k gap^3 / 3, Log -k gap^2 log(min(max(d, 1e-35) / dhat, 1)), with
// gap = max(dhat - d, 0)
template <typename S, typename T>
STK_HD S barrier(const S& d, T dhat, T k, int log_barrier) {
  const S gap = clamp_min_(dhat - d, T(0));
  if (!log_barrier) return (k * ((gap * gap) * gap)) / T(3);
  const S ds = clamp_min_(d, T(1e-35));
  return ((-k) * (gap * gap)) * log_(clamp_max_(ds / dhat, T(1)));
}

// the IPC edge-edge mollifier with eps_x from the rest positions
template <typename S, typename T>
STK_HD S ee_mollifier(const Vec<S>* x, T eps_x) {
  const Vec<S> c = vcross(vsub(x[1], x[0]), vsub(x[3], x[2]));
  const S xs = vdot(c, c);
  const S x_div = xs / (eps_x > T(STK_TINY) ? eps_x : T(STK_TINY));
  return val(xs) > eps_x ? konst<S>(T(1)) : ((-x_div) + T(2)) * x_div;
}

// ---------------------------------------------------------------------------
// arguments of every egh entry point
// ---------------------------------------------------------------------------
// u (n_blocks, 3) DOFs, conn (E, arity) int64 block ids, active (E,), then
// up to 16 family tensors (each family's wrapper lists their order) and 4
// family scalars; e (E,), and for the derivative form g (E, arity, 3) and
// H (E, 3 arity, 3 arity). Index tables are int64.
#define STK_EGH_PTRS 16
template <typename T>
struct Args {
  const T* u;
  const long long* conn;
  const T* active;
  const void* p[STK_EGH_PTRS];
  double s[4];
  long long E;
  T* e;
  T* g;
  T* H;
};
template <typename T>
STK_HD const T* fp(const Args<T>& A, int k) {
  return static_cast<const T*>(A.p[k]);
}
template <typename T>
STK_HD const long long* ip(const Args<T>& A, int k) {
  return static_cast<const long long*>(A.p[k]);
}

// exact zeros for an inactive row (the twin evaluates, then masks)
template <typename T, int ARITY, bool D>
STK_HD void write_zero(const Args<T>& A, long long i) {
  constexpr int NA = 3 * ARITY;
  A.e[i] = T(0);
  if (!D) return;
  for (int n = 0; n < NA; ++n) A.g[i * NA + n] = T(0);
  for (int n = 0; n < NA * NA; ++n) A.H[i * NA * NA + n] = T(0);
}
// e, g and the full symmetric H of a dual over the element's own DOFs
template <typename T, int N>
STK_HD void write_dual(const Args<T>& A, long long i, const Dual<T, N>& r) {
  A.e[i] = r.v;
  for (int n = 0; n < N; ++n) A.g[i * N + n] = r.g[n];
  T* H = A.H + i * N * N;
  int k = 0;
  for (int a = 0; a < N; ++a) {
    for (int b = a; b < N; ++b, ++k) {
      H[a * N + b] = r.h[k];
      H[b * N + a] = r.h[k];
    }
  }
}
template <typename T>
STK_HD void write_dual(const Args<T>& A, long long i, T r) {
  A.e[i] = r;
}

// the element's DOF blocks u[conn[i, slot]] as S: seeded as independent
// variables 3 slot + c when S is a dual
template <typename S, typename T>
STK_HD Vec<S> dof(const Args<T>& A, long long i, int arity, int slot, int var0) {
  const T* u = A.u + 3LL * A.conn[i * arity + slot];
  Vec<S> r;
  seed(r.x, u[0], var0 + 0);
  seed(r.y, u[1], var0 + 1);
  seed(r.z, u[2], var0 + 2);
  return r;
}

}  // namespace egh

// One __global__ template serves every family: F::eval<T, D>(args, i) writes
// row i (D: the derivative form). A thread per element: the dual's
// registers are the constraint (the wider families spill; their ptxas
// reports are in chip_smoke's ptxas.txt).
#ifdef __CUDACC__
template <typename F, typename T, bool D>
__global__ void __launch_bounds__(64) egh_kernel(egh::Args<T> A) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.E) return;
  F::template eval<T, D>(A, i);
}
#endif

template <typename T>
static egh::Args<T> egh_args(const void* const* p, const double* s, long long E,
                             void* e, void* g, void* H) {
  egh::Args<T> A;
  A.u = static_cast<const T*>(p[0]);
  A.conn = static_cast<const long long*>(p[1]);
  A.active = static_cast<const T*>(p[2]);
  for (int k = 0; k < STK_EGH_PTRS; ++k) A.p[k] = p[3 + k];
  for (int k = 0; k < 4; ++k) A.s[k] = s[k];
  A.E = E;
  A.e = static_cast<T*>(e);
  A.g = static_cast<T*>(g);
  A.H = static_cast<T*>(H);
  return A;
}

#ifdef __CUDACC__
template <typename F, typename T>
static int egh_launch(const void* const* p, const double* s, long long E, void* e,
                      void* g, void* H, void* stream) {
  if (E == 0) return stk_launch_status();
  const egh::Args<T> A = egh_args<T>(p, s, E, e, g, H);
  const int threads = 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g != nullptr)
    egh_kernel<F, T, true><<<stk_blocks(E, threads), threads, 0, st>>>(A);
  else
    egh_kernel<F, T, false><<<stk_blocks(E, threads), threads, 0, st>>>(A);
  return stk_launch_status();
}
// stk_egh_<name>_f32 / _f64 (ptrs, scalars, E, e, g or null, H or null,
// stream); a source that ops/build.py compiles in parts (its PARTS) emits
// one dtype per part, STK_EGH_ONLY_F32 or STK_EGH_ONLY_F64
#ifndef STK_EGH_ONLY_F64
#define STK_EGH_ENTRY_F32(F, NAME)                                                \
  STK_API int stk_egh_##NAME##_f32(const void* const* p, const double* s,         \
                                   long long E, void* e, void* g, void* H,        \
                                   void* stream) {                                \
    return egh_launch<F, float>(p, s, E, e, g, H, stream);                        \
  }
#else
#define STK_EGH_ENTRY_F32(F, NAME)
#endif
#ifndef STK_EGH_ONLY_F32
#define STK_EGH_ENTRY_F64(F, NAME)                                                \
  STK_API int stk_egh_##NAME##_f64(const void* const* p, const double* s,         \
                                   long long E, void* e, void* g, void* H,        \
                                   void* stream) {                                \
    return egh_launch<F, double>(p, s, E, e, g, H, stream);                       \
  }
#else
#define STK_EGH_ENTRY_F64(F, NAME)
#endif
#define STK_EGH_ENTRIES(F, NAME) STK_EGH_ENTRY_F32(F, NAME) STK_EGH_ENTRY_F64(F, NAME)
#else
// the host build: the same element functions, a loop over the rows
template <typename F, typename T>
static int egh_host(const void* const* p, const double* s, long long E, void* e,
                    void* g, void* H) {
  const egh::Args<T> A = egh_args<T>(p, s, E, e, g, H);
  for (long long i = 0; i < E; ++i) {
    if (g != nullptr)
      F::template eval<T, true>(A, i);
    else
      F::template eval<T, false>(A, i);
  }
  return 0;
}
#define STK_EGH_ENTRIES(F, NAME)                                                  \
  STK_API int stk_host_egh_##NAME##_f32(const void* const* p, const double* s,    \
                                        long long E, void* e, void* g, void* H) { \
    return egh_host<F, float>(p, s, E, e, g, H);                                  \
  }                                                                               \
  STK_API int stk_host_egh_##NAME##_f64(const void* const* p, const double* s,    \
                                        long long E, void* e, void* g, void* H) { \
    return egh_host<F, double>(p, s, E, e, g, H);                                 \
  }
#endif
