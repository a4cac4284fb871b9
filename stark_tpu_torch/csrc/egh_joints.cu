// Kernels T and U: e, g and H of the rigid joints' penalty families (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for the constraint containers of
// stark_tpu/models/rigidbodies/constraints.py (the port's twins:
// stark_tpu_torch/models/rigidbodies/constraints.py):
//   T, two-body positions over [va, wa, vb, wb] (12 DOFs):
//     points           0.5 k |b1 - a1|^2                          :231
//     point_on_axis    0.5 k |(b1 - a1) x da1|^2 / |da1|^2        :240
//     distances        0.5 k (d - |b1 - a1|)^2                    :253
//     distance_limits  one-sided quadratics below min, above max  :262
//     damped_spring    the spring and 0.5 c ((l1 - l0) / dt)^2    :294
//   U, directions and velocity controllers:
//     directions        0.5 k |db - da|^2 over [wa, wb]           :274
//     angle_limits      k (l - md)^3 / 3 where l > md, l = |db - da|
//                       (safe_norm's floor 1e-30), over [wa, wb]  :283
//     linear_velocity   the C1 force-capped controller on
//                       da1 . (vb - va) over [va, vb, wa]         :310
//     angular_velocity  the same on da1 . (wb - wa) over [wa, wb] :318
// with x1 = t0 + dt v + R(q0, w) loc and d1 = R(q0, w) d_loc (egh_common.cuh's
// rigid map).
//
// Design. T: each side's point (and side a's axis) is a Dual<T, 6> over that
// side's (v, w) only, as kernel Q builds a rigid side's velocity; the
// energy then runs once as a Dual<T, M> over those M = 6 or 9 values (once
// as T for the value-only form, on the same values), and
//     g = J^T g_y,   H = J^T H_y J + sum_j g_y,j d2y_j / d(v, w)^2,
// J the (M x 12) Jacobian, block-sparse by side. A flat Dual<T, 12> (91
// values per scalar) spilled 3.5-4.1 KB in N and O. U: a Dual over the
// element's own 6 or 9 DOFs directly (a rotation over Dual<T, 6> is what
// kernel P's global points do). Kinks take the twin's branch: the
// controller's nested where on dv against -+delay with strict <, the
// limits' strict compares, and safe_norm's clamp, below which the
// derivatives are exact zeros.
//
// Bound: bytes, a 12x12 (T), 6x6 or 9x9 (U) block written per row against
// ~200-450 operations (chip_smoke.py EGH_OPS); the main path's 1-8 rows make
// a launch's latency the time.
#include "egh_common.cuh"

using namespace egh;

// the rigid point (t0 + dt v) + R loc, as kernel P's global points build it
template <typename S, typename T>
STK_HD Vec<S> rigid_point(const T* t0, const Vec<S>& v, const S* R, const T* loc, T dt) {
  const Vec<S> r = rotate(R, loc);
  return Vec<S>{(t0[0] + dt * v.x) + r.x, (t0[1] + dt * v.y) + r.y, (t0[2] + dt * v.z) + r.z};
}

// ---- kernel T: p = a, b, a_loc, b_loc, rb_t0, rb_q0, dt, stiffness, then
// the family's own (point_on_axis: da_loc; distances: target_distance;
// distance_limits: min_distance, max_distance; damped_spring: rest_length,
// damping) ----

// M values y, each a function of one side's 6 DOFs (v, w): y_j's value, its
// gradient and packed Hessian over that side, and the side
template <typename T, int M>
struct SideValues {
  T v[M];
  T g[M][6];
  T h[M][21];
  int side[M];
};
template <typename T, int M>
STK_HD void keep(SideValues<T, M>& y, int j, int side, T v) {
  y.v[j] = v;
  y.side[j] = side;
}
template <typename T, int M>
STK_HD void keep(SideValues<T, M>& y, int j, int side, const Dual<T, 6>& v) {
  y.v[j] = v.v;
  y.side[j] = side;
#pragma unroll
  for (int m = 0; m < 6; ++m) y.g[j][m] = v.g[m];
#pragma unroll
  for (int m = 0; m < 21; ++m) y.h[j][m] = v.h[m];
}

template <typename F, int M>
struct FamTwoBody {
  // side s's point x1 (slots 2 s, 2 s + 1 of [va, wa, vb, wb]) and, for side
  // a with `axis`, its direction d1, into y (x1 at 3 s, d1 at 6)
  template <typename T, typename S>
  STK_HD static void side(const Args<T>& A, long long i, int s, bool axis,
                          SideValues<T, M>& y) {
    const T dt = *fp(A, 6);
    const long long body = ip(A, s)[i];
    const Vec<S> v = dof<S>(A, i, 4, 2 * s, 0);
    const Vec<S> w = dof<S>(A, i, 4, 2 * s + 1, 3);
    const S wv[3] = {w.x, w.y, w.z};
    S R[9];
    rigid_rotation(fp(A, 5) + 4 * body, wv, dt, R);
    const Vec<S> x = rigid_point(fp(A, 4) + 3 * body, v, R, fp(A, 2 + s) + 3 * i, dt);
    keep(y, 3 * s + 0, s, x.x);
    keep(y, 3 * s + 1, s, x.y);
    keep(y, 3 * s + 2, s, x.z);
    if (!axis) return;
    const Vec<S> d = rotate(R, fp(A, 8) + 3 * i);
    keep(y, 6, s, d.x);
    keep(y, 7, s, d.y);
    keep(y, 8, s, d.z);
  }

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 4, D>(A, i);
    using S6 = typename std::conditional<D, Dual<T, 6>, T>::type;
    SideValues<T, M> y;
    side<T, S6>(A, i, 0, M == 9, y);
    side<T, S6>(A, i, 1, false, y);
    if (!D) {
      A.e[i] = F::energy(A, i, y.v);
      return;
    }
    Dual<T, M> yd[M];
#pragma unroll
    for (int j = 0; j < M; ++j) seed(yd[j], y.v[j], j);
    const Dual<T, M> r = F::energy(A, i, yd);
    lift(A, i, r, y);
  }

  // e, g = J^T g_y and H = J^T H_y J + sum_j g_y,j d2y_j: P = H_y J first
  // (M x 12), then the upper triangle of J^T P plus the sides' curvature,
  // mirrored (H exactly symmetric)
  template <typename T>
  STK_HD static void lift(const Args<T>& A, long long i, const Dual<T, M>& r,
                          const SideValues<T, M>& y) {
    constexpr int NA = 12;
    A.e[i] = r.v;
    T* g = A.g + i * NA;
    for (int n = 0; n < NA; ++n) {
      T s = T(0);
      for (int j = 0; j < M; ++j)
        if (n / 6 == y.side[j]) s += r.g[j] * y.g[j][n % 6];
      g[n] = s;
    }
    T P[M][NA];
    for (int j = 0; j < M; ++j)
      for (int n = 0; n < NA; ++n) {
        T s = T(0);
        for (int k = 0; k < M; ++k) {
          if (n / 6 != y.side[k]) continue;
          const int a = j < k ? j : k, b = j < k ? k : j;
          s += r.h[a * M - a * (a - 1) / 2 + (b - a)] * y.g[k][n % 6];
        }
        P[j][n] = s;
      }
    T* H = A.H + i * NA * NA;
    for (int n = 0; n < NA; ++n)
      for (int m = n; m < NA; ++m) {
        T s = T(0);
        for (int j = 0; j < M; ++j)
          if (n / 6 == y.side[j]) s += y.g[j][n % 6] * P[j][m];
        if (n / 6 == m / 6) {
          const int a = n % 6, b = m % 6;
          const int pk = a * 6 - a * (a - 1) / 2 + (b - a);
          for (int j = 0; j < M; ++j)
            if (y.side[j] == n / 6) s += r.g[j] * y.h[j][pk];
        }
        H[n * NA + m] = s;
        H[m * NA + n] = s;
      }
  }
};

// the energies of T over y = (a1, b1[, da1]) as S
template <typename S>
STK_HD Vec<S> b_minus_a(const S* y) {
  return Vec<S>{y[3] - y[0], y[4] - y[1], y[5] - y[2]};
}

struct Points {
  template <typename T, typename S>
  STK_HD static S energy(const Args<T>& A, long long i, const S* y) {
    const Vec<S> d = b_minus_a(y);
    return (T(0.5) * fp(A, 7)[i]) * vdot(d, d);
  }
};
// sq_distance_point_line(b1; a1, a1 + da1) (models/distances.h)
struct PointOnAxis {
  template <typename T, typename S>
  STK_HD static S energy(const Args<T>& A, long long i, const S* y) {
    const Vec<S> da{y[6], y[7], y[8]};
    const Vec<S> cr = vcross(b_minus_a(y), da);
    return (T(0.5) * fp(A, 7)[i]) * (vdot(cr, cr) / vdot(da, da));
  }
};
struct Distances {
  template <typename T, typename S>
  STK_HD static S energy(const Args<T>& A, long long i, const S* y) {
    const S d = fp(A, 8)[i] - safe_norm(b_minus_a(y));
    return (T(0.5) * fp(A, 7)[i]) * (d * d);
  }
};
struct DistanceLimits {
  template <typename T, typename S>
  STK_HD static S energy(const Args<T>& A, long long i, const S* y) {
    const T k = fp(A, 7)[i], lo = fp(A, 8)[i], hi = fp(A, 9)[i];
    const S l = safe_norm(b_minus_a(y));
    const S dl = lo - l, dh = l - hi;
    const S e_min = val(l) < lo ? (k * (dl * dl)) / T(2) : konst<S>(T(0));
    const S e_max = val(l) > hi ? (k * (dh * dh)) / T(2) : konst<S>(T(0));
    return e_min + e_max;
  }
};
// l0 from the step's start, x0 = t0 + R(q0) loc, a constant of the row
struct DampedSpring {
  template <typename T>
  STK_HD static Vec<T> x0(const Args<T>& A, long long i, int s) {
    const long long body = ip(A, s)[i];
    const T* t0 = fp(A, 4) + 3 * body;
    T R[9];
    quat_to_rotation(fp(A, 5) + 4 * body, R);
    const Vec<T> r = rotate(R, fp(A, 2 + s) + 3 * i);
    return Vec<T>{t0[0] + r.x, t0[1] + r.y, t0[2] + r.z};
  }
  template <typename T, typename S>
  STK_HD static S energy(const Args<T>& A, long long i, const S* y) {
    const T dt = *fp(A, 6);
    const T l0 = val(safe_norm(vsub(x0(A, i, 1), x0(A, i, 0))));
    const S l1 = safe_norm(b_minus_a(y));
    const S ds = l1 - fp(A, 8)[i];
    const S rate = (l1 - l0) / dt;
    return (T(0.5) * fp(A, 7)[i]) * (ds * ds) + (T(0.5) * fp(A, 9)[i]) * (rate * rate);
  }
};

using FamPoints = FamTwoBody<Points, 6>;
using FamPointOnAxis = FamTwoBody<PointOnAxis, 9>;
using FamDistances = FamTwoBody<Distances, 6>;
using FamDistanceLimits = FamTwoBody<DistanceLimits, 6>;
using FamDampedSpring = FamTwoBody<DampedSpring, 6>;

// ---- kernel U ----
// the C1 force-capped velocity controller (RigidBodyConstraints.h:56-76) on
// v = da1 . (vb - va): the twin's where(dv < -delay, E_l, where(dv < delay,
// E_c, E_r)), E_l = -E_r
template <typename S, typename T>
STK_HD S c1_controller(const Vec<S>& da1, const Vec<S>& va, const Vec<S>& vb, T target,
                       T max_force, T delay, T dt) {
  const S dv = vdot(da1, vsub(vb, va)) - target;
  const T k = max_force / delay;
  const T eps = delay / T(2);
  if (val(dv) < -delay) return -((max_force * (dv - eps)) * dt);
  if (val(dv) < delay) return (((T(0.5) * k) * dv) * dv) * dt;
  return (max_force * (dv - eps)) * dt;
}

// the body's direction R(q0, w) d_loc
template <typename S, typename T>
STK_HD Vec<S> body_direction(const T* q0, const Vec<S>& w, const T* d_loc, T dt) {
  const S wv[3] = {w.x, w.y, w.z};
  S R[9];
  rigid_rotation(q0, wv, dt, R);
  return rotate(R, d_loc);
}

// directions and angle limits over [wa, wb]: p = a, b, da_loc, db_loc,
// rb_q0, dt, stiffness (, max_distance)
template <bool LIMIT>
struct FamDirections {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 2, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 6>, T>::type;
    const T dt = *fp(A, 5);
    const T* q0 = fp(A, 4);
    const Vec<S> da = body_direction(q0 + 4 * ip(A, 0)[i], dof<S>(A, i, 2, 0, 0),
                                     fp(A, 2) + 3 * i, dt);
    const Vec<S> db = body_direction(q0 + 4 * ip(A, 1)[i], dof<S>(A, i, 2, 1, 3),
                                     fp(A, 3) + 3 * i, dt);
    const Vec<S> u = vsub(db, da);
    const T k = fp(A, 6)[i];
    if (!LIMIT) return write_dual(A, i, (T(0.5) * k) * vdot(u, u));
    // safe_norm(db - da, 1e-30): at rest (db = da) l = 1e-15 with zero
    // derivatives, and the where selects 0
    const T md = fp(A, 7)[i];
    const S l = sqrt_(clamp_min_(vdot(u, u), T(1e-30)));
    const S x = l - md;
    write_dual(A, i, val(l) > md ? (k * ((x * x) * x)) / T(3) : konst<S>(T(0)));
  }
};

// the velocity controllers: p = a, da_loc, rb_q0, dt, target, max, delay;
// linear over [va, vb, wa], angular over [wa, wb] (da1 from wa)
template <bool LINEAR>
struct FamVelocity {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    constexpr int ARITY = LINEAR ? 3 : 2;
    if (!(A.active[i] > T(0.5))) return write_zero<T, ARITY, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 3 * ARITY>, T>::type;
    const T dt = *fp(A, 3);
    const Vec<S> va = dof<S>(A, i, ARITY, 0, 0);
    const Vec<S> vb = dof<S>(A, i, ARITY, 1, 3);
    Vec<S> wa = va;
    if constexpr (LINEAR) wa = dof<S>(A, i, ARITY, 2, 6);
    const Vec<S> da1 = body_direction(fp(A, 2) + 4 * ip(A, 0)[i], wa, fp(A, 1) + 3 * i, dt);
    write_dual(A, i, c1_controller(da1, va, vb, fp(A, 4)[i], fp(A, 5)[i], fp(A, 6)[i], dt));
  }
};

// ops/build.py compiles this file in four parts, STK_EGH_PART 0 (T) and 1
// (U) by dtype; the host build takes all of it
#if !defined(STK_EGH_PART) || STK_EGH_PART == 0
STK_EGH_ENTRIES(FamPoints, points)
STK_EGH_ENTRIES(FamPointOnAxis, point_on_axis)
STK_EGH_ENTRIES(FamDistances, distances)
STK_EGH_ENTRIES(FamDistanceLimits, distance_limits)
STK_EGH_ENTRIES(FamDampedSpring, damped_spring)
#endif
#if !defined(STK_EGH_PART) || STK_EGH_PART == 1
STK_EGH_ENTRIES(FamDirections<false>, directions)
STK_EGH_ENTRIES(FamDirections<true>, angle_limits)
STK_EGH_ENTRIES(FamVelocity<true>, linear_velocity)
STK_EGH_ENTRIES(FamVelocity<false>, angular_velocity)
#endif
