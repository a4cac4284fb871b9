// Kernel Q: e, g and H of the lagged-friction families (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for friction_pt_dd, _dr, _rd, _rr and friction_ee_dd, _dr, _rr
// (stark_tpu/models/interactions/contact_energies.py:203-245, the potential
// `friction_potential` :100-122; the port's twins: stark_tpu_torch/models/
// interactions/contact_energies.py).
//
// The potential of a row depends on the DOFs only through the 2-vector
//     ut = (T (vb - va)) dt + (1.13e-9, -1.07e-9),
// T the row's frozen tangent basis (2 x 3), va and vb the velocities of the
// frozen closest points of its two sides: a soft side's weighted DOF blocks
// (bary, or 1 - s and s), linear in u; a rigid side's v + w x R1(w) loc at
// each local point (egh_common.cuh's rigid map), combined with the same
// weights. A thread per row builds ut with its Jacobian J (2 x 3 arity) and,
// for a rigid side, the second derivatives of ut in that body's (v, w) from
// a Dual<T, 6> of the side's velocity; then the potential runs once as a
// Dual<T, 2> over ut (once as T for the value-only form), and
//     g = J^T g_ut,   H = J^T H_ut J + sum_j g_ut,j d2ut_j / d(v, w)^2.
// C0 or C1 (scalar s[0] = 1 for C1) is read at every launch. At u == epsu
// the slide branch is taken, as the twin's where(u < epsu). An inactive row
// is written as exact zeros.
//
// Bound: bytes, up to a 15x15 block written per row against ~60-250
// operations (chip_smoke.py EGH_OPS).
#include "egh_common.cuh"

using namespace egh;

// p = T (E, 2, 3), mu, fn, bary (E, 3) (PT) or s (EE), t (EE), friction_epsv,
// dt, rb_q0, then side A's body and local positions, side B's body and local
// positions (rigid sides only). s[0] = 1 for C1.
template <typename T>
struct SideVel {
  T v[3];        // velocity of the side's frozen closest point
  T coef[3];     // soft: d v_c / d u_(slot0 + k)c
  T g[3][6];     // rigid: d v_c / d (v, w)
  T h[3][21];    // rigid: d2 v_c / d (v, w)^2, packed upper
};

// the potential of ut (contact_energies.friction_potential)
template <typename S, typename T>
STK_HD S friction_energy(const S& ut0, const S& ut1, T mu, T fn, T epsu, int c1) {
  const S u = sqrt_(ut0 * ut0 + ut1 * ut1);
  const T mf = mu * fn;
  if (!c1) {
    if (val(u) < epsu) return ((T(0.5) * (mf / epsu)) * u) * u;
    return mf * (u - epsu / T(2));
  }
  if (val(u) < epsu)
    return mf * (((-((u * u) * u)) / (T(3) * (epsu * epsu)) + (u * u) / epsu) + epsu / T(3));
  return mf * u;
}

template <bool EE, bool RA, bool RB>
struct FamFriction {
  static constexpr int KA = EE ? 2 : 1;
  static constexpr int KB = EE ? 2 : 3;
  static constexpr int SA = RA ? 2 : KA;   // DOF slots of each side
  static constexpr int SB = RB ? 2 : KB;
  static constexpr int ARITY = SA + SB;
  static constexpr int NA = 3 * ARITY;

  // the side's K point velocities combined with its weights: PT A the point
  // itself, PT B bary @ (3 points) as an fma_ chain, EE p0 + s (p1 - p0)
  template <typename S, typename T, int K>
  STK_HD static Vec<S> combine(const Vec<S>* p, const T* w) {
    if constexpr (K == 1) return p[0];
    if constexpr (K == 3)
      return Vec<S>{fma_(p[2].x, w[2], fma_(p[1].x, w[1], p[0].x * w[0])),
                    fma_(p[2].y, w[2], fma_(p[1].y, w[1], p[0].y * w[0])),
                    fma_(p[2].z, w[2], fma_(p[1].z, w[1], p[0].z * w[0]))};
    if constexpr (K == 2) {
      const T s = w[0];
      return Vec<S>{p[0].x + s * (p[1].x - p[0].x), p[0].y + s * (p[1].y - p[0].y),
                    p[0].z + s * (p[1].z - p[0].z)};
    }
  }

  template <typename T, bool D, bool RIGID, int K>
  STK_HD static void side(const Args<T>& A, long long i, int which, int slot0,
                          SideVel<T>& out) {
    const int arity = ARITY;
    // weights: PT A none, PT B bary, EE A s, EE B t
    T w[3] = {T(1), T(0), T(0)};
    if (!EE && which == 1)
      for (int k = 0; k < 3; ++k) w[k] = fp(A, 3)[3 * i + k];
    if (EE) w[0] = fp(A, which == 0 ? 3 : 4)[i];
    if (!RIGID) {
      Vec<T> p[K];
      for (int k = 0; k < K; ++k) p[k] = vld(A.u + 3LL * A.conn[i * arity + slot0 + k]);
      const Vec<T> v = combine<T, T, K>(p, w);
      out.v[0] = v.x;
      out.v[1] = v.y;
      out.v[2] = v.z;
      if constexpr (K == 1) out.coef[0] = T(1);
      if constexpr (K == 3)
        for (int k = 0; k < 3; ++k) out.coef[k] = w[k];
      if constexpr (K == 2) {
        out.coef[0] = T(1) - w[0];
        out.coef[1] = w[0];
      }
      return;
    }
    using S = typename std::conditional<D, Dual<T, 6>, T>::type;
    const T dt = *fp(A, 6);
    const long long b = ip(A, which == 0 ? 8 : 10)[i];
    const T* locs = fp(A, which == 0 ? 9 : 11) + 3 * K * i;
    const Vec<S> v = dof<S>(A, i, arity, slot0, 0);
    const Vec<S> wv = dof<S>(A, i, arity, slot0 + 1, 3);
    const S wa[3] = {wv.x, wv.y, wv.z};
    S R[9];
    rigid_rotation(fp(A, 7) + 4 * b, wa, dt, R);
    Vec<S> p[K];
    for (int k = 0; k < K; ++k) p[k] = vadd(v, vcross(wv, rotate(R, locs + 3 * k)));
    const Vec<S> r = combine<S, T, K>(p, w);
    const S rc[3] = {r.x, r.y, r.z};
    for (int c = 0; c < 3; ++c) {
      out.v[c] = val(rc[c]);
      store(rc[c], out.g[c], out.h[c]);
    }
  }
  template <typename T>
  STK_HD static void store(T, T*, T*) {}
  template <typename T>
  STK_HD static void store(const Dual<T, 6>& r, T* g, T* h) {
    for (int m = 0; m < 6; ++m) g[m] = r.g[m];
    for (int m = 0; m < 21; ++m) h[m] = r.h[m];
  }

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, ARITY, D>(A, i);
    const T dt = *fp(A, 6);
    const T epsu = dt * *fp(A, 5);
    const T mu = fp(A, 1)[i], fn = fp(A, 2)[i];
    const int c1 = A.s[0] != 0.0 ? 1 : 0;
    SideVel<T> sa, sb;
    side<T, D, RA, KA>(A, i, 0, 0, sa);
    side<T, D, RB, KB>(A, i, 1, SA, sb);
    const T vr[3] = {sb.v[0] - sa.v[0], sb.v[1] - sa.v[1], sb.v[2] - sa.v[2]};
    const T* Tm = fp(A, 0) + 6 * i;
    const T pert[2] = {T(1.13 * 1e-9), T(-1.07 * 1e-9)};
    T ut[2];
    for (int j = 0; j < 2; ++j)
      ut[j] = fma_(Tm[3 * j + 2], vr[2], fma_(Tm[3 * j + 1], vr[1], Tm[3 * j] * vr[0])) * dt
              + pert[j];
    if (!D) {
      A.e[i] = friction_energy(ut[0], ut[1], mu, fn, epsu, c1);
      return;
    }
    Dual<T, 2> d0, d1;
    seed(d0, ut[0], 0);
    seed(d1, ut[1], 1);
    const Dual<T, 2> r = friction_energy(d0, d1, mu, fn, epsu, c1);
    // J = d ut / d u (2 x NA); Hr[side][j] = d2 ut_j / d (v, w)^2 of a rigid side
    T J[2][NA];
    for (int j = 0; j < 2; ++j)
      for (int n = 0; n < NA; ++n) J[j][n] = T(0);
    T Hr[2][2][21];
    const SideVel<T>* sv[2] = {&sa, &sb};
    const bool rig[2] = {RA, RB};
    const int s0[2] = {0, SA}, ks[2] = {KA, KB};
    for (int q = 0; q < 2; ++q) {
      const T sgn = q == 0 ? T(-1) : T(1);
      for (int j = 0; j < 2; ++j) {
        const T* tj = Tm + 3 * j;
        if (!rig[q]) {
          for (int k = 0; k < ks[q]; ++k)
            for (int c = 0; c < 3; ++c)
              J[j][3 * (s0[q] + k) + c] = sgn * ((dt * tj[c]) * sv[q]->coef[k]);
          continue;
        }
        for (int m = 0; m < 6; ++m)
          J[j][3 * s0[q] + m] =
              sgn * (dt * ((tj[0] * sv[q]->g[0][m] + tj[1] * sv[q]->g[1][m])
                           + tj[2] * sv[q]->g[2][m]));
        for (int m = 0; m < 21; ++m)
          Hr[q][j][m] = sgn * (dt * ((tj[0] * sv[q]->h[0][m] + tj[1] * sv[q]->h[1][m])
                                     + tj[2] * sv[q]->h[2][m]));
      }
    }
    A.e[i] = r.v;
    T* g = A.g + i * NA;
    for (int n = 0; n < NA; ++n) g[n] = r.g[0] * J[0][n] + r.g[1] * J[1][n];
    const T Hu[2][2] = {{r.h[0], r.h[1]}, {r.h[1], r.h[2]}};
    T* H = A.H + i * NA * NA;
    for (int n = 0; n < NA; ++n)
      for (int m = n; m < NA; ++m) {
        T s = (Hu[0][0] * J[0][n] + Hu[1][0] * J[1][n]) * J[0][m]
              + (Hu[0][1] * J[0][n] + Hu[1][1] * J[1][n]) * J[1][m];
        // a rigid side's curvature: both indices in its (v, w) slots
        for (int q = 0; q < 2; ++q) {
          if (!rig[q]) continue;
          const int a = n - 3 * s0[q], b = m - 3 * s0[q];
          if (a < 0 || a >= 6 || b < 0 || b >= 6) continue;
          const int pk = a * 6 - a * (a - 1) / 2 + (b - a);   // a <= b
          s += r.g[0] * Hr[q][0][pk] + r.g[1] * Hr[q][1][pk];
        }
        H[n * NA + m] = s;
        H[m * NA + n] = s;
      }
  }
};

using FamFrPtDD = FamFriction<false, false, false>;
using FamFrPtDR = FamFriction<false, false, true>;
using FamFrPtRD = FamFriction<false, true, false>;
using FamFrPtRR = FamFriction<false, true, true>;
using FamFrEeDD = FamFriction<true, false, false>;
using FamFrEeDR = FamFriction<true, true, false>;
using FamFrEeRR = FamFriction<true, true, true>;

// ops/build.py compiles this file in four parts, STK_EGH_PART 0 (PT) and 1
// (EE) by dtype; the host build takes all of it
#if !defined(STK_EGH_PART) || STK_EGH_PART == 0
STK_EGH_ENTRIES(FamFrPtDD, friction_pt_dd)
STK_EGH_ENTRIES(FamFrPtDR, friction_pt_dr)
STK_EGH_ENTRIES(FamFrPtRD, friction_pt_rd)
STK_EGH_ENTRIES(FamFrPtRR, friction_pt_rr)
#endif
#if !defined(STK_EGH_PART) || STK_EGH_PART == 1
STK_EGH_ENTRIES(FamFrEeDD, friction_ee_dd)
STK_EGH_ENTRIES(FamFrEeDR, friction_ee_dr)
STK_EGH_ENTRIES(FamFrEeRR, friction_ee_rr)
#endif
