// Kernels N and O: e, g and H of the frictionless IPC contact families (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for the contact families of stark_tpu/models/interactions/
// contact_energies.py (the port's twins: stark_tpu_torch/models/
// interactions/contact_energies.py):
//   N, the point-triangle barrier (`_pt_barrier` :124; distance
//      collision/narrow_phase.py:162), contact_pt_dd, _dr, _rd, _rr (:161-179);
//   O, the edge-edge barrier times the mollifier (`_ee_barrier` :132;
//      narrow_phase.py:328, :383), contact_ee_dd, _dr, _rr (:180-200).
// The barrier is contact_energies.py:67's, Cubic or Log (scalar s[0]).
//
// A thread per row. The row's 4 points (p, t0, t1, t2 or ea0, ea1, eb0, eb1)
// are soft (x0 + dt u, node table) or on a rigid body (t0 + dt v + R(q(w))
// loc, egh_common.cuh's rigid map, one body per side). narrow.cuh's
// classifier picks the distance region from the point values (rounding as
// the twin's, so the twin's one-hot select keeps the same candidate), and
// only that region's formula runs: as T for the value-only form, and as a
// Dual<T, 12> over the 12 point coordinates (one function per kind and
// dtype, shared by the families) for e, g and H, which then lift to the
// element's DOFs by the chain rule:
//     g_u = J^T g_X,   H_u = J^T H_X J + sum_k g_X,k d2X_k/dw2,
// J = dt I for a soft point and [dt I, dX/dw] for a rigid one, both from a
// Dual<T, 3> of the rigid map over w; the second term is the exact
// curvature of the rotation (the twin's Hessian is exact, not
// Gauss-Newton). The face and line-line distances are |l| / |n|, not the
// twin's sqrt(l^2 / n.n) (egh_common.cuh `plane_distance`): the same
// value, without the float32 cancellation near contact. The point-edge
// squared distances are |ap - s ab|^2, as the twin's (`projected=True`),
// not the reference's difference of squares, which beside a rigid floor's
// 2 m edges lost most of a float32 gap. An inactive row
// is written as exact zeros and never evaluated (the twin shifts its
// points, evaluates, then masks).
//
// Bound: bytes, up to a 15x15 block written per row (zeros on the inactive
// rows) against a few hundred operations per live row (chip_smoke.py
// EGH_OPS). The 12-wide dual through the region formula and the mollifier,
// and the dense 12 x 3a lift, do far more: this design's cost, not the
// bound.
#include "egh_common.cuh"

using namespace egh;

// p = dhat (E,), contact_k (), dt (), x0 (soft positions), X (soft rest
// positions; EE only), rb_t0, rb_q0, then per side (A: the point or edge a;
// B: the triangle or edge b) its index table and its local positions:
// a soft side gives its node table (both soft: the family's (E, 4) nodes
// for both sides) and no locs, a rigid side its body (E,) and locs (E, k, 3).
// s[0] = 1 for the Log barrier, s[1] = the EE parallel cutoff.
// e, g and H of the barrier over the 12 point coordinates: one copy per
// kind and dtype, called by every family of the kind (a family's own dual
// over its DOFs would be a 9- to 15-wide copy of the same formulas in each
// of the seven kernels, and nvcc's build of them took 6 minutes)
template <typename S, typename T, bool EE>
STK_HD S contact_energy(const Vec<S>* x, int region, T dhat, T k, int logb, T eps_x) {
  const S d = EE ? ee_distance(x, region) : pt_distance(x, region);
  if (!EE) return barrier(d, dhat, k, logb);
  return ee_mollifier(x, eps_x) * barrier(d, dhat, k, logb);
}
template <typename T, bool EE>
STK_NOINLINE void contact_point_egh(const T* X, int region, T dhat, T k, int logb,
                                    T eps_x, Dual<T, 12>* r) {
  Vec<Dual<T, 12>> x[4];
  for (int p = 0; p < 4; ++p) {
    seed(x[p].x, X[3 * p + 0], 3 * p + 0);
    seed(x[p].y, X[3 * p + 1], 3 * p + 1);
    seed(x[p].z, X[3 * p + 2], 3 * p + 2);
  }
  *r = contact_energy<Dual<T, 12>, T, EE>(x, region, dhat, k, logb, eps_x);
}

template <bool EE, bool RA, bool RB>
struct FamContact {
  static constexpr int KA = EE ? 2 : 1;
  static constexpr int KB = EE ? 2 : 3;
  static constexpr int SA = RA ? 2 : KA;   // DOF slots of each side
  static constexpr int SB = RB ? 2 : KB;
  static constexpr int ARITY = SA + SB;
  static constexpr int NA = 3 * ARITY;

  template <typename T>
  struct Points {
    T X[12];          // world positions
    T Xr[12];         // rest positions (the mollifier's)
    T Jw[4][3][3];    // dX_c / dw_m of a rigid point
    T Hw[4][3][6];    // d2X_c / dw dw of a rigid point (packed upper)
    int sv[4];        // slot of the soft block or the body's v block
    int sw[4];        // slot of the body's w block, -1 for a soft point
  };

  template <typename T, bool D, bool RIGID, int K>
  STK_HD static void place(const Args<T>& A, long long i, int side, int slot0,
                           int first, Points<T>& P) {
    const T dt = *fp(A, 2);
    if (!RIGID) {
      const int stride = (!RA && !RB) ? KA + KB : K;
      const int col0 = (!RA && !RB && side == 1) ? KA : 0;
      const long long* nodes = ip(A, side == 0 ? 7 : 9);
      for (int j = 0; j < K; ++j) {
        const long long node = nodes[i * stride + col0 + j];
        const T* u = A.u + 3LL * A.conn[i * ARITY + slot0 + j];
        const T* x0 = fp(A, 3) + 3 * node;
        for (int c = 0; c < 3; ++c) P.X[3 * (first + j) + c] = x0[c] + dt * u[c];
        if (EE)
          for (int c = 0; c < 3; ++c) P.Xr[3 * (first + j) + c] = fp(A, 4)[3 * node + c];
        P.sv[first + j] = slot0 + j;
        P.sw[first + j] = -1;
      }
      return;
    }
    using S = typename std::conditional<D, Dual<T, 3>, T>::type;
    const long long b = ip(A, side == 0 ? 7 : 9)[i];
    const T* locs = fp(A, side == 0 ? 8 : 10) + 3 * K * i;
    const T* v = A.u + 3LL * A.conn[i * ARITY + slot0];
    const T* wu = A.u + 3LL * A.conn[i * ARITY + slot0 + 1];
    S w[3];
    for (int m = 0; m < 3; ++m) seed(w[m], wu[m], m);
    S R[9];
    rigid_rotation(fp(A, 6) + 4 * b, w, dt, R);
    const T* t0 = fp(A, 5) + 3 * b;
    const T t1[3] = {t0[0] + dt * v[0], t0[1] + dt * v[1], t0[2] + dt * v[2]};
    for (int j = 0; j < K; ++j) {
      const Vec<S> r = rotate(R, locs + 3 * j);
      const S rc[3] = {r.x, r.y, r.z};
      for (int c = 0; c < 3; ++c) {
        P.X[3 * (first + j) + c] = t1[c] + val(rc[c]);
        P.Xr[3 * (first + j) + c] = locs[3 * j + c];
        store_w<D>(rc[c], P.Jw[first + j][c], P.Hw[first + j][c]);
      }
      P.sv[first + j] = slot0;
      P.sw[first + j] = slot0 + 1;
    }
  }
  // the rigid map's derivatives in w (only the derivative form keeps them)
  template <bool D, typename T>
  STK_HD static void store_w(T, T*, T*) {}
  template <bool D, typename T>
  STK_HD static void store_w(const Dual<T, 3>& r, T* jw, T* hw) {
    for (int m = 0; m < 3; ++m) jw[m] = r.g[m];
    for (int m = 0; m < 6; ++m) hw[m] = r.h[m];
  }

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, ARITY, D>(A, i);
    const T dhat = fp(A, 0)[i], k = *fp(A, 1), dt = *fp(A, 2);
    const int logb = A.s[0] != 0.0 ? 1 : 0;
    Points<T> P;
    place<T, D, RA, KA>(A, i, 0, 0, 0, P);
    place<T, D, RB, KB>(A, i, 1, SA, KA, P);
    const V3<T> p0{P.X[0], P.X[1], P.X[2]}, p1{P.X[3], P.X[4], P.X[5]};
    const V3<T> p2{P.X[6], P.X[7], P.X[8]}, p3{P.X[9], P.X[10], P.X[11]};
    const int region = EE ? edge_edge_region(p0, p1, p2, p3, T(A.s[1]))
                          : point_triangle_region(p0, p1, p2, p3);
    T eps_x = T(0);
    if (EE) {
      const Vec<T> ra = vsub(vld(P.Xr + 0), vld(P.Xr + 3));
      const Vec<T> rb = vsub(vld(P.Xr + 6), vld(P.Xr + 9));
      eps_x = (T(1e-3) * vdot(ra, ra)) * vdot(rb, rb);
    }
    if (!D) {
      const Vec<T> x[4] = {vld(P.X + 0), vld(P.X + 3), vld(P.X + 6), vld(P.X + 9)};
      A.e[i] = contact_energy<T, T, EE>(x, region, dhat, k, logb, eps_x);
      return;
    }
    Dual<T, 12> r;
    contact_point_egh<T, EE>(P.X, region, dhat, k, logb, eps_x, &r);
    lift(A, i, P, r, dt);
  }

  // g_u = J^T g_X, H_u = J^T H_X J + the rigid points' curvature terms, J
  // = dt I for a soft point, [dt I, dX/dw] for a rigid one
  template <typename T>
  STK_HD static void lift(const Args<T>& A, long long i, const Points<T>& P,
                          const Dual<T, 12>& r, T dt) {
    T J[12][NA];
    for (int a = 0; a < 12; ++a)
      for (int n = 0; n < NA; ++n) J[a][n] = T(0);
    for (int p = 0; p < 4; ++p)
      for (int c = 0; c < 3; ++c) {
        J[3 * p + c][3 * P.sv[p] + c] = dt;
        if (P.sw[p] >= 0)
          for (int m = 0; m < 3; ++m) J[3 * p + c][3 * P.sw[p] + m] = P.Jw[p][c][m];
      }
    T HX[12][12];
    int kk = 0;
    for (int a = 0; a < 12; ++a)
      for (int b = a; b < 12; ++b, ++kk) HX[a][b] = HX[b][a] = r.h[kk];
    A.e[i] = r.v;
    T* g = A.g + i * NA;
    for (int n = 0; n < NA; ++n) {
      T s = T(0);
      for (int a = 0; a < 12; ++a) s += J[a][n] * r.g[a];
      g[n] = s;
    }
    T HJ[12][NA];
    for (int a = 0; a < 12; ++a)
      for (int m = 0; m < NA; ++m) {
        T s = T(0);
        for (int b = 0; b < 12; ++b) s += HX[a][b] * J[b][m];
        HJ[a][m] = s;
      }
    T* H = A.H + i * NA * NA;
    for (int n = 0; n < NA; ++n)
      for (int m = n; m < NA; ++m) {
        T s = T(0);
        for (int a = 0; a < 12; ++a) s += J[a][n] * HJ[a][m];
        // the rotation's curvature: both indices in one body's w block
        const int bn = n / 3, bm = m / 3;
        if (bn == bm) {
          const int mn = n % 3, ml = m % 3;   // mn <= ml
          const int pk = mn * 3 - mn * (mn - 1) / 2 + (ml - mn);
          for (int p = 0; p < 4; ++p)
            if (P.sw[p] == bn)
              for (int c = 0; c < 3; ++c) s += r.g[3 * p + c] * P.Hw[p][c][pk];
        }
        H[n * NA + m] = s;
        H[m * NA + n] = s;
      }
  }
};

using FamPtDD = FamContact<false, false, false>;
using FamPtDR = FamContact<false, false, true>;
using FamPtRD = FamContact<false, true, false>;
using FamPtRR = FamContact<false, true, true>;
using FamEeDD = FamContact<true, false, false>;
using FamEeDR = FamContact<true, true, false>;
using FamEeRR = FamContact<true, true, true>;

// ops/build.py compiles this file in four parts, STK_EGH_PART 0 (PT) and 1
// (EE) by dtype; the host build takes all of it
#if !defined(STK_EGH_PART) || STK_EGH_PART == 0
STK_EGH_ENTRIES(FamPtDD, pt_dd)
STK_EGH_ENTRIES(FamPtDR, pt_dr)
STK_EGH_ENTRIES(FamPtRD, pt_rd)
STK_EGH_ENTRIES(FamPtRR, pt_rr)
#endif
#if !defined(STK_EGH_PART) || STK_EGH_PART == 1
STK_EGH_ENTRIES(FamEeDD, ee_dd)
STK_EGH_ENTRIES(FamEeDR, ee_dr)
STK_EGH_ENTRIES(FamEeRR, ee_rr)
#endif
