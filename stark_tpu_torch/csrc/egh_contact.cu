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
// The row's 4 points (p, t0, t1, t2 or ea0, ea1, eb0, eb1) are soft (x0 +
// dt u, node table) or on a rigid body (t0 + dt v + R(q(w)) loc,
// egh_common.cuh's rigid map, one body per side). narrow.cuh's classifier
// picks the distance region from the point values (rounding as the twin's,
// so the twin's one-hot select keeps the same candidate), and only that
// region's formula runs. The value-only form is a thread per row over T.
// The derivative form is a warp per row (FamContact::warp_eval): each lane
// carries the formula as a hyper-dual HD<T> (v, d/da, d/db, d2/da db) for
// its entries (a, b) of the 78 of the 12x12 point-space Hessian H_X, and
// the lanes then lift g_X and H_X to the element's DOFs by the chain rule:
//     g_u = J^T g_X,   H_u = J^T H_X J + sum_k g_X,k d2X_k/dw2,
// J = dt I for a soft point and [dt I, dX/dw] for a rigid one, both from a
// Dual<T, 3> of the rigid map over w; the second term is the exact
// curvature of the rotation (the twin's Hessian is exact, not
// Gauss-Newton). Each hyper-dual operation is the Dual<T, 12> formula's
// entry, so the results are bit for bit those of one thread carrying a
// Dual<T, 12> (91 values per intermediate, 3.6-4.2 KB of float32 spills
// per thread on an H100, and a row's latency of 0.25-0.42 ms). The face
// and line-line distances are |l| / |n|, not the twin's sqrt(l^2 / n.n)
// (egh_common.cuh `plane_distance`): the same value, without the float32
// cancellation near contact. The point-edge squared distances are |ap - s
// ab|^2, as the twin's (`projected=True`), not the reference's difference
// of squares, which beside a rigid floor's 2 m edges lost most of a float32
// gap. An inactive row is written as exact zeros by its warp and never
// evaluated (the twin shifts its points, evaluates, then masks).
//
// Bound: bytes, up to a 15x15 block written per row (zeros on the inactive
// rows) against a few hundred operations per live row (chip_smoke.py
// EGH_OPS). A live row's warp does 3 hyper-dual passes of the formula per
// lane (about 10 operations per value operation), and its latency, not
// the card's throughput, sets the launch's time: the live rows are a
// prefix of the table, a warp each.
#include "egh_common.cuh"

using namespace egh;

// p = dhat (E,), contact_k (), dt (), x0 (soft positions), X (soft rest
// positions; EE only), rb_t0, rb_q0, then per side (A: the point or edge a;
// B: the triangle or edge b) its index table and its local positions:
// a soft side gives its node table (both soft: the family's (E, 4) nodes
// for both sides) and no locs, a rigid side its body (E,) and locs (E, k, 3).
// s[0] = 1 for the Log barrier, s[1] = the EE parallel cutoff.
template <typename S, typename T, bool EE>
STK_HD S contact_energy(const Vec<S>* x, int region, T dhat, T k, int logb, T eps_x) {
  const S d = EE ? ee_distance(x, region) : pt_distance(x, region);
  if (!EE) return barrier(d, dhat, k, logb);
  return ee_mollifier(x, eps_x) * barrier(d, dhat, k, logb);
}
// One lane's entry (a, b), a <= b, of the barrier's Hessian over the 12
// point coordinates X (with g_a, g_b and e): one copy per kind and dtype,
// called by every family of the kind (a family's own copy would repeat the
// region formulas in each of the seven kernels)
template <typename T, bool EE>
STK_NOINLINE void contact_pair_egh(const T* X, int region, T dhat, T k, int logb,
                                   T eps_x, int a, int b, HD<T>* r) {
  Vec<HD<T>> x[4];
  for (int p = 0; p < 4; ++p) {
    seed_pair(x[p].x, X[3 * p + 0], a == 3 * p + 0, b == 3 * p + 0);
    seed_pair(x[p].y, X[3 * p + 1], a == 3 * p + 1, b == 3 * p + 1);
    seed_pair(x[p].z, X[3 * p + 2], a == 3 * p + 2, b == 3 * p + 2);
  }
  *r = contact_energy<HD<T>, T, EE>(x, region, dhat, k, logb, eps_x);
}

template <bool EE, bool RA, bool RB>
struct FamContact {
  static constexpr int KA = EE ? 2 : 1;
  static constexpr int KB = EE ? 2 : 3;
  static constexpr int SA = RA ? 2 : KA;   // DOF slots of each side
  static constexpr int SB = RB ? 2 : KB;
  static constexpr int ARITY = SA + SB;
  static constexpr int NA = 3 * ARITY;
  static constexpr int NPAIR = 78;         // entries (a, b), a <= b, of a 12x12
  static constexpr bool WARP_ROWS = true;

  // the value-only form's points
  template <typename T>
  struct Points {
    T X[12];          // world positions
    T Xr[12];         // rest positions (the mollifier's)
  };
  // a row's scratch in shared memory, written and read by its warp's lanes
  template <typename T>
  struct Row {
    T X[12];
    T Xr[12];
    T Jw[4][3][3];    // dX_c / dw_m of a rigid point
    T Hw[4][3][6];    // d2X_c / dw dw of a rigid point (packed upper)
    T gX[12];         // the barrier's gradient over X
    T HX[12][12];     // and its Hessian
    T HJ[12][NA];     // HX J, J = dX / du
    int sv[4];        // slot of the soft block or the body's v block
    int sw[4];        // slot of the body's w block, -1 for a soft point
  };

  // points j0 .. j1-1 of a side (D: with the rigid map's derivatives in w)
  template <typename T, bool D, bool RIGID, int K, typename P>
  STK_HD static void place(const Args<T>& A, long long i, int side, int slot0, int first,
                           int j0, int j1, P& pts) {
    const T dt = *fp(A, 2);
    if (!RIGID) {
      const int stride = (!RA && !RB) ? KA + KB : K;
      const int col0 = (!RA && !RB && side == 1) ? KA : 0;
      const long long* nodes = ip(A, side == 0 ? 7 : 9);
      for (int j = j0; j < j1; ++j) {
        const long long node = nodes[i * stride + col0 + j];
        const T* u = A.u + 3LL * A.conn[i * ARITY + slot0 + j];
        const T* x0 = fp(A, 3) + 3 * node;
        for (int c = 0; c < 3; ++c) pts.X[3 * (first + j) + c] = x0[c] + dt * u[c];
        if (EE)
          for (int c = 0; c < 3; ++c) pts.Xr[3 * (first + j) + c] = fp(A, 4)[3 * node + c];
        if constexpr (D) {
          pts.sv[first + j] = slot0 + j;
          pts.sw[first + j] = -1;
        }
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
    for (int j = j0; j < j1; ++j) {
      const Vec<S> r = rotate(R, locs + 3 * j);
      const S rc[3] = {r.x, r.y, r.z};
      for (int c = 0; c < 3; ++c) {
        pts.X[3 * (first + j) + c] = t1[c] + val(rc[c]);
        pts.Xr[3 * (first + j) + c] = locs[3 * j + c];
        if constexpr (D) store_w(rc[c], pts.Jw[first + j][c], pts.Hw[first + j][c]);
      }
      if constexpr (D) {
        pts.sv[first + j] = slot0;
        pts.sw[first + j] = slot0 + 1;
      }
    }
  }
  // the rigid map's derivatives in w (only the derivative form keeps them)
  template <typename T>
  STK_HD static void store_w(const Dual<T, 3>& r, T* jw, T* hw) {
    for (int m = 0; m < 3; ++m) jw[m] = r.g[m];
    for (int m = 0; m < 6; ++m) hw[m] = r.h[m];
  }

  // the region of the points' values (narrow.cuh, rounding as the twin's)
  // and the mollifier's eps_x from the rest positions
  template <typename T>
  STK_HD static int region_of(const Args<T>& A, const T* X) {
    const V3<T> p0{X[0], X[1], X[2]}, p1{X[3], X[4], X[5]};
    const V3<T> p2{X[6], X[7], X[8]}, p3{X[9], X[10], X[11]};
    return EE ? edge_edge_region(p0, p1, p2, p3, T(A.s[1]))
              : point_triangle_region(p0, p1, p2, p3);
  }
  template <typename T>
  STK_HD static T eps_of(const T* Xr) {
    if (!EE) return T(0);
    const Vec<T> ra = vsub(vld(Xr + 0), vld(Xr + 3));
    const Vec<T> rb = vsub(vld(Xr + 6), vld(Xr + 9));
    return (T(1e-3) * vdot(ra, ra)) * vdot(rb, rb);
  }

  // the value-only form: a thread per row
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if constexpr (D) {
      Row<T> R;   // the host build's derivative form: the warp's steps in turn
      warp_eval<T>(A, i, 0, R);
    } else {
      if (!(A.active[i] > T(0.5))) return write_zero<T, ARITY, false>(A, i);
      Points<T> P;
      place<T, false, RA, KA>(A, i, 0, 0, 0, 0, KA, P);
      place<T, false, RB, KB>(A, i, 1, SA, KA, 0, KB, P);
      const Vec<T> x[4] = {vld(P.X + 0), vld(P.X + 3), vld(P.X + 6), vld(P.X + 9)};
      A.e[i] = contact_energy<T, T, EE>(x, region_of(A, P.X), fp(A, 0)[i], *fp(A, 1),
                                        A.s[0] != 0.0 ? 1 : 0, eps_of(P.Xr));
    }
  }

  // The derivative form: a warp per row. Lanes 0-3 place a point each;
  // every lane evaluates the region formula as hyper-duals for its entries
  // (a, b) of H_X (lane, lane + 32, lane + 64 < 78); then the lift to the
  // element's DOFs, g_u = J^T g_X, H_u = J^T H_X J + sum_k g_X,k d2X_k/dw2,
  // by structure: J's block of a point is dt I (a soft point, a body's v)
  // or its 3x3 Jw (a body's w), so HJ = H_X J and J^T HJ sum only those
  // blocks, in the order of a dense product's nonzero terms. A lane writes
  // entries lane, lane + 32, .. of the row's g and H (coalesced), each H
  // entry computed as its upper-triangle twin (H exactly symmetric).
  template <typename T>
  STK_HD static void warp_eval(const Args<T>& A, long long i, int lane, Row<T>& R) {
    if (!(A.active[i] > T(0.5))) {
      STK_LANES(zero_lane(A, i, lane));
      return;
    }
    STK_LANES(place_lane(A, i, lane, R));
    STK_LANES(pair_lane(A, i, lane, R));
    STK_LANES(hj_lane(A, lane, R));
    STK_LANES(lift_lane(A, i, lane, R));
  }
  template <typename T>
  STK_HD static void zero_lane(const Args<T>& A, long long i, int lane) {
    if (lane == 0) A.e[i] = T(0);
    for (int n = lane; n < NA; n += STK_WARP) A.g[i * NA + n] = T(0);
    for (int n = lane; n < NA * NA; n += STK_WARP) A.H[i * NA * NA + n] = T(0);
  }
  template <typename T>
  STK_HD static void place_lane(const Args<T>& A, long long i, int lane, Row<T>& R) {
    if (lane < KA)
      place<T, true, RA, KA>(A, i, 0, 0, 0, lane, lane + 1, R);
    else if (lane < 4)
      place<T, true, RB, KB>(A, i, 1, SA, KA, lane - KA, lane - KA + 1, R);
  }
  template <typename T>
  STK_HD static void pair_lane(const Args<T>& A, long long i, int lane, Row<T>& R) {
    const int region = region_of(A, R.X);
    const T eps_x = eps_of(R.Xr);
    const T dhat = fp(A, 0)[i], k = *fp(A, 1);
    const int logb = A.s[0] != 0.0 ? 1 : 0;
    for (int kk = lane; kk < NPAIR; kk += STK_WARP) {
      int a = 0, rest = kk;
      while (rest >= 12 - a) rest -= 12 - a++;
      const int b = a + rest;
      HD<T> r;
      contact_pair_egh<T, EE>(R.X, region, dhat, k, logb, eps_x, a, b, &r);
      R.HX[a][b] = r.ab;
      R.HX[b][a] = r.ab;
      if (a == b) R.gX[a] = r.a;
      if (kk == 0) A.e[i] = r.v;
    }
  }
  template <typename T>
  STK_HD static void hj_lane(const Args<T>& A, int lane, Row<T>& R) {
    const T dt = *fp(A, 2);
    for (int n = lane; n < 12 * NA; n += STK_WARP) {
      const int a = n / NA, m = n % NA, s = m / 3, j = m % 3;
      T acc = T(0);
      for (int q = 0; q < 4; ++q) {
        if (R.sv[q] == s) {
          acc += R.HX[a][3 * q + j] * dt;
        } else if (R.sw[q] == s) {
          for (int c = 0; c < 3; ++c) acc += R.HX[a][3 * q + c] * R.Jw[q][c][j];
        }
      }
      R.HJ[a][m] = acc;
    }
  }
  // row n of J^T (a point's block of the lift: dt, or Jw's column) times
  // the 12-vector col(a) = HJ[a][m] or g_X[a]
  template <typename T>
  STK_HD static T jt_times(const Row<T>& R, T dt, int n, const T* col, int stride) {
    const int s = n / 3, c0 = n % 3;
    T acc = T(0);
    for (int p = 0; p < 4; ++p) {
      if (R.sv[p] == s) {
        acc += dt * col[(3 * p + c0) * stride];
      } else if (R.sw[p] == s) {
        for (int c = 0; c < 3; ++c) acc += R.Jw[p][c][c0] * col[(3 * p + c) * stride];
      }
    }
    return acc;
  }
  template <typename T>
  STK_HD static void lift_lane(const Args<T>& A, long long i, int lane, Row<T>& R) {
    const T dt = *fp(A, 2);
    for (int idx = lane; idx < NA * NA; idx += STK_WARP) {
      int n = idx / NA, m = idx % NA;
      if (n > m) {
        const int t = n;
        n = m;
        m = t;
      }
      T h = jt_times(R, dt, n, &R.HJ[0][m], NA);
      // the rotation's curvature: both indices in one body's w block
      if (n / 3 == m / 3) {
        const int mn = n % 3, ml = m % 3;   // mn <= ml
        const int pk = mn * 3 - mn * (mn - 1) / 2 + (ml - mn);
        for (int p = 0; p < 4; ++p)
          if (R.sw[p] == n / 3)
            for (int c = 0; c < 3; ++c) h += R.gX[3 * p + c] * R.Hw[p][c][pk];
      }
      A.H[i * NA * NA + idx] = h;
    }
    if (lane < NA) A.g[i * NA + lane] = jt_times(R, dt, lane, R.gX, 1);
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
