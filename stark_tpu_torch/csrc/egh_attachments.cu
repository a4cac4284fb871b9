// Kernel W: e, g and H of the five attachment families (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for stark_tpu/models/interactions/attachments.py's penalties (the
// port's twins: stark_tpu_torch/models/interactions/attachments.py), with
// x1 = x0 + dt u at a soft node:
//   att_pp   0.5 k |x1_b - x1_a|^2                               :89
//   att_pe   0.5 k |b0 x1_e0 + b1 x1_e1 - x1_p|^2                :94
//   att_pt   0.5 k |b0 x1_t0 + b1 x1_t1 + b2 x1_t2 - x1_p|^2     :100
//   att_ee   0.5 k |(b1 . eb) - (b0 . ea)|^2                     :106
//   att_rbd  0.5 k |x1_d - (t0 + dt v + R(q0, w) loc)|^2          :113
//
// Design. The four soft families are quadratic in u with constant weights:
// with w the signed weights ((-1, 1), (-1, b0, b1), (-1, b0, b1, b2),
// (-a0, -a1, b0, b1)) and d = sum_i w_i x1_i, computed in the twin's order
// of operations, e = 0.5 k d.d, g_i = k dt w_i d and H = k dt^2 (w w^T) x I3:
// a closed form, no duals. att_rbd takes the rigid point as a Dual<T, 6> over
// the body's (v, w), as kernel P's global points do, and lifts the result to
// the 9x9 block with the soft node's three DOFs, whose derivatives are exact
// and linear:
//   g_u = k dt d,  g_q = -k sum_c d_c dxr_c,
//   H_uu = k dt^2 I3,  H_uq = -k dt dxr_c,
//   H_qq = k sum_c (dxr_c dxr_c^T - d_c d2xr_c).
// The value-only form runs the same operations on the values, so its e is
// the derivative form's bit for bit. `stiffness` is read per row at every
// call: the converged-state check hardens it between Newton solves.
//
// Bound: bytes (a 6x6 to 12x12 block written per row against ~30-150
// operations, chip_smoke.py EGH_OPS); the example's few hundred rows make a
// launch's latency the time.
#include "egh_common.cuh"

using namespace egh;

// ---- the soft families: p = nodes (E, ARITY), stiffness, x0, dt, then
// bary (E, 2 or 3) or bary0, bary1 (E, 2) ----
enum { ATT_PP = 0, ATT_PE = 1, ATT_PT = 2, ATT_EE = 3 };

template <int KIND>
struct FamAttach {
  static constexpr int ARITY = KIND == ATT_PP ? 2 : KIND == ATT_PE ? 3 : 4;

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, ARITY, D>(A, i);
    const long long* nodes = ip(A, 0) + ARITY * i;
    const T k = fp(A, 1)[i];
    const T dt = *fp(A, 3);
    Vec<T> x[ARITY];
    for (int n = 0; n < ARITY; ++n) {
      const Vec<T> x0 = vld(fp(A, 2) + 3 * nodes[n]);
      const T* u = A.u + 3 * A.conn[ARITY * i + n];
      x[n] = Vec<T>{x0.x + dt * u[0], x0.y + dt * u[1], x0.z + dt * u[2]};
    }
    T w[ARITY];
    Vec<T> d;
    if constexpr (KIND == ATT_PP) {
      w[0] = T(-1);
      w[1] = T(1);
      d = vsub(x[1], x[0]);
    } else if constexpr (KIND == ATT_EE) {
      const T* a = fp(A, 4) + 2 * i;
      const T* b = fp(A, 5) + 2 * i;
      const Vec<T> p{a[0] * x[0].x + a[1] * x[1].x, a[0] * x[0].y + a[1] * x[1].y,
                     a[0] * x[0].z + a[1] * x[1].z};
      const Vec<T> q{b[0] * x[2].x + b[1] * x[3].x, b[0] * x[2].y + b[1] * x[3].y,
                     b[0] * x[2].z + b[1] * x[3].z};
      w[0] = -a[0];
      w[1] = -a[1];
      w[2] = b[0];
      w[3] = b[1];
      d = vsub(q, p);
    } else {
      // q = b0 x1 + b1 x2 (+ b2 x3), left to right as the twin adds
      const T* b = fp(A, 4) + (ARITY - 1) * i;
      Vec<T> q{b[0] * x[1].x, b[0] * x[1].y, b[0] * x[1].z};
      w[0] = T(-1);
      w[1] = b[0];
      for (int n = 2; n < ARITY; ++n) {
        q = Vec<T>{q.x + b[n - 1] * x[n].x, q.y + b[n - 1] * x[n].y,
                   q.z + b[n - 1] * x[n].z};
        w[n] = b[n - 1];
      }
      d = vsub(q, x[0]);
    }
    A.e[i] = (T(0.5) * k) * vdot(d, d);
    if (!D) return;
    constexpr int NA = 3 * ARITY;
    const T dc[3] = {d.x, d.y, d.z};
    const T kdt = k * dt;
    T* g = A.g + i * NA;
    T* H = A.H + i * NA * NA;
    for (int n = 0; n < ARITY; ++n)
      for (int c = 0; c < 3; ++c) g[3 * n + c] = (kdt * w[n]) * dc[c];
    const T kdt2 = kdt * dt;
    for (int r = 0; r < NA; ++r)
      for (int s = r; s < NA; ++s) {
        const int a = r / 3, b = s / 3;   // a <= b: mirrored, H exactly symmetric
        const T h = r % 3 == s % 3 ? (kdt2 * w[a]) * w[b] : T(0);
        H[r * NA + s] = h;
        H[s * NA + r] = h;
      }
  }
};

// ---- a soft node glued to a body-local point: p = node, stiffness, x0, dt,
// body, loc (E, 3), rb_t0, rb_q0; DOFs [node, rb v, rb w] ----
struct FamAttachRbd {
  template <typename T>
  STK_HD static void write(const Args<T>& A, long long i, T e, const T*, const Vec<T>*,
                           T, T) {
    A.e[i] = e;
  }
  // the 9x9 lift of the rigid point's Dual<T, 6> (see the head of the file)
  template <typename T>
  STK_HD static void write(const Args<T>& A, long long i, T e, const T* dc,
                           const Vec<Dual<T, 6>>* xr, T k, T dt) {
    constexpr int NA = 9;
    A.e[i] = e;
    const Dual<T, 6>* r[3] = {&xr->x, &xr->y, &xr->z};
    T* g = A.g + i * NA;
    T* H = A.H + i * NA * NA;
    const T kdt = k * dt;
    for (int c = 0; c < 3; ++c) g[c] = kdt * dc[c];
    for (int j = 0; j < 6; ++j) {
      T s = T(0);
      for (int c = 0; c < 3; ++c) s += dc[c] * r[c]->g[j];
      g[3 + j] = -k * s;
    }
    const T kdt2 = kdt * dt;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) H[a * NA + b] = a == b ? kdt2 : T(0);
    for (int c = 0; c < 3; ++c)
      for (int j = 0; j < 6; ++j) {
        const T h = -kdt * r[c]->g[j];
        H[c * NA + 3 + j] = h;
        H[(3 + j) * NA + c] = h;
      }
    int p = 0;
    for (int j = 0; j < 6; ++j)
      for (int l = j; l < 6; ++l, ++p) {
        T s = T(0);
        for (int c = 0; c < 3; ++c) s += r[c]->g[j] * r[c]->g[l] - dc[c] * r[c]->h[p];
        H[(3 + j) * NA + 3 + l] = k * s;
        H[(3 + l) * NA + 3 + j] = k * s;
      }
  }

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 3, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 6>, T>::type;
    const long long node = ip(A, 0)[i], b = ip(A, 4)[i];
    const T k = fp(A, 1)[i];
    const T dt = *fp(A, 3);
    const Vec<T> x0 = vld(fp(A, 2) + 3 * node);
    const T* ud = A.u + 3 * A.conn[3 * i];
    const Vec<T> xd{x0.x + dt * ud[0], x0.y + dt * ud[1], x0.z + dt * ud[2]};
    const Vec<S> v = dof<S>(A, i, 3, 1, 0);
    const Vec<S> w = dof<S>(A, i, 3, 2, 3);
    const S wv[3] = {w.x, w.y, w.z};
    S R[9];
    rigid_rotation(fp(A, 7) + 4 * b, wv, dt, R);
    const Vec<S> r = rotate(R, fp(A, 5) + 3 * i);
    const Vec<T> t0 = vld(fp(A, 6) + 3 * b);
    const Vec<S> xr{(t0.x + dt * v.x) + r.x, (t0.y + dt * v.y) + r.y,
                    (t0.z + dt * v.z) + r.z};
    const Vec<T> d{xd.x - val(xr.x), xd.y - val(xr.y), xd.z - val(xr.z)};
    const T dc[3] = {d.x, d.y, d.z};
    write(A, i, (T(0.5) * k) * vdot(d, d), dc, &xr, k, dt);
  }
};

STK_EGH_ENTRIES(FamAttach<ATT_PP>, att_pp)
STK_EGH_ENTRIES(FamAttach<ATT_PE>, att_pe)
STK_EGH_ENTRIES(FamAttach<ATT_PT>, att_pt)
STK_EGH_ENTRIES(FamAttach<ATT_EE>, att_ee)
STK_EGH_ENTRIES(FamAttachRbd, att_rbd)
