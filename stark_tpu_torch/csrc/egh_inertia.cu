// Kernel P: e, g and H of the small, block-local families (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for:
//   lumped       lumped inertia        stark_tpu/models/deformables/energies.py:88
//   prescribed   prescribed positions  energies.py:214
//   shells_flat  flat-rest DiscreteShells (Bergou)            energies.py:596
//   rb_linear    rigid linear inertia  models/rigidbodies/inertia.py:43
//   rb_angular   rigid angular inertia inertia.py:57
//   global_points, global_directions
//                the fix joint's penalties  rigidbodies/constraints.py:216, :224
// (the port's twins: stark_tpu_torch/models/deformables/energies.py:83,
// :208, :497; models/rigidbodies/inertia.py:49, :65; constraints.py:123,
// :131). One __global__ template (egh_common.cuh) with one entry point per
// family; each element is a dual over its own DOFs: 3 (one block), 6
// (global points: v and w of one body) or 12 (shells: 4 nodes).
//
// Bound: bytes at the main path's sizes (a 3x3 or 12x12 block written per
// row); the launch latency dominates all of these in practice.
#include "egh_common.cuh"

using namespace egh;

// ---- lumped inertia: p = node, lumped_volume, density, damping,
// is_quasistatic, x0, v0, pt_a, pt_f, gravity (3,), dt () ----
struct FamLumped {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 1, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 3>, T>::type;
    const long long node = ip(A, 0)[i];
    const T dt = *fp(A, 10);
    const Vec<T> x0 = vld(fp(A, 5) + 3 * node), v0 = vld(fp(A, 6) + 3 * node);
    const Vec<T> a = vld(fp(A, 7) + 3 * node), f = vld(fp(A, 8) + 3 * node);
    const Vec<T> grav = vld(fp(A, 9));
    const T mass = fp(A, 1)[i] * fp(A, 2)[i];
    const Vec<S> v1 = dof<S>(A, i, 1, 0, 0);
    const Vec<S> x1{x0.x + dt * v1.x, x0.y + dt * v1.y, x0.z + dt * v1.z};
    const Vec<T> xhat{x0.x + dt * v0.x, x0.y + dt * v0.y, x0.z + dt * v0.z};
    const Vec<S> dev{x1.x - xhat.x, x1.y - xhat.y, x1.z - xhat.z};
    const Vec<S> dev2{x1.x - x0.x, x1.y - x0.y, x1.z - x0.z};
    const S E_in = (T(0.5) * mass) * (vdot(dev, dev) / (dt * dt)
                                      + (vdot(dev2, dev2) * fp(A, 3)[i]) / dt);
    const Vec<T> fx{mass * (a.x + grav.x) + f.x, mass * (a.y + grav.y) + f.y,
                    mass * (a.z + grav.z) + f.z};
    const Vec<S> dv{dt * v1.x, dt * v1.y, dt * v1.z};
    const S E_ext = -vdot(Vec<S>{konst<S>(fx.x), konst<S>(fx.y), konst<S>(fx.z)}, dv);
    write_dual(A, i, fp(A, 4)[i] > T(0.5) ? E_ext + T(0) : E_ext + E_in);
  }
};

// ---- prescribed positions: p = node, target (E, 3), stiffness, x0, dt ----
struct FamPrescribed {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 1, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 3>, T>::type;
    const long long node = ip(A, 0)[i];
    const T dt = *fp(A, 4);
    const Vec<T> x0 = vld(fp(A, 3) + 3 * node), tg = vld(fp(A, 1) + 3 * i);
    const Vec<S> v1 = dof<S>(A, i, 1, 0, 0);
    const Vec<S> d{(x0.x + dt * v1.x) - tg.x, (x0.y + dt * v1.y) - tg.y,
                   (x0.z + dt * v1.z) - tg.z};
    write_dual(A, i, (T(0.5) * fp(A, 2)[i]) * vdot(d, d));
  }
};

// ---- flat-rest DiscreteShells: 0.5 k sum_d x_d^T Q x_d, Q = coef K K^T,
// expanded as the twin's x1^T Q x1 (the factored coef (K . x_d)^2 rounds
// the float64 cloth apart from the CPU port's: 1.05e-8 m in 3 steps on an
// H100, over tests/test_torch_cuda.py's 1e-8). In float32 the positions
// are taken relative to node 0 first: K sums to zero, so Q ignores a
// common shift, and the expanded form's rounding then scales with the
// stencil's size rather than its distance from the origin (with absolute
// positions, the nearly flat 64x64 cloth's e lay at 0.96-1.35x the f32
// rule of chip_smoke.py phase 17 against the f32 twin, as the CG's
// rounding moved the state); float64 keeps the twin's absolute form;
// p = nodes (E, 4), bergou_K (E, 4), bergou_coef, stiffness, x0, dt ----
struct FamShellsFlat {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 4, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 12>, T>::type;
    const T dt = *fp(A, 5);
    const T* K = fp(A, 1) + 4 * i;
    const T coef = fp(A, 2)[i];
    S x[4][3];
    for (int n = 0; n < 4; ++n) {
      const Vec<T> x0 = vld(fp(A, 4) + 3 * ip(A, 0)[4 * i + n]);
      const Vec<S> u = dof<S>(A, i, 4, n, 3 * n);
      x[n][0] = x0.x + dt * u.x;
      x[n][1] = x0.y + dt * u.y;
      x[n][2] = x0.z + dt * u.z;
    }
    if (sizeof(T) == 4) {
      for (int n = 3; n >= 0; --n)
        for (int d = 0; d < 3; ++d) x[n][d] = x[n][d] - x[0][d];
    }
    // sum over the coordinates d of x_d^T (Q x_d), the inner sums in node order
    S acc = konst<S>(T(0));
    for (int d = 0; d < 3; ++d) {
      for (int a = 0; a < 4; ++a) {
        S qx = (coef * (K[a] * K[0])) * x[0][d];
        for (int b = 1; b < 4; ++b) qx = qx + (coef * (K[a] * K[b])) * x[b][d];
        acc = acc + x[a][d] * qx;
      }
    }
    write_dual(A, i, (T(0.5) * fp(A, 3)[i]) * acc);
  }
};

// ---- rigid linear inertia: p = body, mass, damping, is_quasistatic,
// rb_v0, rb_a, rb_force, gravity (3,), dt ----
struct FamRbLinear {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 1, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 3>, T>::type;
    const long long b = ip(A, 0)[i];
    const T dt = *fp(A, 8);
    const T m = fp(A, 1)[i];
    const Vec<T> v0 = vld(fp(A, 4) + 3 * b), a = vld(fp(A, 5) + 3 * b);
    const Vec<T> f = vld(fp(A, 6) + 3 * b), grav = vld(fp(A, 7));
    const Vec<S> v1 = dof<S>(A, i, 1, 0, 0);
    const Vec<S> dev{v1.x - v0.x, v1.y - v0.y, v1.z - v0.z};
    const S E_in = (T(0.5) * m) * vdot(dev, dev)
                   + (((T(0.5) * m) * vdot(v1, v1)) * fp(A, 2)[i]) * dt;
    const Vec<S> fx{konst<S>(m * (a.x + grav.x) + f.x), konst<S>(m * (a.y + grav.y) + f.y),
                    konst<S>(m * (a.z + grav.z) + f.z)};
    const S E_ext = (-dt) * vdot(fx, v1);
    write_dual(A, i, fp(A, 3)[i] > T(0.5) ? E_ext + T(0) : E_ext + E_in);
  }
};

// ---- rigid angular inertia: p = body, damping, is_quasistatic, rb_w0,
// rb_aa, rb_torque, rb_J0glob (B, 3, 3), dt ----
struct FamRbAngular {
  template <typename S, typename T>
  STK_HD static Vec<S> mat_vec(const T* J, const Vec<S>& x) {
    return Vec<S>{(J[0] * x.x + J[1] * x.y) + J[2] * x.z,
                  (J[3] * x.x + J[4] * x.y) + J[5] * x.z,
                  (J[6] * x.x + J[7] * x.y) + J[8] * x.z};
  }
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 1, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 3>, T>::type;
    const long long b = ip(A, 0)[i];
    const T dt = *fp(A, 7);
    const T* J = fp(A, 6) + 9 * b;
    const Vec<T> w0 = vld(fp(A, 3) + 3 * b), aa = vld(fp(A, 4) + 3 * b);
    const Vec<T> tq = vld(fp(A, 5) + 3 * b);
    const Vec<S> w1 = dof<S>(A, i, 1, 0, 0);
    const Vec<S> dev{w1.x - w0.x, w1.y - w0.y, w1.z - w0.z};
    const S E_in = T(0.5) * (vdot(dev, mat_vec(J, dev))
                             + (vdot(w1, mat_vec(J, w1)) * fp(A, 1)[i]) * dt);
    const Vec<T> ja = mat_vec(J, aa);
    const Vec<S> tx{konst<S>(ja.x + tq.x), konst<S>(ja.y + tq.y), konst<S>(ja.z + tq.z)};
    const S E_ext = (-dt) * vdot(tx, w1);
    write_dual(A, i, fp(A, 2)[i] > T(0.5) ? E_ext + T(0) : E_ext + E_in);
  }
};

// ---- global point of a body: 0.5 k |target - x(v, w)|^2 over (v, w);
// p = a (body), loc (E, 3), target (E, 3), stiffness, rb_t0, rb_q0, dt ----
struct FamGlobalPoints {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 2, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 6>, T>::type;
    const long long b = ip(A, 0)[i];
    const T dt = *fp(A, 6);
    const Vec<S> v = dof<S>(A, i, 2, 0, 0);
    const Vec<S> w = dof<S>(A, i, 2, 1, 3);
    const S wv[3] = {w.x, w.y, w.z};
    S R[9];
    rigid_rotation(fp(A, 5) + 4 * b, wv, dt, R);
    const Vec<S> r = rotate(R, fp(A, 1) + 3 * i);
    const Vec<T> t0 = vld(fp(A, 4) + 3 * b), tg = vld(fp(A, 2) + 3 * i);
    const Vec<S> p{(t0.x + dt * v.x) + r.x, (t0.y + dt * v.y) + r.y,
                   (t0.z + dt * v.z) + r.z};
    const Vec<S> d{tg.x - p.x, tg.y - p.y, tg.z - p.z};
    write_dual(A, i, (T(0.5) * fp(A, 3)[i]) * vdot(d, d));
  }
};

// ---- global direction of a body: 0.5 k |target - R(w) d_loc|^2 over w;
// p = a (body), d_loc (E, 3), target (E, 3), stiffness, rb_q0, dt ----
struct FamGlobalDirections {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 1, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 3>, T>::type;
    const long long b = ip(A, 0)[i];
    const T dt = *fp(A, 5);
    const Vec<S> w = dof<S>(A, i, 1, 0, 0);
    const S wv[3] = {w.x, w.y, w.z};
    S R[9];
    rigid_rotation(fp(A, 4) + 4 * b, wv, dt, R);
    const Vec<S> d = rotate(R, fp(A, 1) + 3 * i);
    const Vec<T> tg = vld(fp(A, 2) + 3 * i);
    const Vec<S> u{tg.x - d.x, tg.y - d.y, tg.z - d.z};
    write_dual(A, i, (T(0.5) * fp(A, 3)[i]) * vdot(u, u));
  }
};

STK_EGH_ENTRIES(FamLumped, lumped)
STK_EGH_ENTRIES(FamPrescribed, prescribed)
STK_EGH_ENTRIES(FamShellsFlat, shells_flat)
STK_EGH_ENTRIES(FamRbLinear, rb_linear)
STK_EGH_ENTRIES(FamRbAngular, rb_angular)
STK_EGH_ENTRIES(FamGlobalPoints, global_points)
STK_EGH_ENTRIES(FamGlobalDirections, global_directions)
