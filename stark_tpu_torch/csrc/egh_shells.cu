// Kernel V: e, g and H of full DiscreteShells bending (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for stark_tpu/models/deformables/energies.py:581 `_energy_full`
// (the port's twin: stark_tpu_torch/models/deformables/energies.py
// EnergyDiscreteShells._energy_full; EnergyDiscreteShells.cpp:28-62):
//     E = k (theta1 - theta_rest)^2 r + (c / dt) (theta1^2 / 2 - theta0 theta1) r,
// r = (l_rest s) / (h_rest s), theta the dihedral angle across the edge
// (x0, x1) with wings x2, x3: acos((1 - 100 eps) n0^ . n1^), n0 = e0 x e1,
// n1 = -(e0 x e2), eps of the element's type (1 - 1e-12 rounds to 1 in
// float32). theta0, at the step's start, is a constant computed by the same
// operations as theta1.
//
// Design: theta depends on x1 only through the three edges e0, e1, e2 from
// x1_0 (x1 = x0 + dt u). A thread per row runs the energy once as a
// Dual<T, 9> over the edges (55 values per scalar; a flat Dual<T, 12> has
// 91) and lifts e, g and H to the 12 node DOFs by de/du = dt [-I I 0 0; -I 0
// I 0; -I 0 0 I]. The value-only form runs the same operations on T. At a
// flat edge acos's slope is 1/sqrt(1 - x^2) ~ 1/sqrt(200 eps): 205 in
// float32, 6.7e6 in float64; its derivative is written as the twin's,
// -1 / sqrt(1 - x x).
//
// Bound: bytes, a 12x12 block written per row against ~300 operations
// (chip_smoke.py EGH_OPS).
#include "egh_common.cuh"

using namespace egh;

template <typename T>
STK_HD T type_eps();
template <>
STK_HD float type_eps<float>() {
  return 1.1920928955078125e-07f;
}
template <>
STK_HD double type_eps<double>() {
  return 2.220446049250313e-16;
}

template <typename T>
STK_HD T acos_(T x) {
  return acos(x);
}
// f' = -1 / sqrt(1 - x^2), f'' = x f'^3: h = f' a.h + (x f') (f' g)(f' g)^T
template <typename T, int N>
STK_HD Dual<T, N> acos_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = acos(a.v);
  const T f1 = T(-1) / sqrt(T(1) - a.v * a.v);
  for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
  const T c2 = a.v * f1;
  int k = 0;
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j, ++k) r.h[k] = f1 * a.h[k] + c2 * (r.g[i] * r.g[j]);
  }
  return r;
}

template <typename S>
STK_HD Vec<S> normalized(const Vec<S>& v) {
  const S n = safe_norm(v);
  return Vec<S>{v.x / n, v.y / n, v.z / n};
}

// maths.dihedral_angle over the edges e0 = x1 - x0, e1 = x2 - x0, e2 = x3 - x0
template <typename S>
STK_HD S dihedral(const Vec<S>& e0, const Vec<S>& e1, const Vec<S>& e2) {
  using T = decltype(val(e0.x));
  const Vec<S> n0 = vcross(e0, e1);
  const Vec<S> m1 = vcross(e0, e2);
  const Vec<S> n1{-m1.x, -m1.y, -m1.z};
  const S c = vdot(normalized(n0), normalized(n1));
  return acos_((T(1) - T(100) * type_eps<T>()) * c);
}

// p = nodes (E, 4), rest_dihedral_angle, rest_edge_length, rest_height,
// scale, stiffness, damping, x0, dt
struct FamShells {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 4, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 9>, T>::type;
    const T dt = *fp(A, 8);
    const long long* nodes = ip(A, 0) + 4 * i;
    Vec<T> x0[4], x1[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      x0[n] = vld(fp(A, 7) + 3 * nodes[n]);
      const Vec<T> u = vld(A.u + 3 * A.conn[4 * i + n]);
      x1[n] = Vec<T>{x0[n].x + dt * u.x, x0[n].y + dt * u.y, x0[n].z + dt * u.z};
    }
    Vec<S> e[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Vec<T> d = vsub(x1[a + 1], x1[0]);
      seed(e[a].x, d.x, 3 * a + 0);
      seed(e[a].y, d.y, 3 * a + 1);
      seed(e[a].z, d.z, 3 * a + 2);
    }
    const S theta1 = dihedral(e[0], e[1], e[2]);
    const T theta0 = dihedral(vsub(x0[1], x0[0]), vsub(x0[2], x0[0]), vsub(x0[3], x0[0]));
    const T scale = fp(A, 4)[i];
    const T ratio = (fp(A, 2)[i] * scale) / (fp(A, 3)[i] * scale);
    const S dd = theta1 - fp(A, 1)[i];
    const S e_bend = ((fp(A, 5)[i] * dd) * dd) * ratio;
    const S e_damp = ((fp(A, 6)[i] / dt) * ((T(0.5) * theta1) * theta1 - theta0 * theta1)) * ratio;
    lift(A, i, e_bend + e_damp, dt);
  }

  template <typename T>
  STK_HD static void lift(const Args<T>& A, long long i, T r, T) {
    A.e[i] = r;
  }
  // node n's DOF (n, c) sees edge a's coordinate c with weight L(n, a): node 0
  // -1 on every edge, node n > 0 +1 on edge n - 1; g = dt L^T g_e and H = dt^2
  // L^T H_e L, its upper triangle mirrored
  template <typename T>
  STK_HD static void lift(const Args<T>& A, long long i, const Dual<T, 9>& r, T dt) {
    A.e[i] = r.v;
    T* g = A.g + i * 12;
    for (int c = 0; c < 3; ++c) {
      g[c] = -(dt * ((r.g[c] + r.g[3 + c]) + r.g[6 + c]));
      for (int n = 1; n < 4; ++n) g[3 * n + c] = dt * r.g[3 * (n - 1) + c];
    }
    auto he = [&](int p, int q) {   // the 9x9 H_e from the packed upper triangle
      const int a = p < q ? p : q, b = p < q ? q : p;
      return r.h[a * 9 - a * (a - 1) / 2 + (b - a)];
    };
    const T dt2 = dt * dt;
    T* H = A.H + i * 144;
    for (int p = 0; p < 12; ++p)
      for (int q = p; q < 12; ++q) {
        const int n = p / 3, c = p % 3, m = q / 3, d = q % 3;
        T s = T(0);
        for (int a = 0; a < 3; ++a) {
          if (n != 0 && a != n - 1) continue;
          for (int b = 0; b < 3; ++b) {
            if (m != 0 && b != m - 1) continue;
            const T w = (n == 0) == (m == 0) ? T(1) : T(-1);
            s += w * he(3 * a + c, 3 * b + d);
          }
        }
        H[p * 12 + q] = dt2 * s;
        H[q * 12 + p] = dt2 * s;
      }
  }
};

STK_EGH_ENTRIES(FamShells, shells)
