// Kernel M: e, g and H of TriangleStrain, the 2D Neo-Hookean membrane (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for EnergyTriangleStrain (stark_tpu/models/deformables/
// energies.py:468) and its elasticity-only variant (:485); the port's twins
// are stark_tpu_torch/models/deformables/energies.py:337-391. The terms: the
// Neo-Hookean energy with log J, the strain-rate damping, the strain limit
// through the closed-form 2x2 eigenvalues of the Green strain, and
// inflation; FULL = false keeps the elastic and inflation terms only. A
// thread per triangle runs the energy once as a Dual<T, 9> over its three
// DOF blocks (egh_common.cuh), and once as T for the value-only form.
//
// Bound: bytes, one 9x9 block written per element against the few hundred
// operations the function needs (chip_smoke.py EGH_OPS). The 9-wide dual
// does far more than that (it updates every packed Hessian entry at every
// step): that is this design's cost, not the bound.
#include "egh_common.cuh"

using namespace egh;

// p = nodes (E, 3), DXinv (E, 2, 2), rest_area, thickness, youngs_modulus,
// poissons_ratio, strain_damping, strain_limit, strain_limit_stiffness,
// inflation, x0, dt
template <bool FULL>
struct FamStrain {
  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 3, D>(A, i);
    using S = typename std::conditional<D, Dual<T, 9>, T>::type;
    const T dt = *fp(A, 11);
    const T* Di = fp(A, 1) + 4 * i;   // DXinv, row major
    const T rest_area = fp(A, 2)[i];
    Vec<T> x0[3];
    Vec<S> x1[3];
    for (int n = 0; n < 3; ++n) {
      x0[n] = vld(fp(A, 10) + 3 * ip(A, 0)[3 * i + n]);
      const Vec<S> u = dof<S>(A, i, 3, n, 3 * n);
      x1[n] = Vec<S>{x0[n].x + dt * u.x, x0[n].y + dt * u.y, x0[n].z + dt * u.z};
    }
    // F1 = [x1_1 - x1_0, x1_2 - x1_0] DXinv (3x2), C1 = F1^T F1, their sums
    // through fma_ (egh_common.cuh)
    const Vec<S> c0 = vsub(x1[1], x1[0]), c1 = vsub(x1[2], x1[0]);
    const S dx[3][2] = {{c0.x, c1.x}, {c0.y, c1.y}, {c0.z, c1.z}};
    S F[3][2];
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 2; ++j) F[k][j] = fma_(dx[k][1], Di[2 + j], dx[k][0] * Di[j]);
    S C[2][2];
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b)
        C[a][b] = fma_(F[2][a], F[2][b], fma_(F[1][a], F[1][b], F[0][a] * F[0][b]));
    const S area = T(0.5) * safe_norm(vcross(vsub(x1[0], x1[2]), vsub(x1[1], x1[2])));
    const S J = clamp_min_(area / rest_area, T(1e-12));
    // elastic density
    const T e = fp(A, 4)[i], nu = fp(A, 5)[i];
    const T mu = e / (T(2) * (T(1) + nu));
    const T lam = (e * nu) / ((T(1) + nu) * (T(1) - nu));
    const S Ic = C[0][0] + C[1][1];
    const S logJ = log_(J);
    const S elastic = ((T(0.5) * mu) * (Ic - T(2)) - mu * logJ)
                      + ((T(0.5) * lam) * logJ) * logJ;
    // inflation: inflation * n0 . (sum of the node displacements) / 3
    const Vec<T> nr = vcross(vsub(x0[1], x0[0]), vsub(x0[2], x0[0]));
    const T nn = safe_norm(nr);
    const Vec<T> n0{-(nr.x / nn), -(nr.y / nn), -(nr.z / nn)};
    const Vec<S> ddx = vadd(vadd(vsub(x1[0], Vec<S>{konst<S>(x0[0].x), konst<S>(x0[0].y),
                                                    konst<S>(x0[0].z)}),
                                 vsub(x1[1], Vec<S>{konst<S>(x0[1].x), konst<S>(x0[1].y),
                                                    konst<S>(x0[1].z)})),
                            vsub(x1[2], Vec<S>{konst<S>(x0[2].x), konst<S>(x0[2].y),
                                               konst<S>(x0[2].z)}));
    const S inflation = (fp(A, 9)[i] * vdot(Vec<S>{konst<S>(n0.x), konst<S>(n0.y),
                                                   konst<S>(n0.z)}, ddx)) / T(3);
    const T scale = fp(A, 3)[i] * rest_area;
    if (!FULL) return write_dual(A, i, scale * (elastic + inflation));
    // strain-rate damping: E1 = (C1 - I) / 2, E0 the same at x0
    const Vec<T> d0 = vsub(x0[1], x0[0]), d1 = vsub(x0[2], x0[0]);
    const T dx0[3][2] = {{d0.x, d1.x}, {d0.y, d1.y}, {d0.z, d1.z}};
    T F0[3][2];
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 2; ++j) F0[k][j] = dx0[k][0] * Di[j] + dx0[k][1] * Di[2 + j];
    S E1[2][2];
    T E0[2][2];
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b) {
        const T c0ab = (F0[0][a] * F0[0][b] + F0[1][a] * F0[1][b]) + F0[2][a] * F0[2][b];
        E1[a][b] = T(0.5) * (C[a][b] - T(a == b ? 1 : 0));
        E0[a][b] = T(0.5) * (c0ab - T(a == b ? 1 : 0));
      }
    S rate[2][2];
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b) rate[a][b] = (E1[a][b] - E0[a][b]) / dt;
    const S rsq = ((rate[0][0] * rate[0][0] + rate[0][1] * rate[0][1])
                   + rate[1][0] * rate[1][0]) + rate[1][1] * rate[1][1];
    const S damping = (T(0.5) * fp(A, 6)[i]) * rsq;
    // strain limit on the principal strains
    S s0, s1;
    eigenvalues_sym_2x2(E1[0][0], E1[0][1], E1[1][1], &s0, &s1);
    const T lim = fp(A, 7)[i], klim = fp(A, 8)[i];
    const S limit = cubic_one_sided(s0 - lim, klim) + cubic_one_sided(s1 - lim, klim);
    write_dual(A, i, scale * (((elastic + damping) + limit) + inflation));
  }
};

using FamStrainFull = FamStrain<true>;
using FamStrainEO = FamStrain<false>;

STK_EGH_ENTRIES(FamStrainFull, strain)
STK_EGH_ENTRIES(FamStrainEO, strain_eo)
