// Kernel R: e, g and H of SegmentStrain, the rod stretching energy (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for EnergySegmentStrain (stark_tpu/models/deformables/
// energies.py:349) and its elasticity-only variant (:360); the port's twins
// are stark_tpu_torch/models/deformables/energies.py EnergySegmentStrain.
// The terms: the stretch (l1 - l_rest) / l_rest through safe_norm, the
// one-sided cubic strain limit, and the strain-rate damping against the
// constant strain of x0; FULL = false keeps the stretch only.
//
// The energy depends on the DOFs u (two velocity blocks) only through
// d = x1_0 - x1_1, x1 = x0 + dt u. A thread per segment runs the energy
// once as a Dual<T, 3> over d (egh_common.cuh), and once as T for the
// value-only form; d's map from u is the constant [dt I, -dt I], so
//     g = [dt g_d, -dt g_d],   H = [[dt^2 H_d, -dt^2 H_d], [-dt^2 H_d, dt^2 H_d]]
// exactly (no second-order term).
//
// Bound: bytes, one 6x6 block written per segment against ~50 operations
// (chip_smoke.py EGH_OPS).
#include "egh_common.cuh"

using namespace egh;

// p = nodes (E, 2), l_rest, section_radius, youngs_modulus, strain_damping,
// strain_limit, strain_limit_stiffness, x0, dt
template <bool FULL>
struct FamSegment {
  template <typename S, typename T>
  STK_HD static S energy(const Vec<S>& d, const Args<T>& A, long long i, T dt,
                         const Vec<T>& x0a, const Vec<T>& x0b) {
    const T l_rest = fp(A, 1)[i];
    const T r = fp(A, 2)[i];
    const S e = (safe_norm(d) - l_rest) / l_rest;
    const T volume = (T(3.141592653589793) * (r * r)) * l_rest;
    const S stretch = (((volume * fp(A, 3)[i]) * e) * e) / T(2);
    if (!FULL) return stretch;
    const S eo = e - fp(A, 5)[i];
    const S limit = val(eo) > T(0) ? ((volume * fp(A, 6)[i]) * ((eo * eo) * eo)) / T(3)
                                   : konst<S>(T(0));
    const T e0 = (safe_norm(vsub(x0b, x0a)) - l_rest) / l_rest;
    const S q = (e - e0) / dt;
    const S damping = ((dt * fp(A, 4)[i]) * (q * q)) / T(2);
    return (stretch + limit) + damping;
  }

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 2, D>(A, i);
    const T dt = *fp(A, 8);
    const long long* nodes = ip(A, 0) + 2 * i;
    const Vec<T> x0a = vld(fp(A, 7) + 3 * nodes[0]), x0b = vld(fp(A, 7) + 3 * nodes[1]);
    const T* ua = A.u + 3LL * A.conn[2 * i];
    const T* ub = A.u + 3LL * A.conn[2 * i + 1];
    const T dv[3] = {(x0a.x + dt * ua[0]) - (x0b.x + dt * ub[0]),
                     (x0a.y + dt * ua[1]) - (x0b.y + dt * ub[1]),
                     (x0a.z + dt * ua[2]) - (x0b.z + dt * ub[2])};
    if (!D) {
      A.e[i] = energy(Vec<T>{dv[0], dv[1], dv[2]}, A, i, dt, x0a, x0b);
      return;
    }
    Vec<Dual<T, 3>> d;
    seed(d.x, dv[0], 0);
    seed(d.y, dv[1], 1);
    seed(d.z, dv[2], 2);
    const Dual<T, 3> r = energy(d, A, i, dt, x0a, x0b);
    A.e[i] = r.v;
    T* g = A.g + 6 * i;
    for (int c = 0; c < 3; ++c) {
      g[c] = dt * r.g[c];
      g[3 + c] = -(dt * r.g[c]);
    }
    T* H = A.H + 36 * i;
    int k = 0;
    for (int a = 0; a < 3; ++a)
      for (int b = a; b < 3; ++b, ++k) {
        const T h = dt * (dt * r.h[k]);
        H[a * 6 + b] = H[b * 6 + a] = h;
        H[(a + 3) * 6 + b + 3] = H[(b + 3) * 6 + a + 3] = h;
        H[a * 6 + b + 3] = H[(b + 3) * 6 + a] = -h;
        H[b * 6 + a + 3] = H[(a + 3) * 6 + b] = -h;
      }
  }
};

using FamSegmentFull = FamSegment<true>;
using FamSegmentEO = FamSegment<false>;

STK_EGH_ENTRIES(FamSegmentFull, segment)
STK_EGH_ENTRIES(FamSegmentEO, segment_eo)
