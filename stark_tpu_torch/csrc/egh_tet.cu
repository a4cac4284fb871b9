// Kernel S: e, g and H of TetStrain, the Stable Neo-Hookean solid (K11).
//
// Replaces the jax.vmap(jax.hessian(e_fn)) of stark_tpu/solver/assembly.py:
// 117-135 for EnergyTetStrain (stark_tpu/models/deformables/energies.py:
// 733) and its elasticity-only variant (:757); the port's twins are
// stark_tpu_torch/models/deformables/energies.py EnergyTetStrain. The terms:
// the Stable Neo-Hookean density [Smith et al. 2022, eq. 49], the
// strain-rate damping against the constant Green strain of x0, and the
// strain limit on the proxy trE / 3 + sqrt(2/3) |dev E| of the largest
// principal strain; FULL = false keeps the elastic density only.
//
// Every term is a function of F1 = Dx1 DXinv alone, and F1 is linear in the
// DOFs: dF_ij / du_nc = dt delta_ic B_nj, with B_0j = -sum_k DXinv_kj and
// B_(k+1)j = DXinv_kj. A thread per tet runs the energy once as a
// Dual<T, 9> over F1's entries (egh_common.cuh), and once as T for the
// value-only form, then lifts by the chain rule, the usual FEM form:
//     g_nc = dt sum_j g_F,cj B_nj,
//     H_nc,md = dt^2 sum_jk H_F,cj,dk B_nj B_mk,
// exact since F1 is linear in u. At rest dev E is 0 to rounding, so
// safe_sqrt's clamp holds on the whole mesh: clamp_min_ takes the twin's
// branch and derivative there (egh_common.cuh). The determinant is the
// cofactor expansion along the first row, as the twin's det3 (JAX's LU
// determinant rounds otherwise, within the stated tolerances).
//
// Bound: bytes, one 12x12 block written per tet against ~250 operations
// (chip_smoke.py EGH_OPS). The 9-wide dual spills: this design's cost.
#include "egh_common.cuh"

using namespace egh;

// p = nodes (E, 4), DXinv (E, 3, 3), rest_volume, youngs_modulus,
// poissons_ratio, strain_damping, strain_limit, strain_limit_stiffness, x0, dt
template <bool FULL>
struct FamTet {
  // M = A^T A (3x3, row major), a column-sum order fma_ chain as
  // the twin's F^T @ F
  template <typename S>
  STK_HD static void gram(const S F[3][3], S M[3][3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        M[a][b] = fma_(F[2][a], F[2][b], fma_(F[1][a], F[1][b], F[0][a] * F[0][b]));
  }

  template <typename S, typename T>
  STK_HD static S energy(const S F[3][3], const Args<T>& A, long long i, T dt,
                         const T F0[3][3]) {
    const T E = fp(A, 3)[i], nu = fp(A, 4)[i];
    const T mu = E / (T(2) * (T(1) + nu));
    const T lam = (E * nu) / ((T(1) + nu) * (T(1) - T(2) * nu));
    const T mu_ = T(4.0 / 3.0) * mu;
    const T lam_ = lam + T(5.0 / 6.0) * mu;
    const S det = (F[0][0] * (F[1][1] * F[2][2] - F[1][2] * F[2][1])
                   - F[0][1] * (F[1][0] * F[2][2] - F[1][2] * F[2][0]))
                  + F[0][2] * (F[1][0] * F[2][1] - F[1][1] * F[2][0]);
    S Ic = F[0][0] * F[0][0];
#pragma unroll
    for (int k = 1; k < 9; ++k) Ic = Ic + F[k / 3][k % 3] * F[k / 3][k % 3];
    const T alpha = (T(1) + mu_ / lam_) - mu_ / (T(4) * lam_);
    const S dd = det - alpha;
    const S elastic = ((T(0.5) * mu_) * (Ic - T(3)) + (T(0.5) * lam_) * (dd * dd))
                      - (T(0.5) * mu_) * log_(Ic + T(1));
    const T vol = fp(A, 2)[i];
    if (!FULL) return vol * elastic;
    S C1[3][3];
    T C0[3][3];
    gram(F, C1);
    gram(F0, C0);
    // the Green strain, its rate against x0's, and the deviator's square
    // norm, each summed in row-major order (loops unrolled: with a Dual
    // the card's build of these loops gave a wrong energy rolled)
    S E1[3][3], rate[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T id = T(a == b ? 1 : 0);
        E1[a][b] = T(0.5) * (C1[a][b] - id);
        rate[a][b] = (E1[a][b] - T(0.5) * (C0[a][b] - id)) / dt;
      }
    S rsq = rate[0][0] * rate[0][0];
#pragma unroll
    for (int k = 1; k < 9; ++k) rsq = rsq + rate[k / 3][k % 3] * rate[k / 3][k % 3];
    const S damping = (T(0.5) * fp(A, 5)[i]) * rsq;
    const S trE = (E1[0][0] + E1[1][1]) + E1[2][2];
    const S third = trE / T(3);
    S dev[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) dev[a][b] = a == b ? E1[a][b] - third : E1[a][b];
    S dsq = dev[0][0] * dev[0][0];
#pragma unroll
    for (int k = 1; k < 9; ++k) dsq = dsq + dev[k / 3][k % 3] * dev[k / 3][k % 3];
    const S largest = third + T(0.816496580927726) * safe_sqrt(dsq);
    const S limit = cubic_one_sided(largest - fp(A, 6)[i], fp(A, 7)[i]);
    return vol * ((elastic + damping) + limit);
  }

  template <typename T, bool D>
  STK_HD static void eval(const Args<T>& A, long long i) {
    if (!(A.active[i] > T(0.5))) return write_zero<T, 4, D>(A, i);
    const T dt = *fp(A, 9);
    const T* Di = fp(A, 1) + 9 * i;   // DXinv, row major
    const long long* nodes = ip(A, 0) + 4 * i;
    T x0[4][3], x1[4][3];
    for (int n = 0; n < 4; ++n) {
      const T* p = fp(A, 8) + 3 * nodes[n];
      const T* u = A.u + 3LL * A.conn[4 * i + n];
      for (int c = 0; c < 3; ++c) {
        x0[n][c] = p[c];
        x1[n][c] = p[c] + dt * u[c];
      }
    }
    // F = Dx DXinv, Dx's columns x_k - x_0 (k = 1..3), each entry an fma_
    // chain in column order as the twin's matmul
    T F1[3][3], F0[3][3];
    for (int r = 0; r < 3; ++r)
      for (int j = 0; j < 3; ++j) {
        const T a0 = x1[1][r] - x1[0][r], a1 = x1[2][r] - x1[0][r], a2 = x1[3][r] - x1[0][r];
        const T b0 = x0[1][r] - x0[0][r], b1 = x0[2][r] - x0[0][r], b2 = x0[3][r] - x0[0][r];
        F1[r][j] = fma_(a2, Di[6 + j], fma_(a1, Di[3 + j], a0 * Di[j]));
        F0[r][j] = fma_(b2, Di[6 + j], fma_(b1, Di[3 + j], b0 * Di[j]));
      }
    if (!D) {
      A.e[i] = energy(F1, A, i, dt, F0);
      return;
    }
    Dual<T, 9> F[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) seed(F[r][j], F1[r][j], 3 * r + j);
    const Dual<T, 9> res = energy(F, A, i, dt, F0);
    // B (4 x 3): dF_rj / du_nr = dt B_nj
    T B[4][3];
    for (int j = 0; j < 3; ++j) {
      B[0][j] = -((Di[j] + Di[3 + j]) + Di[6 + j]);
      for (int k = 0; k < 3; ++k) B[k + 1][j] = Di[3 * k + j];
    }
    A.e[i] = res.v;
    T* g = A.g + 12 * i;
    for (int n = 0; n < 4; ++n)
      for (int r = 0; r < 3; ++r) {
        T s = T(0);
        for (int j = 0; j < 3; ++j) s += res.g[3 * r + j] * B[n][j];
        g[3 * n + r] = dt * s;
      }
    T HF[9][9];
    int k = 0;
    for (int a = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b, ++k) HF[a][b] = HF[b][a] = res.h[k];
    const T dt2 = dt * dt;
    T* H = A.H + 144 * i;
    for (int r = 0; r < 3; ++r)
      for (int q = 0; q < 3; ++q) {
        // HB[j][m] = sum_k HF[(r,j),(q,k)] B[m][k]
        T HB[3][4];
        for (int j = 0; j < 3; ++j)
          for (int m = 0; m < 4; ++m) {
            T s = T(0);
            for (int kk = 0; kk < 3; ++kk) s += HF[3 * r + j][3 * q + kk] * B[m][kk];
            HB[j][m] = s;
          }
        for (int n = 0; n < 4; ++n)
          for (int m = 0; m < 4; ++m) {
            T s = T(0);
            for (int j = 0; j < 3; ++j) s += B[n][j] * HB[j][m];
            H[(3 * n + r) * 12 + 3 * m + q] = dt2 * s;
          }
      }
    // exact symmetry (the (r, q) and (q, r) blocks round alike only up to
    // the order of their sums)
    for (int a = 0; a < 12; ++a)
      for (int b = a + 1; b < 12; ++b) {
        const T s = T(0.5) * (H[a * 12 + b] + H[b * 12 + a]);
        H[a * 12 + b] = H[b * 12 + a] = s;
      }
  }
};

using FamTetFull = FamTet<true>;
using FamTetEO = FamTet<false>;

STK_EGH_ENTRIES(FamTetFull, tet)
STK_EGH_ENTRIES(FamTetEO, tet_eo)
