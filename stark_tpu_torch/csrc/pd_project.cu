// Kernels C and Z: per-matrix PD projection by parallel-order cyclic Jacobi.
//
// Kernel C replaces stark_tpu/solver/project.py `_jacobi_eigh` (:53-113)
// together with `project_family_to_pd` (:122-141): eigen-decompose each
// symmetric d x d element Hessian with a fixed number of sweeps, clamp (or
// mirror) eigenvalues below eps, and rebuild V diag(w) V^T for the elements
// that changed.
//
// Kernel Z is the same rotations in two more modes (ops/pd_project.py
// `pd_project_z`). It replaces the exact-eigh branch of `batched_eigh`
// (:116-119: jacobi_sweeps = 0, and every d <= 3), which the card cannot
// run inside the fused solve's CUDA graph (cuSOLVER reads the device), and
// `_jacobi_eigh` at d > 64:
//   * converged mode: before every sweep each matrix copies its upper
//     triangle into the lower one and tests the entries above the
//     diagonal, |a_ik| <= tol max_j |a_jj| (tol the dtype's machine
//     epsilon: eigh's own normwise accuracy); once all pass it runs one
//     more sweep, which squares what the test left (Jacobi converges
//     quadratically), as kernel C's sweeps past convergence do, and stops;
//     at most `sweeps` (30) sweeps in all. The copy: JAX's row-then-column
//     form leaves rounding residue of eps |A| in the lower triangle, which
//     rotations within a near-degenerate cluster carry back into the upper
//     one sweep after sweep (without it the soft boxes' f64 blocks took up
//     to 30 sweeps, with it at most 13). The relative test |a_ik| <= tol
//     sqrt|a_ii a_kk| cannot be met where an eigenvalue is (numerically)
//     zero more than once, as for a tet's rigid modes: entries of 1e-17
//     between them stay against a bound of 1e-33. A matrix that never
//     passed the test adds one to `*unconverged` (an integer atomic: the
//     count is exact), which the solve reads with its one host read and
//     raises on. Each matrix loops on its own flag: the warp (or, in the
//     wide layout, the block) agrees on it with a vote, so no host read and
//     no grid-wide step is needed inside a graph.
//   * wide layouts, d > 64: one block per matrix (a block walks over
//     matrices when there are more than its grid).
//     - shared (`pd_project_shared_kernel`, wherever A and V fit: d <= 119
//       in f64, d <= 169 in f32): 1024 threads; A and V in shared memory
//       with an odd row stride (d | 1, so a column walk hits 32 banks),
//       with the round's cosines, sines and pairs and the clamped
//       eigenvalues. A round applies each rotation in place by pair: the
//       thread owning the 2 x 2 block of row pair u and column pair v reads
//       its four entries of A, rotates the rows, then the columns, in
//       registers, and writes them back (the same products and sums as the
//       row pass and the column pass of the other layouts); the thread of
//       (row i, column pair v) rotates V's two entries. Two block barriers
//       a round: after the angles, after the rotations.
//     - global (`pd_project_global_kernel`, larger d): 256 threads, A, V
//       and two scratch copies in a global scratch buffer (4 d^2 values
//       per block), the rest in shared memory; every row and column pass of
//       a round is split across the block's warps, with a block barrier
//       between passes.
//     Both wide layouts round each product and sum as the twin's separate
//     tensor operations do (rn_mul, rn_add: no FMA contraction), so that
//     their rotations, their stop tests and the sweeps each matrix runs
//     are the twin's on the card; the warp layouts, shared with kernel C,
//     keep nvcc's contraction.
//
// The shared-memory layouts: one warp owns one matrix. A, its eigenvector
// accumulator V and two scratch copies live in dynamic shared memory: four
// warps share a block for d <= 16 (at most 4 x 256 values per warp); for
// 16 < d <= 64 (user families of more than five nodes) a block holds one
// warp, whose lanes take rows i, i + 32.
// Each round of the round-robin schedule (the host passes `sched[r][i]`, the
// partner of row i in round r, i itself for a bye; built by
// `_round_robin_rounds`, project.py:31-50) applies floor(d/2) disjoint
// rotations at once, with the same arithmetic as the JAX form:
//   theta = 0.5 * atan2(2 a_pq, a_qq - a_pp),  c = cos theta, s = sin theta
//   B  = c_row * A + s_row * A[perm, :]        (s_row = -s for p, +s for q)
//   A' = c_col * B + s_col * B[:, perm]
//   V' = c_col * V + s_col * V[:, perm]
// Both rows of a pair compute the same (c, s) from the same A, so a round
// needs no extra exchange between lanes. After the sweeps the diagonal
// holds the eigenvalues; below = w < eps, the element is selected when any
// eigenvalue is below and `elem_mask` (optional) allows it, and only then is
// V diag(w') V^T written; otherwise the input is copied through.
//
// Bound: operations. A sweep costs ~9 d^2 flops per round over d rounds
// (plus d/2 atan2/cos/sin), about 52 kflop per 9x9 matrix at 8 sweeps,
// against 2 x 81 values of traffic. Design: shared memory keeps every
// sweep's traffic on chip; a warp per matrix keeps the rounds in lockstep
// with only __syncwarp between the row and column passes. The converged
// test costs d^2 compares per sweep, under a tenth of a sweep's work. The
// shared wide layout reads and writes 2 d^2 values of shared memory a round
// (at d = 96 in f32: 95 rounds a sweep, ~37 k accesses, ~1.2 k cycles of
// an SM's shared bandwidth), besides its two barriers and the angles' chain
// of atan2, cos and sin; one matrix is one SM's work. The global layout's
// passes go through L1/L2. Both serve user families of more than 21 nodes,
// none of which a model of the repository has, and JAX's exact-eigh branch.
#include <cfloat>

#include "stk_common.cuh"

#define STK_PD_DMAX 64
#define STK_PD_NARROW 16
#define STK_PD_WARPS 4
#define STK_PD_WIDE_THREADS 256
#define STK_PD_SHARED_THREADS 1024
// shared memory a block may ask for on sm_90
#define STK_PD_SHARED_MAX 232448
// blocks of the wide layout at most (each keeps 4 d^2 values of scratch)
#define STK_PD_WIDE_GRID 264

__device__ __forceinline__ float stk_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double stk_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float stk_cos(float x) { return cosf(x); }
__device__ __forceinline__ double stk_cos(double x) { return cos(x); }
__device__ __forceinline__ float stk_sin(float x) { return sinf(x); }
__device__ __forceinline__ double stk_sin(double x) { return sin(x); }

__device__ __forceinline__ float stk_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double stk_abs(double x) { return fabs(x); }

// Kernel Z's stop bound of a (d, d) matrix, row-major with row stride `ld`:
// tol * max_j |a_jj| (a NaN propagates, and then no entry passes, as in the
// twin). Each thread reads the whole diagonal (max is exact, so every
// thread gets the same bound).
template <typename T>
__device__ __forceinline__ T pd_stop_bound(const T* A, int d, long long ld, T tol) {
  T m = T(0);
  for (int j = 0; j < d; ++j) {
    const T a = stk_abs(A[j * ld + j]);
    m = (a > m || a != a) ? a : m;
  }
  return tol * m;
}

template <typename T>
__host__ __device__ inline T pd_tol() {
  return sizeof(T) == 4 ? (T)FLT_EPSILON : (T)DBL_EPSILON;
}

// One warp's shared memory: A, B, V, W (d x d each), cr, sr, w (d each), then
// the d partners; rounded up to 16 bytes so the next warp's values align.
template <typename T>
__host__ __device__ inline size_t pd_warp_bytes(int d) {
  const size_t b = (4 * (size_t)d * d + 3 * (size_t)d) * sizeof(T) + (size_t)d * sizeof(int);
  return (b + 15) & ~(size_t)15;
}

template <typename T>
__global__ void pd_project_kernel(const T* __restrict__ H, int n_mat, int d,
                                  const int* __restrict__ sched, int n_rounds,
                                  int sweeps, int converge, T eps,
                                  int mirroring,
                                  const uint8_t* __restrict__ elem_mask,
                                  T* __restrict__ H_out,
                                  uint8_t* __restrict__ changed,
                                  int* __restrict__ unconverged,
                                  int* __restrict__ sweeps_out) {
  extern __shared__ __align__(16) unsigned char stk_pd_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= n_mat) return;  // whole warp leaves together
  const int dd = d * d;
  T* A = reinterpret_cast<T*>(stk_pd_smem + warp * pd_warp_bytes<T>(d));
  T* B = A + dd;
  T* V = B + dd;
  T* W = V + dd;
  T* cr = W + dd;
  T* sr = cr + d;
  T* wn = sr + d;
  int* partner = reinterpret_cast<int*>(wn + d);
  const T* Hm = H + m * dd;
  for (int t = lane; t < dd; t += 32) {
    A[t] = Hm[t];
    V[t] = (t / d == t % d) ? T(1) : T(0);
  }
  __syncwarp();

  const T tol = pd_tol<T>();
  bool passed = false;
  int ran = 0;
  for (int sw = 0; sw < sweeps; ++sw) {
    if (converge) {
      if (passed) break;  // the sweep after the test passed is done
      for (int t = lane; t < dd; t += 32) {  // the lower triangle from the upper
        const int i = t / d;
        const int k = t - i * d;
        if (i > k) A[t] = A[k * d + i];
      }
      __syncwarp();
      bool bad = false;
      const T bound = pd_stop_bound(A, d, d, tol);
      for (int t = lane; t < dd; t += 32) {
        const int i = t / d;
        const int k = t - i * d;
        if (i < k && !(stk_abs(A[t]) <= bound)) bad = true;
      }
      passed = !__any_sync(0xffffffffu, bad);
    }
    ++ran;
    for (int r = 0; r < n_rounds; ++r) {
      for (int i = lane; i < d; i += 32) {
        const int j = sched[r * d + i];
        if (j == i) {
          cr[i] = T(1);
          sr[i] = T(0);
        } else {
          const int p = i < j ? i : j;
          const int q = i < j ? j : i;
          const T app = A[p * d + p];
          const T aqq = A[q * d + q];
          const T apq = A[p * d + q];
          const T theta = T(0.5) * stk_atan2(T(2) * apq, aqq - app);
          const T c = stk_cos(theta);
          const T sn = stk_sin(theta);
          cr[i] = c;
          sr[i] = (i == p) ? -sn : sn;
        }
        partner[i] = j;
      }
      __syncwarp();
      for (int t = lane; t < dd; t += 32) {
        const int i = t / d;
        const int k = t - i * d;
        B[t] = cr[i] * A[t] + sr[i] * A[partner[i] * d + k];
      }
      __syncwarp();
      for (int t = lane; t < dd; t += 32) {
        const int i = t / d;
        const int k = t - i * d;
        const int pk = i * d + partner[k];
        A[t] = cr[k] * B[t] + sr[k] * B[pk];
        W[t] = cr[k] * V[t] + sr[k] * V[pk];
      }
      __syncwarp();
      T* tmp = V;
      V = W;
      W = tmp;
    }
  }
  if (converge && !passed) {
    bool bad = false;
    const T bound = pd_stop_bound(A, d, d, tol);
    for (int t = lane; t < dd; t += 32) {
      const int i = t / d;
      const int k = t - i * d;
      if (i < k && !(stk_abs(A[t]) <= bound)) bad = true;
    }
    if (__any_sync(0xffffffffu, bad) && lane == 0 && unconverged != nullptr)
      atomicAdd(unconverged, 1);
  }

  bool below = false;
  for (int i = lane; i < d; i += 32) {
    const T wi = A[i * d + i];
    const bool bi = wi < eps;
    below |= bi;
    wn[i] = bi ? (mirroring ? -wi : eps) : wi;
  }
  const bool any_below = __any_sync(0xffffffffu, below);
  const bool sel = any_below && (elem_mask == nullptr || elem_mask[m] != 0);
  __syncwarp();
  T* Hom = H_out + m * dd;
  for (int t = lane; t < dd; t += 32) {
    if (sel) {
      const int i = t / d;
      const int k = t - i * d;
      T acc = T(0);
      for (int j = 0; j < d; ++j) acc += V[i * d + j] * wn[j] * V[k * d + j];
      Hom[t] = acc;
    } else {
      Hom[t] = Hm[t];
    }
  }
  if (lane == 0) {
    changed[m] = sel ? 1 : 0;
    if (sweeps_out != nullptr) sweeps_out[m] = ran;
  }
}

// Kernel Z's wide layout (d > 64): one block per matrix, the matrices in a
// global scratch buffer of 4 d^2 values per block (A, B, V, W).
template <typename T>
__global__ void pd_project_global_kernel(const T* __restrict__ H, int n_mat, int d,
                                         const int* __restrict__ sched, int n_rounds,
                                         int sweeps, int converge, T eps,
                                         int mirroring,
                                         const uint8_t* __restrict__ elem_mask,
                                         T* __restrict__ H_out,
                                         uint8_t* __restrict__ changed,
                                         T* __restrict__ scratch,
                                         int* __restrict__ unconverged,
                                         int* __restrict__ sweeps_out) {
  extern __shared__ __align__(16) unsigned char stk_pd_gsmem[];
  T* cr = reinterpret_cast<T*>(stk_pd_gsmem);
  T* sr = cr + d;
  T* wn = sr + d;
  int* partner = reinterpret_cast<int*>(wn + d);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long dd = (long long)d * d;
  const T tol = pd_tol<T>();
  T* base = scratch + (long long)blockIdx.x * 4 * dd;
  for (long long m = blockIdx.x; m < n_mat; m += gridDim.x) {
    T* A = base;
    T* B = A + dd;
    T* V = B + dd;
    T* W = V + dd;
    const T* Hm = H + m * dd;
    for (long long t = tid; t < dd; t += nt) {
      A[t] = Hm[t];
      V[t] = (t / d == t % d) ? T(1) : T(0);
    }
    __syncthreads();
    bool passed = false;
    int ran = 0;
    for (int sw = 0; sw < sweeps; ++sw) {
      if (converge) {
        if (passed) break;  // the sweep after the test passed is done
        for (long long t = tid; t < dd; t += nt) {  // the lower triangle from the upper
          const int i = (int)(t / d);
          const int k = (int)(t - (long long)i * d);
          if (i > k) A[t] = A[(long long)k * d + i];
        }
        __syncthreads();
        int bad = 0;
        const T bound = pd_stop_bound(A, d, d, tol);
        for (long long t = tid; t < dd; t += nt) {
          const int i = (int)(t / d);
          const int k = (int)(t - (long long)i * d);
          if (i < k && !(stk_abs(A[t]) <= bound)) bad = 1;
        }
        passed = !__syncthreads_or(bad);
      }
      ++ran;
      for (int r = 0; r < n_rounds; ++r) {
        for (int i = tid; i < d; i += nt) {
          const int j = sched[r * d + i];
          if (j == i) {
            cr[i] = T(1);
            sr[i] = T(0);
          } else {
            const int p = i < j ? i : j;
            const int q = i < j ? j : i;
            const T app = A[(long long)p * d + p];
            const T aqq = A[(long long)q * d + q];
            const T apq = A[(long long)p * d + q];
            const T theta = T(0.5) * stk_atan2(T(2) * apq, aqq - app);
            const T c = stk_cos(theta);
            const T sn = stk_sin(theta);
            cr[i] = c;
            sr[i] = (i == p) ? -sn : sn;
          }
          partner[i] = j;
        }
        __syncthreads();
        for (long long t = tid; t < dd; t += nt) {
          const int i = (int)(t / d);
          const int k = (int)(t - (long long)i * d);
          const T ap = A[(long long)partner[i] * d + k];
          B[t] = rn_add(rn_mul(cr[i], A[t]), rn_mul(sr[i], ap));
        }
        __syncthreads();
        for (long long t = tid; t < dd; t += nt) {
          const int i = (int)(t / d);
          const int k = (int)(t - (long long)i * d);
          const long long pk = (long long)i * d + partner[k];
          A[t] = rn_add(rn_mul(cr[k], B[t]), rn_mul(sr[k], B[pk]));
          W[t] = rn_add(rn_mul(cr[k], V[t]), rn_mul(sr[k], V[pk]));
        }
        __syncthreads();
        T* tmp = V;
        V = W;
        W = tmp;
      }
    }
    if (converge && !passed) {
      int bad = 0;
      const T bound = pd_stop_bound(A, d, d, tol);
      for (long long t = tid; t < dd; t += nt) {
        const int i = (int)(t / d);
        const int k = (int)(t - (long long)i * d);
        if (i < k && !(stk_abs(A[t]) <= bound)) bad = 1;
      }
      if (__syncthreads_or(bad) && tid == 0 && unconverged != nullptr)
        atomicAdd(unconverged, 1);
    }
    int below = 0;
    for (int i = tid; i < d; i += nt) {
      const T wi = A[(long long)i * d + i];
      const bool bi = wi < eps;
      below |= bi ? 1 : 0;
      wn[i] = bi ? (mirroring ? -wi : eps) : wi;
    }
    const bool any_below = __syncthreads_or(below) != 0;
    const bool sel = any_below && (elem_mask == nullptr || elem_mask[m] != 0);
    T* Hom = H_out + m * dd;
    for (long long t = tid; t < dd; t += nt) {
      if (sel) {
        const int i = (int)(t / d);
        const int k = (int)(t - (long long)i * d);
        T acc = T(0);
        for (int j = 0; j < d; ++j)
          acc += V[(long long)i * d + j] * wn[j] * V[(long long)k * d + j];
        Hom[t] = acc;
      } else {
        Hom[t] = Hm[t];
      }
    }
    if (tid == 0) {
      changed[m] = sel ? 1 : 0;
      if (sweeps_out != nullptr) sweeps_out[m] = ran;
    }
    __syncthreads();  // the next matrix overwrites the scratch and wn
  }
}

// Kernel Z's shared wide layout: one block of STK_PD_SHARED_THREADS per
// matrix, A and V in shared memory with row stride ld = d | 1, then the
// round's cosines and sines (one per pair), the clamped eigenvalues, and
// the pairs (p, q) of the round (p == q for the bye of an odd d), read
// from `units` (n_rounds, (d + 1) / 2, 2), the schedule grouped by pair.
template <typename T>
__host__ __device__ inline size_t pd_shared_bytes(int d) {
  const size_t ld = (size_t)(d | 1);
  return (2 * (size_t)d * ld + 3 * (size_t)d) * sizeof(T) + (size_t)(d + 1) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(STK_PD_SHARED_THREADS)
pd_project_shared_kernel(const T* __restrict__ H, int n_mat, int d,
                         const int* __restrict__ units, int n_rounds, int sweeps,
                         int converge, T eps, int mirroring,
                         const uint8_t* __restrict__ elem_mask, T* __restrict__ H_out,
                         uint8_t* __restrict__ changed, int* __restrict__ unconverged,
                         int* __restrict__ sweeps_out) {
  extern __shared__ __align__(16) unsigned char stk_pd_ssmem[];
  const int ld = d | 1;
  const int U = (d + 1) / 2;
  T* A = reinterpret_cast<T*>(stk_pd_ssmem);
  T* V = A + (size_t)d * ld;
  T* uc = V + (size_t)d * ld;
  T* us = uc + d;
  T* wn = us + d;
  int* up = reinterpret_cast<int*>(wn + d);
  int* uq = up + U;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int dd = d * d;
  // a round's items: the U x U blocks of A, then V's d x U pairs (i, v),
  // in one sequence dealt round-robin to the threads; each thread steps
  // through its items without a division inside the rounds
  const int UU = U * U;
  const int dU = d * U;
  const int a_u0 = tid / U, a_v0 = tid - (tid / U) * U;
  const int a_du = nt / U, a_dv = nt - (nt / U) * U;
  const int w0 = (tid < UU ? tid + ((UU - tid + nt - 1) / nt) * nt : tid) - UU;
  const int b_v0 = w0 / d, b_i0 = w0 - (w0 / d) * d;
  const int b_dv = nt / d, b_di = nt - (nt / d) * d;
  const T tol = pd_tol<T>();
  for (long long m = blockIdx.x; m < n_mat; m += gridDim.x) {
    const T* Hm = H + m * dd;
    for (int t = tid; t < dd; t += nt) {
      const int i = t / d;
      const int k = t - i * d;
      A[i * ld + k] = Hm[t];
      V[i * ld + k] = (i == k) ? T(1) : T(0);
    }
    __syncthreads();
    bool passed = false;
    int ran = 0;
    for (int sw = 0; sw < sweeps; ++sw) {
      if (converge) {
        if (passed) break;  // the sweep after the test passed is done
        for (int t = tid; t < dd; t += nt) {  // the lower triangle from the upper
          const int i = t / d;
          const int k = t - i * d;
          if (i > k) A[i * ld + k] = A[k * ld + i];
        }
        __syncthreads();
        int bad = 0;
        const T bound = pd_stop_bound(A, d, ld, tol);
        for (int t = tid; t < dd; t += nt) {
          const int i = t / d;
          const int k = t - i * d;
          if (i < k && !(stk_abs(A[i * ld + k]) <= bound)) bad = 1;
        }
        passed = !__syncthreads_or(bad);
      }
      ++ran;
      for (int r = 0; r < n_rounds; ++r) {
        if (tid < U) {
          const int p = units[(r * U + tid) * 2];
          const int q = units[(r * U + tid) * 2 + 1];
          T c = T(1), sn = T(0);
          if (p != q) {
            const T app = A[p * ld + p];
            const T aqq = A[q * ld + q];
            const T apq = A[p * ld + q];
            const T theta = T(0.5) * stk_atan2(T(2) * apq, aqq - app);
            c = stk_cos(theta);
            sn = stk_sin(theta);
          }
          uc[tid] = c;
          us[tid] = sn;
          up[tid] = p;
          uq[tid] = q;
        }
        __syncthreads();
        // the 2 x 2 block (rows p, q; columns k1, k2): the row rotation
        // B = c_row A + s_row A[perm, :] (s_row = -s for p, +s for q), then
        // the column rotation A' = c_col B + s_col B[:, perm]
        int u = a_u0, v = a_v0;
        for (int t = tid; t < UU; t += nt) {
          const int p = up[u], q = uq[u], k1 = up[v], k2 = uq[v];
          const T cu = uc[u], su = us[u], cv = uc[v], sv = us[v];
          const T a11 = A[p * ld + k1], a12 = A[p * ld + k2];
          const T a21 = A[q * ld + k1], a22 = A[q * ld + k2];
          const T b11 = rn_add(rn_mul(cu, a11), rn_mul(-su, a21));
          const T b12 = rn_add(rn_mul(cu, a12), rn_mul(-su, a22));
          const T b21 = rn_add(rn_mul(cu, a21), rn_mul(su, a11));
          const T b22 = rn_add(rn_mul(cu, a22), rn_mul(su, a12));
          A[p * ld + k1] = rn_add(rn_mul(cv, b11), rn_mul(-sv, b12));
          A[p * ld + k2] = rn_add(rn_mul(cv, b12), rn_mul(sv, b11));
          A[q * ld + k1] = rn_add(rn_mul(cv, b21), rn_mul(-sv, b22));
          A[q * ld + k2] = rn_add(rn_mul(cv, b22), rn_mul(sv, b21));
          u += a_du;
          v += a_dv;
          if (v >= U) {
            v -= U;
            ++u;
          }
        }
        // V' = c_col V + s_col V[:, perm] on row i's column pair v
        int i = b_i0;
        v = b_v0;
        for (int w = w0; w < dU; w += nt) {
          const int k1 = up[v], k2 = uq[v];
          const T cv = uc[v], sv = us[v];
          const T v1 = V[i * ld + k1], v2 = V[i * ld + k2];
          V[i * ld + k1] = rn_add(rn_mul(cv, v1), rn_mul(-sv, v2));
          V[i * ld + k2] = rn_add(rn_mul(cv, v2), rn_mul(sv, v1));
          i += b_di;
          v += b_dv;
          if (i >= d) {
            i -= d;
            ++v;
          }
        }
        __syncthreads();
      }
    }
    if (converge && !passed) {
      int bad = 0;
      const T bound = pd_stop_bound(A, d, ld, tol);
      for (int t = tid; t < dd; t += nt) {
        const int i = t / d;
        const int k = t - i * d;
        if (i < k && !(stk_abs(A[i * ld + k]) <= bound)) bad = 1;
      }
      if (__syncthreads_or(bad) && tid == 0 && unconverged != nullptr)
        atomicAdd(unconverged, 1);
    }
    int below = 0;
    for (int i = tid; i < d; i += nt) {
      const T wi = A[i * ld + i];
      const bool bi = wi < eps;
      below |= bi ? 1 : 0;
      wn[i] = bi ? (mirroring ? -wi : eps) : wi;
    }
    const bool any_below = __syncthreads_or(below) != 0;
    const bool sel = any_below && (elem_mask == nullptr || elem_mask[m] != 0);
    T* Hom = H_out + m * dd;
    for (int t = tid; t < dd; t += nt) {
      if (sel) {
        const int i = t / d;
        const int k = t - i * d;
        T acc = T(0);
        for (int j = 0; j < d; ++j) acc += V[i * ld + j] * wn[j] * V[k * ld + j];
        Hom[t] = acc;
      } else {
        Hom[t] = Hm[t];
      }
    }
    if (tid == 0) {
      changed[m] = sel ? 1 : 0;
      if (sweeps_out != nullptr) sweeps_out[m] = ran;
    }
    __syncthreads();  // the next matrix overwrites A, V and wn
  }
}

// Blocks of the global wide layout; its scratch holds pd_wide_grid(n_mat)
// * 4 d^2 values.
static inline int pd_wide_grid(int n_mat) {
  return n_mat < STK_PD_WIDE_GRID ? n_mat : STK_PD_WIDE_GRID;
}

// d > 64 takes the shared wide layout when the caller passes `units` (the
// wrapper's choice, ops/pd_project.py `z_layout`: where pd_shared_bytes
// fits STK_PD_SHARED_MAX), else the global one, which needs `scratch`.
template <typename T>
static int launch_pd_project(const T* H, int n_mat, int d, const int* sched,
                             const int* units, int n_rounds, int sweeps, int converge,
                             double eps, int mirroring, const uint8_t* elem_mask, T* H_out,
                             uint8_t* changed, T* scratch, int* unconverged,
                             int* sweeps_out, cudaStream_t stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (n_mat == 0) return stk_launch_status();
  if (d > STK_PD_DMAX) {
    if (units != nullptr) {
      const size_t shared = pd_shared_bytes<T>(d);
      if (shared > STK_PD_SHARED_MAX) return (int)cudaErrorInvalidValue;
      const cudaError_t e = cudaFuncSetAttribute(
          pd_project_shared_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shared);
      if (e != cudaSuccess) return (int)e;
      const int grid = n_mat < (1 << 20) ? n_mat : (1 << 20);
      pd_project_shared_kernel<T><<<grid, STK_PD_SHARED_THREADS, shared, stream>>>(
          H, n_mat, d, units, n_rounds, sweeps, converge, (T)eps, mirroring, elem_mask,
          H_out, changed, unconverged, sweeps_out);
      return stk_launch_status();
    }
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const size_t bytes = 3 * (size_t)d * sizeof(T) + (size_t)d * sizeof(int);
    if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    pd_project_global_kernel<T><<<pd_wide_grid(n_mat), STK_PD_WIDE_THREADS, bytes, stream>>>(
        H, n_mat, d, sched, n_rounds, sweeps, converge, (T)eps, mirroring, elem_mask,
        H_out, changed, scratch, unconverged, sweeps_out);
    return stk_launch_status();
  }
  const int warps = d <= STK_PD_NARROW ? STK_PD_WARPS : 1;
  const size_t bytes = warps * pd_warp_bytes<T>(d);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pd_project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  pd_project_kernel<T><<<stk_blocks(n_mat, warps), 32 * warps, bytes, stream>>>(
      H, n_mat, d, sched, n_rounds, sweeps, converge, (T)eps, mirroring, elem_mask,
      H_out, changed, unconverged, sweeps_out);
  return stk_launch_status();
}

// Kernel C: `sweeps` fixed sweeps, d <= 64.
STK_API int stk_pd_project_f32(const float* H, int n_mat, int d,
                               const int* sched, int n_rounds, int sweeps,
                               double eps, int mirroring,
                               const uint8_t* elem_mask, float* H_out,
                               uint8_t* changed, cudaStream_t stream) {
  if (d > STK_PD_DMAX) return (int)cudaErrorInvalidValue;
  return launch_pd_project<float>(H, n_mat, d, sched, nullptr, n_rounds, sweeps, 0, eps,
                                  mirroring, elem_mask, H_out, changed, nullptr,
                                  nullptr, nullptr, stream);
}

STK_API int stk_pd_project_f64(const double* H, int n_mat, int d,
                               const int* sched, int n_rounds, int sweeps,
                               double eps, int mirroring,
                               const uint8_t* elem_mask, double* H_out,
                               uint8_t* changed, cudaStream_t stream) {
  if (d > STK_PD_DMAX) return (int)cudaErrorInvalidValue;
  return launch_pd_project<double>(H, n_mat, d, sched, nullptr, n_rounds, sweeps, 0, eps,
                                   mirroring, elem_mask, H_out, changed, nullptr,
                                   nullptr, nullptr, stream);
}

// Kernel Z: converged mode (converge != 0: at most `sweeps` sweeps, each
// matrix stopping on its own test) at any d, or fixed sweeps at d > 64;
// at d > 64 `units` (the schedule by pair) selects the shared wide layout,
// else `scratch` (pd_wide_grid(n_mat) * 4 d^2 values) the global one;
// `unconverged` (may be null) counts the matrices the sweeps left
// unconverged, `sweeps_out` (may be null) receives each matrix's sweeps.
STK_API int stk_pd_project_z_f32(const float* H, int n_mat, int d,
                                 const int* sched, const int* units, int n_rounds,
                                 int sweeps, int converge, double eps, int mirroring,
                                 const uint8_t* elem_mask, float* H_out,
                                 uint8_t* changed, float* scratch,
                                 int* unconverged, int* sweeps_out, cudaStream_t stream) {
  return launch_pd_project<float>(H, n_mat, d, sched, units, n_rounds, sweeps, converge,
                                  eps, mirroring, elem_mask, H_out, changed,
                                  scratch, unconverged, sweeps_out, stream);
}

STK_API int stk_pd_project_z_f64(const double* H, int n_mat, int d,
                                 const int* sched, const int* units, int n_rounds,
                                 int sweeps, int converge, double eps, int mirroring,
                                 const uint8_t* elem_mask, double* H_out,
                                 uint8_t* changed, double* scratch,
                                 int* unconverged, int* sweeps_out, cudaStream_t stream) {
  return launch_pd_project<double>(H, n_mat, d, sched, units, n_rounds, sweeps, converge,
                                   eps, mirroring, elem_mask, H_out, changed,
                                   scratch, unconverged, sweeps_out, stream);
}
