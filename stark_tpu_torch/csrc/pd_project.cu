// Kernel C: per-matrix PD projection by parallel-order cyclic Jacobi.
//
// Replaces stark_tpu/solver/project.py `_jacobi_eigh` (:53-113) together with
// `project_family_to_pd` (:122-141): eigen-decompose each symmetric d x d
// element Hessian, clamp (or mirror) eigenvalues below eps, and rebuild
// V diag(w) V^T for the elements that changed.
//
// One warp owns one matrix. A, its eigenvector accumulator V and two scratch
// copies live in shared memory (d <= 16, so at most 4 x 256 values per warp).
// Each round of the round-robin schedule (the host passes `sched[r][i]`, the
// partner of row i in round r, i itself for a bye; built by
// `_round_robin_rounds`, project.py:31-50) applies floor(d/2) disjoint
// rotations at once, with the same arithmetic as the JAX form:
//   theta = 0.5 * atan2(2 a_pq, a_qq - a_pp),  c = cos theta, s = sin theta
//   B  = c_row * A + s_row * A[perm, :]        (s_row = -s for p, +s for q)
//   A' = c_col * B + s_col * B[:, perm]
//   V' = c_col * V + s_col * V[:, perm]
// Both rows of a pair compute the same (c, s) from the same A, so a round
// needs no extra exchange between lanes. After `sweeps` sweeps the diagonal
// holds the eigenvalues; below = w < eps, the element is selected when any
// eigenvalue is below and `elem_mask` (optional) allows it, and only then is
// V diag(w') V^T written; otherwise the input is copied through.
//
// Bound: operations. A sweep costs ~9 d^2 flops per round over d rounds
// (plus d/2 atan2/cos/sin), about 52 kflop per 9x9 matrix at 8 sweeps,
// against 2 x 81 values of traffic. Design: shared memory keeps every
// sweep's traffic on chip; a warp per matrix keeps the rounds in lockstep
// with only __syncwarp between the row and column passes.
#include "stk_common.cuh"

#define STK_PD_DMAX 16
#define STK_PD_WARPS 4

__device__ __forceinline__ float stk_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double stk_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float stk_cos(float x) { return cosf(x); }
__device__ __forceinline__ double stk_cos(double x) { return cos(x); }
__device__ __forceinline__ float stk_sin(float x) { return sinf(x); }
__device__ __forceinline__ double stk_sin(double x) { return sin(x); }

template <typename T>
struct PdWarp {
  T buf[4][STK_PD_DMAX * STK_PD_DMAX];
  T cr[STK_PD_DMAX];
  T sr[STK_PD_DMAX];
  T w[STK_PD_DMAX];
  int partner[STK_PD_DMAX];
};

template <typename T>
__global__ void pd_project_kernel(const T* __restrict__ H, int n_mat, int d,
                                  const int* __restrict__ sched, int n_rounds,
                                  int sweeps, T eps, int mirroring,
                                  const uint8_t* __restrict__ elem_mask,
                                  T* __restrict__ H_out,
                                  uint8_t* __restrict__ changed) {
  __shared__ PdWarp<T> smem[STK_PD_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * STK_PD_WARPS + warp;
  if (m >= n_mat) return;  // whole warp leaves together
  PdWarp<T>& s = smem[warp];
  T* A = s.buf[0];
  T* B = s.buf[1];
  T* V = s.buf[2];
  T* W = s.buf[3];
  const int dd = d * d;
  const T* Hm = H + m * dd;
  for (int t = lane; t < dd; t += 32) {
    A[t] = Hm[t];
    V[t] = (t / d == t % d) ? T(1) : T(0);
  }
  __syncwarp();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < n_rounds; ++r) {
      if (lane < d) {
        const int i = lane;
        const int j = sched[r * d + i];
        if (j == i) {
          s.cr[i] = T(1);
          s.sr[i] = T(0);
        } else {
          const int p = i < j ? i : j;
          const int q = i < j ? j : i;
          const T app = A[p * d + p];
          const T aqq = A[q * d + q];
          const T apq = A[p * d + q];
          const T theta = T(0.5) * stk_atan2(T(2) * apq, aqq - app);
          const T c = stk_cos(theta);
          const T sn = stk_sin(theta);
          s.cr[i] = c;
          s.sr[i] = (i == p) ? -sn : sn;
        }
        s.partner[i] = j;
      }
      __syncwarp();
      for (int t = lane; t < dd; t += 32) {
        const int i = t / d;
        const int k = t - i * d;
        B[t] = s.cr[i] * A[t] + s.sr[i] * A[s.partner[i] * d + k];
      }
      __syncwarp();
      for (int t = lane; t < dd; t += 32) {
        const int i = t / d;
        const int k = t - i * d;
        const int pk = i * d + s.partner[k];
        A[t] = s.cr[k] * B[t] + s.sr[k] * B[pk];
        W[t] = s.cr[k] * V[t] + s.sr[k] * V[pk];
      }
      __syncwarp();
      T* tmp = V;
      V = W;
      W = tmp;
    }
  }

  bool below = false;
  if (lane < d) {
    const T wi = A[lane * d + lane];
    below = wi < eps;
    s.w[lane] = below ? (mirroring ? -wi : eps) : wi;
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
      for (int j = 0; j < d; ++j) acc += V[i * d + j] * s.w[j] * V[k * d + j];
      Hom[t] = acc;
    } else {
      Hom[t] = Hm[t];
    }
  }
  if (lane == 0) changed[m] = sel ? 1 : 0;
}

template <typename T>
static int launch_pd_project(const T* H, int n_mat, int d, const int* sched,
                             int n_rounds, int sweeps, double eps,
                             int mirroring, const uint8_t* elem_mask, T* H_out,
                             uint8_t* changed, cudaStream_t stream) {
  if (d < 1 || d > STK_PD_DMAX) return (int)cudaErrorInvalidValue;
  if (n_mat == 0) return stk_launch_status();
  const int threads = 32 * STK_PD_WARPS;
  pd_project_kernel<T><<<stk_blocks(n_mat, STK_PD_WARPS), threads, 0, stream>>>(
      H, n_mat, d, sched, n_rounds, sweeps, (T)eps, mirroring, elem_mask, H_out,
      changed);
  return stk_launch_status();
}

STK_API int stk_pd_project_f32(const float* H, int n_mat, int d,
                               const int* sched, int n_rounds, int sweeps,
                               double eps, int mirroring,
                               const uint8_t* elem_mask, float* H_out,
                               uint8_t* changed, cudaStream_t stream) {
  return launch_pd_project<float>(H, n_mat, d, sched, n_rounds, sweeps, eps,
                                  mirroring, elem_mask, H_out, changed, stream);
}

STK_API int stk_pd_project_f64(const double* H, int n_mat, int d,
                               const int* sched, int n_rounds, int sweeps,
                               double eps, int mirroring,
                               const uint8_t* elem_mask, double* H_out,
                               uint8_t* changed, cudaStream_t stream) {
  return launch_pd_project<double>(H, n_mat, d, sched, n_rounds, sweeps, eps,
                                   mirroring, elem_mask, H_out, changed,
                                   stream);
}
