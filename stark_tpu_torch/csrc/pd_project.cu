// Kernel C: per-matrix PD projection by parallel-order cyclic Jacobi.
//
// Replaces stark_tpu/solver/project.py `_jacobi_eigh` (:53-113) together with
// `project_family_to_pd` (:122-141): eigen-decompose each symmetric d x d
// element Hessian, clamp (or mirror) eigenvalues below eps, and rebuild
// V diag(w) V^T for the elements that changed.
//
// One warp owns one matrix. A, its eigenvector accumulator V and two scratch
// copies live in dynamic shared memory: four warps share a block for d <= 16
// (at most 4 x 256 values per warp); for 16 < d <= 64 (user families of more
// than five nodes) a block holds one warp, whose lanes take rows i, i + 32.
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

#define STK_PD_DMAX 64
#define STK_PD_NARROW 16
#define STK_PD_WARPS 4

__device__ __forceinline__ float stk_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double stk_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float stk_cos(float x) { return cosf(x); }
__device__ __forceinline__ double stk_cos(double x) { return cos(x); }
__device__ __forceinline__ float stk_sin(float x) { return sinf(x); }
__device__ __forceinline__ double stk_sin(double x) { return sin(x); }

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
                                  int sweeps, T eps, int mirroring,
                                  const uint8_t* __restrict__ elem_mask,
                                  T* __restrict__ H_out,
                                  uint8_t* __restrict__ changed) {
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

  for (int sw = 0; sw < sweeps; ++sw) {
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
  if (lane == 0) changed[m] = sel ? 1 : 0;
}

template <typename T>
static int launch_pd_project(const T* H, int n_mat, int d, const int* sched,
                             int n_rounds, int sweeps, double eps,
                             int mirroring, const uint8_t* elem_mask, T* H_out,
                             uint8_t* changed, cudaStream_t stream) {
  if (d < 1 || d > STK_PD_DMAX) return (int)cudaErrorInvalidValue;
  if (n_mat == 0) return stk_launch_status();
  const int warps = d <= STK_PD_NARROW ? STK_PD_WARPS : 1;
  const size_t bytes = warps * pd_warp_bytes<T>(d);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pd_project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  pd_project_kernel<T><<<stk_blocks(n_mat, warps), 32 * warps, bytes, stream>>>(
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
