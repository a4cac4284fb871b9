// Kernel D: the 3x3 block-Jacobi preconditioner.
//
// Replaces stark_tpu/solver/assembly.py `precondition_inverse` (:876-903),
// the closed-form symmetric adjugate inverse of each diagonal block with an
// identity fallback when |det| <= 1e-30, and `apply_preconditioner`
// (:906-908), the batched 3x3 matvec z = Dinv r applied once per CG
// iteration. Two entry points of one source, one thread per block.
//
// Bound: bytes. The inverse reads and writes 9 values per block for ~40
// flops; the apply reads 12 and writes 3 values for 15 flops. Design: one
// thread per block with the same cofactor arithmetic as the JAX form (it
// uses only the upper triangle, as D is symmetric); loads are strided by 9
// values per thread, which the L1 absorbs at these sizes.
#include "stk_common.cuh"

template <typename T>
__global__ void block3_inverse_kernel(const T* __restrict__ D, int n, T eps,
                                      T* __restrict__ Dinv) {
  long long bi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= n) return;
  const T* m = D + 9 * bi;
  T* o = Dinv + 9 * bi;
  const T a = m[0], b = m[1], c = m[2];
  const T e = m[4], f = m[5];
  const T i = m[8];
  const T A = e * i - f * f;
  const T B = c * f - b * i;
  const T C = b * f - c * e;
  const T det = a * A + b * B + c * C;
  const T E2 = a * i - c * c;
  const T F = b * c - a * f;
  const T I2 = a * e - b * b;
  if (fabs(det) > eps) {
    o[0] = A / det;  o[1] = B / det;  o[2] = C / det;
    o[3] = B / det;  o[4] = E2 / det; o[5] = F / det;
    o[6] = C / det;  o[7] = F / det;  o[8] = I2 / det;
  } else {
    o[0] = T(1); o[1] = T(0); o[2] = T(0);
    o[3] = T(0); o[4] = T(1); o[5] = T(0);
    o[6] = T(0); o[7] = T(0); o[8] = T(1);
  }
}

template <typename T>
__global__ void block3_apply_kernel(const T* __restrict__ Dinv,
                                    const T* __restrict__ r, int n,
                                    T* __restrict__ out) {
  long long bi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= n) return;
  const T* m = Dinv + 9 * bi;
  const T r0 = r[3 * bi], r1 = r[3 * bi + 1], r2 = r[3 * bi + 2];
  out[3 * bi] = m[0] * r0 + m[1] * r1 + m[2] * r2;
  out[3 * bi + 1] = m[3] * r0 + m[4] * r1 + m[5] * r2;
  out[3 * bi + 2] = m[6] * r0 + m[7] * r1 + m[8] * r2;
}

template <typename T>
static int launch_block3_inverse(const T* D, int n, double eps, T* Dinv,
                                 cudaStream_t stream) {
  if (n == 0) return stk_launch_status();
  const int threads = 256;
  block3_inverse_kernel<T><<<stk_blocks(n, threads), threads, 0, stream>>>(
      D, n, (T)eps, Dinv);
  return stk_launch_status();
}

template <typename T>
static int launch_block3_apply(const T* Dinv, const T* r, int n, T* out,
                               cudaStream_t stream) {
  if (n == 0) return stk_launch_status();
  const int threads = 256;
  block3_apply_kernel<T><<<stk_blocks(n, threads), threads, 0, stream>>>(
      Dinv, r, n, out);
  return stk_launch_status();
}

STK_API int stk_block3_inverse_f32(const float* D, int n, double eps,
                                   float* Dinv, cudaStream_t stream) {
  return launch_block3_inverse<float>(D, n, eps, Dinv, stream);
}

STK_API int stk_block3_inverse_f64(const double* D, int n, double eps,
                                   double* Dinv, cudaStream_t stream) {
  return launch_block3_inverse<double>(D, n, eps, Dinv, stream);
}

STK_API int stk_block3_apply_f32(const float* Dinv, const float* r, int n,
                                 float* out, cudaStream_t stream) {
  return launch_block3_apply<float>(Dinv, r, n, out, stream);
}

STK_API int stk_block3_apply_f64(const double* Dinv, const double* r, int n,
                                 double* out, cudaStream_t stream) {
  return launch_block3_apply<double>(Dinv, r, n, out, stream);
}
