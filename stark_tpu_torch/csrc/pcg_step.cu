// Kernel Y: the PCG step of the fused Newton solve, in two kernels around
// the operator and the preconditioner.
//
// Replaces the body of stark_tpu/solver/pcg.py's `lax.while_loop` (:99,
// solve_pcg.h:128-200), which XLA fuses into a few loops per iteration (as
// plain PyTorch it is ~25 launches of dots, scalar ops and axpys):
//   Y1, after Ap = A p:  pAp = p.Ap, indef = pAp <= 0, alpha = rz / pAp,
//       x <- x + alpha p (kept on an indefinite stop), r <- r - alpha Ap,
//       err = sqrt(r.r / b.b), conv = err < abs_tol | err / err0 < rel_tol;
//   Y2, after z = Minv r: rz' = r.z, beta = rz' / rz, p <- z + beta p, the
//       error, done, converged, indefinite flags, the iteration count and
//       the WHILE predicate !done & it < max_iter.
// The scalars live in two small device buffers: sf (T) = [rz, err0, error,
// b.b, abs_tol, err] and si (int32) = [it, done, converged, indefinite,
// stop_indef, conv, indef, pred].
//
// Bound: bytes. Y1 reads p, Ap, x, r and writes x, r (6 n values); Y2 reads
// z, r, p and writes p (4 n). Design: one block of NT threads with a fixed
// strided order per thread and a fixed shared-memory tree, so the dots are
// deterministic (a replayed solve gives the eager one's bits); the vector
// updates round as the plain version's (built with -fmad=false), only the
// dots' order differs from torch.sum. One block is far from the card's
// bandwidth; it is the simple first version.
#include "stk_common.cuh"

#define PCG_NT 512

template <typename T>
__device__ T block_sum(T v, T* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = PCG_NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  T out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ T clamp_tiny(T v) {
  // torch.clamp_min(v, 1e-300): NaN stays NaN; in f32 the bound is 0
  const T tiny = (T)1e-300;
  return v < tiny ? tiny : v;
}

template <typename T>
__global__ void __launch_bounds__(PCG_NT)
pcg_step1_kernel(const T* __restrict__ p, const T* __restrict__ Ap,
                 T* __restrict__ x, T* __restrict__ r, T* __restrict__ sf,
                 int* __restrict__ si, long long n, int stop_on_indef,
                 T rel_tol) {
  __shared__ T red[PCG_NT];
  const int tid = threadIdx.x;
  T acc = T(0);
  for (long long i = tid; i < n; i += PCG_NT) acc += p[i] * Ap[i];
  const T pAp = block_sum(acc, red);
  const bool indef = pAp <= T(0);
  const bool stop = indef && stop_on_indef;
  const T alpha = sf[0] / (pAp == T(0) ? (T)1e-300 : pAp);
  T rr = T(0);
  for (long long i = tid; i < n; i += PCG_NT) {
    const T xi = x[i] + alpha * p[i];
    const T ri = r[i] - alpha * Ap[i];
    if (!stop) x[i] = xi;
    r[i] = ri;
    rr += ri * ri;
  }
  rr = block_sum(rr, red);
  if (tid == 0) {
    const T err = sqrt(rr / clamp_tiny(sf[3]));
    const bool conv = (err < sf[4]) || (err / clamp_tiny(sf[1]) < rel_tol);
    sf[5] = err;
    si[4] = stop;
    si[5] = conv;
    si[6] = indef;
  }
}

template <typename T>
__global__ void __launch_bounds__(PCG_NT)
pcg_step2_kernel(const T* __restrict__ z, const T* __restrict__ r,
                 T* __restrict__ p, T* __restrict__ sf, int* __restrict__ si,
                 long long n, int max_iter) {
  __shared__ T red[PCG_NT];
  const int tid = threadIdx.x;
  const T rz = sf[0];
  T acc = T(0);
  for (long long i = tid; i < n; i += PCG_NT) acc += r[i] * z[i];
  const T rz_new = block_sum(acc, red);
  const T beta = rz_new / (rz == T(0) ? (T)1e-300 : rz);
  for (long long i = tid; i < n; i += PCG_NT) p[i] = z[i] + beta * p[i];
  if (tid == 0) {
    const int stop = si[4], conv = si[5], indef = si[6];
    if (!stop) sf[2] = sf[5];
    const int done = conv || stop;
    si[1] = done;
    si[2] = conv && !stop;
    si[3] = si[3] || indef;
    sf[0] = rz_new;
    const int it = si[0] + 1;
    si[0] = it;
    si[7] = !done && it < max_iter;
  }
}

template <typename T>
static int launch_step1(const T* p, const T* Ap, T* x, T* r, T* sf, int* si,
                        long long n, int stop_on_indef, double rel_tol,
                        cudaStream_t stream) {
  pcg_step1_kernel<T><<<1, PCG_NT, 0, stream>>>(p, Ap, x, r, sf, si, n,
                                                stop_on_indef, (T)rel_tol);
  return stk_launch_status();
}

template <typename T>
static int launch_step2(const T* z, const T* r, T* p, T* sf, int* si,
                        long long n, int max_iter, cudaStream_t stream) {
  pcg_step2_kernel<T><<<1, PCG_NT, 0, stream>>>(z, r, p, sf, si, n, max_iter);
  return stk_launch_status();
}

STK_API int stk_pcg_step1_f32(const float* p, const float* Ap, float* x, float* r,
                              float* sf, int* si, long long n, int stop_on_indef,
                              double rel_tol, cudaStream_t stream) {
  return launch_step1<float>(p, Ap, x, r, sf, si, n, stop_on_indef, rel_tol, stream);
}

STK_API int stk_pcg_step1_f64(const double* p, const double* Ap, double* x,
                              double* r, double* sf, int* si, long long n,
                              int stop_on_indef, double rel_tol, cudaStream_t stream) {
  return launch_step1<double>(p, Ap, x, r, sf, si, n, stop_on_indef, rel_tol, stream);
}

STK_API int stk_pcg_step2_f32(const float* z, const float* r, float* p, float* sf,
                              int* si, long long n, int max_iter, cudaStream_t stream) {
  return launch_step2<float>(z, r, p, sf, si, n, max_iter, stream);
}

STK_API int stk_pcg_step2_f64(const double* z, const double* r, double* p,
                              double* sf, int* si, long long n, int max_iter,
                              cudaStream_t stream) {
  return launch_step2<double>(z, r, p, sf, si, n, max_iter, stream);
}
