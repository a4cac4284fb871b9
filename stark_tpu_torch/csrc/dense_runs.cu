// Kernel AC: the run sums of the dense assembly, written straight into the
// dense matrix's layout.
//
// Replaces stark_tpu/solver/assembly.py `_seg_scan_rows` (:626-640) with
// `assemble_dense_perm` (:642-670), and the f64 cumsum run sums of
// `direct_solve` (:789-821). JAX reduces the element blocks' 3x3 values in
// the sorted block-pair order of `direct_tables` (kernel AA) with a
// segmented scan (or an f64 cumsum and differences), gathers each run's
// last value and scatters it into an (N1^2, 9) table, which it then
// transposes into the dense layout. Here thread (s, w) sums value w of slot
// s's run [starts[s], starts[s + 1]) (the last slot ends at R2) over the
// element blocks order[k] and writes it to its place in the dense matrix:
//   * layout 0, `assemble_dense_perm`: the permuted (component-major)
//     (3 N1)^2 matrix, row a N1 + b1, column c N1 + b2, summed in T as
//     JAX's segment-local scan; the dummy block (id n_blocks) carries an
//     identity diagonal, written by the extra slot s = slot_cap;
//   * layout 1, `direct_solve`: the block-major (3n)^2 matrix of the n real
//     blocks, row 3 b1 + a, column 3 b2 + c, summed in f64 as JAX's cumsum
//     and rounded once to T.
// Slots past the count, and the dummy pair key N1^2 - 1, write nothing (JAX
// overwrites them). The caller zeroes the matrix.
//
// Bound: bytes. Each element block value is read once (9 per sorted row)
// and each written entry of the dense matrix once; the zeroing of the
// (3 N1)^2 matrix (42.9 MB at 1,091 blocks in f32) is the caller's. Design:
// one thread per (run, value), sums in sorted order from 0, so the result
// is deterministic; neighbouring threads read neighbouring values of the
// same block.
#include "stk_common.cuh"

template <typename T, typename Acc>
__global__ void dense_runs_kernel(const T* __restrict__ H, int b,
                                  const int* __restrict__ order,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ pid_start,
                                  const int* __restrict__ n_slots, int slot_cap, int R2,
                                  int n_blocks, int layout, T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)(slot_cap + 1) * 9) return;
  const int s = (int)(t / 9);
  const int w = (int)(t - (long long)s * 9);
  const int ca = w / 3;
  const int cb = w - 3 * ca;
  const long long N1 = n_blocks + 1;
  if (s == slot_cap) {
    if (layout == 0) {
      const long long n3 = 3 * N1;
      out[(ca * N1 + n_blocks) * n3 + cb * N1 + n_blocks] = ca == cb ? T(1) : T(0);
    }
    return;
  }
  const int n_valid = *n_slots < slot_cap ? *n_slots : slot_cap;
  if (s >= n_valid) return;
  const int pid = pid_start[s];
  if (pid == N1 * N1 - 1) return;
  const long long b1 = pid / N1;
  const long long b2 = pid - b1 * N1;
  if (layout == 1 && (b1 >= n_blocks || b2 >= n_blocks)) return;
  const int lo = starts[s];
  const int hi = s + 1 < n_valid ? starts[s + 1] : R2;
  const int d = 3 * b;
  const int bb = b * b;
  Acc acc = Acc(0);
  for (int k = lo; k < hi; ++k) {
    const int r = order[k];
    const long long e = r / bb;
    const int ij = r - (int)(e * bb);
    const int i = ij / b;
    const int j = ij - i * b;
    acc += (Acc)H[(e * d + 3 * i + ca) * d + 3 * j + cb];
  }
  if (layout == 0) {
    const long long n3 = 3 * N1;
    out[(ca * N1 + b1) * n3 + cb * N1 + b2] = (T)acc;
  } else {
    const long long n3 = 3 * (long long)n_blocks;
    out[(3 * b1 + ca) * n3 + 3 * b2 + cb] = (T)acc;
  }
}

template <typename T>
static int launch_dense_runs(const T* H, int b, const int* order, const int* starts,
                             const int* pid_start, const int* n_slots, int slot_cap, int R2,
                             int n_blocks, int layout, T* out, cudaStream_t stream) {
  const long long n = (long long)(slot_cap + 1) * 9;
  const int threads = 256;
  if (layout == 0) {
    dense_runs_kernel<T, T><<<stk_blocks(n, threads), threads, 0, stream>>>(
        H, b, order, starts, pid_start, n_slots, slot_cap, R2, n_blocks, layout, out);
  } else if (layout == 1) {
    dense_runs_kernel<T, double><<<stk_blocks(n, threads), threads, 0, stream>>>(
        H, b, order, starts, pid_start, n_slots, slot_cap, R2, n_blocks, layout, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return stk_launch_status();
}

STK_API int stk_dense_runs_f32(const float* H, int b, const int* order, const int* starts,
                               const int* pid_start, const int* n_slots, int slot_cap, int R2,
                               int n_blocks, int layout, float* out, cudaStream_t stream) {
  return launch_dense_runs<float>(H, b, order, starts, pid_start, n_slots, slot_cap, R2,
                                  n_blocks, layout, out, stream);
}

STK_API int stk_dense_runs_f64(const double* H, int b, const int* order, const int* starts,
                               const int* pid_start, const int* n_slots, int slot_cap, int R2,
                               int n_blocks, int layout, double* out, cudaStream_t stream) {
  return launch_dense_runs<double>(H, b, order, starts, pid_start, n_slots, slot_cap, R2,
                                   n_blocks, layout, out, stream);
}
