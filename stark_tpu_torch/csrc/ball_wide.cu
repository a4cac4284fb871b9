// Kernel F: the bounding-ball broad phase fused with its compaction.
//
// Replaces stark_tpu/models/interactions/contact_engine.py `_ball_wide`
// (:1102-1111, with the ball data of :1076-1100): every pair (i, j) of two
// ball sets with allowed[i, j] and
//     |a_i|^2 + |b_j|^2 - 2 a_i.b_j  <=  (ra_i + rb_j + extra)^2
// is emitted, in row-major (i, j) order, into the flat (q, t) lists of
// capacity cap, with the exact total count (it may exceed cap). JAX builds
// the (Na, Nb) squared-distance matrix as one MXU matmul, writes the
// validity mask and compacts it through the trie; here no Na x Nb array is
// ever written:
//   1. row_count: one warp per row i tests its Nb pairs and stores the
//      row's hit count;
//   2. the exclusive scan of kernel E (compact.cu) turns the counts into row
//      offsets and the total;
//   3. row_emit: one warp per row tests the pairs again, 32 columns at a
//      time, and writes each hit at row offset + the popcount of the ballot
//      below its lane — the same order as the twin's nonzero.
// The comparison is evaluated with round-to-nearest intrinsics in the twin's
// operation order, so nvcc cannot contract it into FMAs and move a pair
// across the threshold: kernel and twin select the same pairs.
//
// Bound: operations or bytes, whichever is larger: the allowed mask (Na*Nb
// bytes) is read twice and each pair costs 9 flops per pass.
#include "stk_common.cuh"

int stk_exclusive_scan_i32(const int* counts, int m, int* offsets, int* total,
                           cudaStream_t stream);

#define BW_WARPS 8

template <typename T>
__device__ __forceinline__ bool ball_hit(const T* A, const T* a2, const T* ra,
                                         const T* B, const T* b2, const T* rb,
                                         const uint8_t* allowed, int Nb, int i,
                                         int j, T extra) {
  if (!allowed[(long long)i * Nb + j]) return false;
  const T* a = A + 3LL * i;
  const T* b = B + 3LL * j;
  T ab = rn_add(rn_add(rn_mul(a[0], b[0]), rn_mul(a[1], b[1])),
                rn_mul(a[2], b[2]));
  T m2 = rn_sub(rn_add(a2[i], b2[j]), rn_mul(T(2), ab));
  T rhs = rn_add(rn_add(ra[i], rb[j]), extra);
  return m2 <= rn_mul(rhs, rhs);
}

template <typename T>
__global__ void row_count_kernel(const T* __restrict__ A, const T* __restrict__ a2,
                                 const T* __restrict__ ra, const T* __restrict__ B,
                                 const T* __restrict__ b2, const T* __restrict__ rb,
                                 int Na, int Nb, const uint8_t* __restrict__ allowed,
                                 const T* __restrict__ extra,
                                 int* __restrict__ row_counts) {
  const int i = blockIdx.x * BW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= Na) return;
  const T ex = *extra;
  int c = 0;
  for (int j = lane; j < Nb; j += 32)
    c += ball_hit(A, a2, ra, B, b2, rb, allowed, Nb, i, j, ex) ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) row_counts[i] = c;
}

template <typename T>
__global__ void row_emit_kernel(const T* __restrict__ A, const T* __restrict__ a2,
                                const T* __restrict__ ra, const T* __restrict__ B,
                                const T* __restrict__ b2, const T* __restrict__ rb,
                                int Na, int Nb, const uint8_t* __restrict__ allowed,
                                const T* __restrict__ extra,
                                const int* __restrict__ row_offsets, int cap,
                                int* __restrict__ q, int* __restrict__ t) {
  const int i = blockIdx.x * BW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= Na) return;
  const T ex = *extra;
  int off = row_offsets[i];
  if (off >= cap) return;
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < Nb; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < Nb && ball_hit(A, a2, ra, B, b2, rb, allowed, Nb, i, j, ex);
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    const int pos = off + __popc(bal & below);
    if (hit && pos < cap) {
      q[pos] = i;
      t[pos] = j;
    }
    off += __popc(bal);
    if (off >= cap) break;
  }
}

// scratch: 2 * Na ints (row counts, row offsets).
template <typename T>
static int launch_ball_wide(const T* A, const T* a2, const T* ra, const T* B,
                            const T* b2, const T* rb, int Na, int Nb,
                            const uint8_t* allowed, const T* extra, int cap,
                            int* q, int* t, int* count, int* scratch,
                            cudaStream_t stream) {
  if (cap > 0) {
    cudaMemsetAsync(q, 0, (size_t)cap * sizeof(int), stream);
    cudaMemsetAsync(t, 0, (size_t)cap * sizeof(int), stream);
  }
  if (Na == 0 || Nb == 0) {
    cudaMemsetAsync(count, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  int* row_counts = scratch;
  int* row_offsets = scratch + Na;
  const int blocks = (Na + BW_WARPS - 1) / BW_WARPS;
  row_count_kernel<T><<<blocks, 32 * BW_WARPS, 0, stream>>>(
      A, a2, ra, B, b2, rb, Na, Nb, allowed, extra, row_counts);
  int rc = stk_exclusive_scan_i32(row_counts, Na, row_offsets, count, stream);
  if (rc != 0) return rc;
  row_emit_kernel<T><<<blocks, 32 * BW_WARPS, 0, stream>>>(
      A, a2, ra, B, b2, rb, Na, Nb, allowed, extra, row_offsets, cap, q, t);
  return stk_launch_status();
}

STK_API int stk_ball_wide_f32(const float* A, const float* a2, const float* ra,
                              const float* B, const float* b2, const float* rb,
                              int Na, int Nb, const uint8_t* allowed,
                              const float* extra, int cap, int* q, int* t,
                              int* count, int* scratch, cudaStream_t stream) {
  return launch_ball_wide<float>(A, a2, ra, B, b2, rb, Na, Nb, allowed, extra,
                                 cap, q, t, count, scratch, stream);
}

STK_API int stk_ball_wide_f64(const double* A, const double* a2,
                              const double* ra, const double* B,
                              const double* b2, const double* rb, int Na,
                              int Nb, const uint8_t* allowed,
                              const double* extra, int cap, int* q, int* t,
                              int* count, int* scratch, cudaStream_t stream) {
  return launch_ball_wide<double>(A, a2, ra, B, b2, rb, Na, Nb, allowed, extra,
                                  cap, q, t, count, scratch, stream);
}
