// Kernel K: the build half of the spatial-hash broad phase.
//
// Replaces the insertion half of stark_tpu/collision/broad_phase.py
// `grid_candidates` (:70-97): JAX writes a (T, ins_slots) table of bucket
// ids, argsorts the int64 keys bucket*(T+1) + tid and finds each bucket's
// run with searchsorted. Here it is a counting sort:
//   1. cells: one thread per target computes its covered-cell box from
//      tc +- (tr + max_qr) and the cell size h, reports the cell count
//      (atomicMax into max_cells), hashes its first min(n_cells, ins_slots)
//      cells in JAX's slot order (x fastest), stores each slot's bucket and
//      counts it into its bucket (atomicAdd);
//   2. the exclusive scan of kernel E (compact.cu) turns the bucket counts
//      into the bucket offsets (table_size + 1 of them: the total last);
//   3. fill: one thread per slot writes its target id at its bucket's offset
//      plus a per-bucket cursor (atomicAdd; the order within a bucket is
//      not yet fixed);
//   4. sort: the filled ids are copied aside, and one block per bucket
//      places each id of its run at its rank (the ids below it, plus its
//      equals earlier in the copy). Runs hold a few to a few thousand ids
//      (1,871 at most at the 64x64 scale point), so the n^2 / blockDim
//      compares per thread stay short, and the result is deterministic and
//      equal to JAX's sorted order, copies included.
// The output is filled with T first, so the positions past the last run
// read T, as the twin's.
//
// Rounding: the cell index is floor((tc -+ R) / h) with a true division
// (no reciprocal, no FMA), R = tr + max_qr, as the twin computes it; the
// hash multiplies in uint32 and keeps the bits (JAX's int32 wrap-around,
// without C++'s signed-overflow undefined behaviour).
//
// Bound: bytes. The targets' spheres are read once, the offsets and the
// offsets[-1] filled ids written once (the padding past them is read by no
// one; the scratch slot buckets and the sort's re-reads are the design's,
// not the function's).
#include "stk_common.cuh"

int stk_exclusive_scan_i32(const int* counts, int m, int* offsets, int* total,
                           cudaStream_t stream);

__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ int grid_hash(int cx, int cy, int cz, int table_size) {
  const uint32_t hx = ((uint32_t)cx * 73856093u) ^ ((uint32_t)cy * 19349663u) ^
                      ((uint32_t)cz * 83492791u);
  return (int)(hx & (uint32_t)(table_size - 1));
}

__device__ __forceinline__ float stk_floor(float x) { return floorf(x); }
__device__ __forceinline__ double stk_floor(double x) { return ::floor(x); }

template <typename T>
__device__ __forceinline__ int cell_of(T x, T h) {
  return (int)stk_floor(rn_div(x, h));
}

__global__ void fill_i32_kernel(int* __restrict__ x, long long n, int v) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = v;
}

template <typename T>
__global__ void grid_cells_kernel(const T* __restrict__ tc, const T* __restrict__ tr,
                                  int nt, const T* __restrict__ max_qr,
                                  const T* __restrict__ hp, int ins, int table_size,
                                  int* __restrict__ slot_bucket,
                                  int* __restrict__ counts,
                                  int* __restrict__ max_cells) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nt) return;
  const T h = *hp;
  const T R = rn_add(tr[t], *max_qr);
  int lo[3], ext[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const T x = tc[3LL * t + d];
    lo[d] = cell_of(rn_sub(x, R), h);
    ext[d] = cell_of(rn_add(x, R), h) - lo[d] + 1;
  }
  const int n_cells =
      (int)((uint32_t)ext[0] * (uint32_t)ext[1] * (uint32_t)ext[2]);
  atomicMax(max_cells, n_cells);
  int* slots = slot_bucket + (long long)t * ins;
  for (int s = 0; s < ins; ++s) {
    if (s >= n_cells) {
      slots[s] = -1;
      continue;
    }
    const int sx = s % ext[0];
    const int rem = s / ext[0];
    const int b = grid_hash(lo[0] + sx, lo[1] + rem % ext[1], lo[2] + rem / ext[1],
                            table_size);
    slots[s] = b;
    atomicAdd(&counts[b], 1);
  }
}

__global__ void grid_fill_kernel(const int* __restrict__ slot_bucket, int nt, int ins,
                                 const int* __restrict__ offsets,
                                 int* __restrict__ cursor,
                                 int* __restrict__ tid_sorted) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nt * ins) return;
  const int b = slot_bucket[i];
  if (b < 0) return;
  tid_sorted[offsets[b] + atomicAdd(&cursor[b], 1)] = (int)(i / ins);
}

// One block per bucket: the unsorted run is read from `unsorted` (a copy),
// each id written to the sorted run at its rank.
__global__ void grid_sort_kernel(const int* __restrict__ offsets,
                                 const int* __restrict__ unsorted,
                                 int* __restrict__ tid_sorted) {
  const int b = blockIdx.x;
  const int lo = offsets[b];
  const int n = offsets[b + 1] - lo;
  if (n <= 1) return;
  const int* src = unsorted + lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = src[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int u = src[j];
      rank += (u < v || (u == v && j < i)) ? 1 : 0;
    }
    tid_sorted[lo + rank] = v;
  }
}

// scratch: nt*ins slot buckets (then the unsorted copy of the filled ids),
// table_size counts, table_size cursors.
template <typename T>
static int launch_grid_build(const T* tc, const T* tr, int nt, const T* max_qr,
                             const T* h, int ins, int table_size, int* offsets,
                             int* tid_sorted, int* max_cells, int* scratch,
                             cudaStream_t stream) {
  const long long n_slots = (long long)nt * ins;
  int* slot_bucket = scratch;
  int* counts = scratch + n_slots;
  int* cursor = counts + table_size;
  cudaMemsetAsync(counts, 0, 2 * (size_t)table_size * sizeof(int), stream);
  cudaMemsetAsync(max_cells, 0, sizeof(int), stream);
  const int threads = 256;
  if (n_slots > 0)
    fill_i32_kernel<<<stk_blocks(n_slots, threads), threads, 0, stream>>>(
        tid_sorted, n_slots, nt);
  if (nt > 0)
    grid_cells_kernel<T><<<stk_blocks(nt, threads), threads, 0, stream>>>(
        tc, tr, nt, max_qr, h, ins, table_size, slot_bucket, counts, max_cells);
  int rc = stk_exclusive_scan_i32(counts, table_size, offsets, offsets + table_size,
                                  stream);
  if (rc != 0) return rc;
  if (n_slots > 0) {
    grid_fill_kernel<<<stk_blocks(n_slots, threads), threads, 0, stream>>>(
        slot_bucket, nt, ins, offsets, cursor, tid_sorted);
    // the slot buckets are spent: their space holds the unsorted copy
    cudaMemcpyAsync(slot_bucket, tid_sorted, (size_t)n_slots * sizeof(int),
                    cudaMemcpyDeviceToDevice, stream);
    grid_sort_kernel<<<table_size, 128, 0, stream>>>(offsets, slot_bucket,
                                                     tid_sorted);
  }
  return stk_launch_status();
}

STK_API int stk_grid_build_f32(const float* tc, const float* tr, int nt,
                               const float* max_qr, const float* h, int ins,
                               int table_size, int* offsets, int* tid_sorted,
                               int* max_cells, int* scratch, cudaStream_t stream) {
  return launch_grid_build<float>(tc, tr, nt, max_qr, h, ins, table_size, offsets,
                                  tid_sorted, max_cells, scratch, stream);
}

STK_API int stk_grid_build_f64(const double* tc, const double* tr, int nt,
                               const double* max_qr, const double* h, int ins,
                               int table_size, int* offsets, int* tid_sorted,
                               int* max_cells, int* scratch, cudaStream_t stream) {
  return launch_grid_build<double>(tc, tr, nt, max_qr, h, ins, table_size, offsets,
                                   tid_sorted, max_cells, scratch, stream);
}
