// Kernel E: stream compaction of a byte mask into a fixed-capacity index
// buffer, plus the exclusive scan it is built on, and that scan's two-level
// form for long count arrays (kernels F, I and K; at the end of this file).
//
// Replaces stark_tpu/ops/compaction.py `compact_indices` (:59-119): the
// indices of the set entries of a flat mask, ascending, written into a (cap,)
// int32 buffer padded with 0 (the contract of jnp.nonzero(size=cap,
// fill_value=0)), and the TOTAL count, which may exceed cap. The JAX version
// walks a 128-ary trie with MXU lane scans to dodge the TPU's scoped-VMEM
// limit; none of that carries over. Here it is three launches:
//   1. chunk_count: one block per 2048-entry chunk counts its set bytes;
//   2. exclusive_scan: one block scans the chunk counts into chunk offsets
//      and writes the total count (device memory; the host never reads it);
//   3. chunk_scatter: each block re-counts per thread (8 consecutive
//      entries per thread), scans the thread counts within the block, and
//      writes every set index whose rank is below cap.
// The output is zero-filled first, so ranks at or past the count stay 0.
// The order is exactly ascending, so the kernel and its twin
// (torch.nonzero) give identical buffers.
//
// Bound: bytes. The mask is read twice (passes 1 and 3), the output written
// once; the scan touches 2 ints per chunk.
#include "stk_common.cuh"

#define CMP_THREADS 256
#define CMP_PER_THREAD 8
#define CMP_CHUNK (CMP_THREADS * CMP_PER_THREAD)
#define SCAN_THREADS 1024

// Exclusive scan of one int per thread across the block (blockDim.x a
// multiple of 32, at most 1024); *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = wid > 0 ? warp_sums[wid - 1] : 0;
  *total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

__global__ void chunk_count_kernel(const uint8_t* __restrict__ mask,
                                   long long n, int* __restrict__ counts) {
  const long long base =
      (long long)blockIdx.x * CMP_CHUNK + (long long)threadIdx.x * CMP_PER_THREAD;
  int c = 0;
#pragma unroll
  for (int k = 0; k < CMP_PER_THREAD; ++k) {
    const long long i = base + k;
    c += (i < n && mask[i] != 0) ? 1 : 0;
  }
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One block: offsets[i] = sum(counts[:i]), *total = sum(counts).
__global__ void exclusive_scan_kernel(const int* __restrict__ counts, int m,
                                      int* __restrict__ offsets,
                                      int* __restrict__ total) {
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int lo = min(m, (int)threadIdx.x * per);
  const int hi = min(m, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  int all;
  int run = block_exclusive_scan(s, &all);
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == 0) *total = all;
}

__global__ void chunk_scatter_kernel(const uint8_t* __restrict__ mask,
                                     long long n,
                                     const int* __restrict__ chunk_offsets,
                                     int cap, int* __restrict__ idx) {
  const long long base =
      (long long)blockIdx.x * CMP_CHUNK + (long long)threadIdx.x * CMP_PER_THREAD;
  bool set[CMP_PER_THREAD];
  int c = 0;
#pragma unroll
  for (int k = 0; k < CMP_PER_THREAD; ++k) {
    const long long i = base + k;
    set[k] = i < n && mask[i] != 0;
    c += set[k] ? 1 : 0;
  }
  int total;
  int pos = chunk_offsets[blockIdx.x] + block_exclusive_scan(c, &total);
#pragma unroll
  for (int k = 0; k < CMP_PER_THREAD; ++k) {
    if (set[k]) {
      if (pos < cap) idx[pos] = (int)(base + k);
      ++pos;
    }
  }
}

// The compaction's exclusive scan of m int counts on the device, one block.
// m == 0 writes a zero total.
int stk_exclusive_scan_i32(const int* counts, int m, int* offsets, int* total,
                           cudaStream_t stream) {
  if (m == 0) {
    cudaMemsetAsync(total, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  exclusive_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, m, offsets,
                                                       total);
  return stk_launch_status();
}

// scratch: 2 * ceil(n / 2048) ints (chunk counts, chunk offsets).
STK_API int stk_compact(const uint8_t* mask, long long n, int cap, int* idx,
                        int* count, int* scratch, cudaStream_t stream) {
  if (cap > 0) cudaMemsetAsync(idx, 0, (size_t)cap * sizeof(int), stream);
  if (n == 0) {
    cudaMemsetAsync(count, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  const long long n_chunks = (n + CMP_CHUNK - 1) / CMP_CHUNK;
  int* chunk_counts = scratch;
  int* chunk_offsets = scratch + n_chunks;
  chunk_count_kernel<<<(unsigned)n_chunks, CMP_THREADS, 0, stream>>>(
      mask, n, chunk_counts);
  int rc = stk_exclusive_scan_i32(chunk_counts, (int)n_chunks, chunk_offsets,
                                  count, stream);
  if (rc != 0) return rc;
  chunk_scatter_kernel<<<(unsigned)n_chunks, CMP_THREADS, 0, stream>>>(
      mask, n, chunk_offsets, cap, idx);
  return stk_launch_status();
}

// The two-level form of the scan, for the long count arrays of kernels F, I
// and K (a count per (row, column tile), per bucket, per (digit, radix
// tile)):
// the one-block scan above walks m / 1024 strided counts per thread, which
// at m = 65,536 took 0.135 ms on the H100. Here a block per SCAN_CHUNK
// counts sums its chunk, then a block per chunk reduces the sums of the
// chunks before it, scans its own chunk and writes it (in place is fine:
// each thread reads its counts before any is written). m == 0 writes a zero
// total; `partials` holds ceil(m / SCAN_CHUNK) ints (stk_scan_partials).
#define SCAN_CHUNK STK_SCAN_CHUNK
#define SCAN_ITEMS (SCAN_CHUNK / CMP_THREADS)
static_assert(SCAN_ITEMS * CMP_THREADS == SCAN_CHUNK, "a chunk is whole threads' items");

__global__ void __launch_bounds__(CMP_THREADS)
    chunk_sum_kernel(const int* __restrict__ counts, long long m, int* __restrict__ partials) {
  const long long base = (long long)blockIdx.x * SCAN_CHUNK + threadIdx.x;
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const long long i = base + (long long)k * CMP_THREADS;
    s += i < m ? counts[i] : 0;
  }
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(CMP_THREADS)
    chunk_scan_kernel(const int* counts, long long m, const int* __restrict__ partials,
                      int* offsets, int* __restrict__ total) {
  int before = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += CMP_THREADS) before += partials[k];
  int all;
  block_exclusive_scan(before, &all);
  before = all;
  const long long base = (long long)blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
  int c[SCAN_ITEMS];
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    c[k] = base + k < m ? counts[base + k] : 0;
    s += c[k];
  }
  int block_total;
  int run = before + block_exclusive_scan(s, &block_total);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < m) offsets[base + k] = run;
    run += c[k];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *total = before + block_total;
}

int stk_exclusive_scan_i32_blocks(const int* counts, long long m, int* offsets, int* total,
                                  int* partials, cudaStream_t stream) {
  if (m == 0) {
    cudaMemsetAsync(total, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  const unsigned chunks = (unsigned)((m + SCAN_CHUNK - 1) / SCAN_CHUNK);
  chunk_sum_kernel<<<chunks, CMP_THREADS, 0, stream>>>(counts, m, partials);
  chunk_scan_kernel<<<chunks, CMP_THREADS, 0, stream>>>(counts, m, partials, offsets, total);
  return stk_launch_status();
}
