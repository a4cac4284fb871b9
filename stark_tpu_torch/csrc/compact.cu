// Kernel E: stream compaction of a byte mask into a fixed-capacity index
// buffer, plus the exclusive scan it is built on (shared with kernel F).
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

// Host helper shared with kernel F (ball_wide.cu): exclusive scan of m int
// counts on the device. m == 0 writes a zero total.
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
