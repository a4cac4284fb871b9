// Kernel AA: the gather tables of the CG reduction and of the dense
// assembly, built from stably sorted keys.
//
// Replaces stark_tpu/solver/assembly.py `scatter_table` (:214-237),
// `scatter_table_rows` (:524-557) and `direct_tables` (:604-624). JAX sorts
// the keys (jnp.argsort, a stable sort) and then finds each block's run with
// searchsorted and gathers its entries; here the sort stays a library call
// (torch.sort(stable=True) gives JAX's `order` exactly) and these kernels do
// the rest, all in int32 as JAX's outputs are:
//   * gather_table: thread (i, k) of the (n_seg, K) table binary-searches
//     block i's run [lo, hi) in the sorted keys and writes order[lo + k]
//     (R past the run); thread (i, 0) also writes the run's length, its
//     "hot" flag (length > K) and folds the length into *max_len with an
//     integer atomicMax (the result is exact, whatever the order);
//   * gather_hot: the (hot_cap, K2) side table of the hot blocks (their ids
//     compacted by kernel E from the hot flags): entries K .. K + K2 - 1 of
//     each hot block's run;
//   * pair_keys: the block-pair key of every (element, i, j) of the single
//     bucket, clamped as JAX clamps (a pair with a dummy block keys N1^2 - 1);
//   * run_heads: is_start of the sorted pair keys (kernel E compacts the
//     heads into the slot table);
//   * slot_pids: the pair key of each slot's run (N1^2 - 1 past the count).
//
// Bound: bytes. Each table entry is written once and each sorted key and
// order entry read about once; the binary searches add log2(R) key reads per
// thread, which stay in L1/L2. Design: one thread per output entry, no
// shared state but the atomicMax, so each table is one launch.
#include "stk_common.cuh"

__device__ __forceinline__ int stk_lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int stk_upper_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void gather_table_kernel(const int* __restrict__ keys, const int* __restrict__ order,
                                    int R, int n_seg, int K, int* __restrict__ entry,
                                    int* __restrict__ lens, int* __restrict__ max_len,
                                    uint8_t* __restrict__ hot) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_seg * K) return;
  const int i = (int)(t / K);
  const int k = (int)(t - (long long)i * K);
  const int lo = stk_lower_bound(keys, R, i);
  const int len = stk_upper_bound(keys, R, i) - lo;
  entry[t] = k < len ? order[lo + k] : R;
  if (k == 0) {
    lens[i] = len;
    atomicMax(max_len, len);
    if (hot != nullptr) hot[i] = len > K ? 1 : 0;
  }
}

__global__ void gather_hot_kernel(const int* __restrict__ keys, const int* __restrict__ order,
                                  int R, const int* __restrict__ lens,
                                  const int* __restrict__ hot_idx, const int* __restrict__ hot_n,
                                  int hot_cap, int K, int K2, int* __restrict__ hot_entry) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)hot_cap * K2) return;
  const int h = (int)(t / K2);
  const int k = (int)(t - (long long)h * K2);
  const int n_hot = *hot_n < hot_cap ? *hot_n : hot_cap;
  const int b = hot_idx[h];
  int out = R;
  if (h < n_hot && k < lens[b] - K) out = order[stk_lower_bound(keys, R, b) + K + k];
  hot_entry[t] = out;
}

__global__ void pair_keys_kernel(const int* __restrict__ conn, long long E, int b,
                                 int n_blocks, int* __restrict__ pid) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bb = (long long)b * b;
  if (t >= E * bb) return;
  const long long e = t / bb;
  const int ij = (int)(t - e * bb);
  const int i = ij / b;
  const int j = ij - i * b;
  const int N1 = n_blocks + 1;
  const int ci = min(conn[e * b + i], n_blocks);
  const int cj = min(conn[e * b + j], n_blocks);
  pid[t] = (ci >= n_blocks || cj >= n_blocks) ? N1 * N1 - 1 : ci * N1 + cj;
}

__global__ void run_heads_kernel(const int* __restrict__ keys, int R, uint8_t* __restrict__ head) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R) return;
  head[t] = (t == 0 || keys[t] != keys[t - 1]) ? 1 : 0;
}

__global__ void slot_pids_kernel(const int* __restrict__ keys, const int* __restrict__ starts,
                                 const int* __restrict__ n_slots, int slot_cap, int dummy,
                                 int* __restrict__ pid_start) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slot_cap) return;
  const int n = *n_slots < slot_cap ? *n_slots : slot_cap;
  pid_start[s] = s < n ? keys[starts[s]] : dummy;
}

STK_API int stk_gather_table(const int* keys, const int* order, int R, int n_seg, int K,
                             int* entry, int* lens, int* max_len, uint8_t* hot,
                             cudaStream_t stream) {
  const long long n = (long long)n_seg * K;
  if (n == 0) return stk_launch_status();
  gather_table_kernel<<<stk_blocks(n, 256), 256, 0, stream>>>(keys, order, R, n_seg, K,
                                                               entry, lens, max_len, hot);
  return stk_launch_status();
}

STK_API int stk_gather_hot(const int* keys, const int* order, int R, const int* lens,
                           const int* hot_idx, const int* hot_n, int hot_cap, int K, int K2,
                           int* hot_entry, cudaStream_t stream) {
  const long long n = (long long)hot_cap * K2;
  if (n == 0) return stk_launch_status();
  gather_hot_kernel<<<stk_blocks(n, 256), 256, 0, stream>>>(keys, order, R, lens, hot_idx,
                                                            hot_n, hot_cap, K, K2, hot_entry);
  return stk_launch_status();
}

STK_API int stk_pair_keys(const int* conn, long long E, int b, int n_blocks, int* pid,
                          cudaStream_t stream) {
  const long long n = E * b * b;
  if (n == 0) return stk_launch_status();
  pair_keys_kernel<<<stk_blocks(n, 256), 256, 0, stream>>>(conn, E, b, n_blocks, pid);
  return stk_launch_status();
}

STK_API int stk_run_heads(const int* keys, int R, uint8_t* head, cudaStream_t stream) {
  if (R == 0) return stk_launch_status();
  run_heads_kernel<<<stk_blocks(R, 256), 256, 0, stream>>>(keys, R, head);
  return stk_launch_status();
}

STK_API int stk_slot_pids(const int* keys, const int* starts, const int* n_slots, int slot_cap,
                          int dummy, int* pid_start, cudaStream_t stream) {
  if (slot_cap == 0) return stk_launch_status();
  slot_pids_kernel<<<stk_blocks(slot_cap, 256), 256, 0, stream>>>(keys, starts, n_slots,
                                                                  slot_cap, dummy, pid_start);
  return stk_launch_status();
}
