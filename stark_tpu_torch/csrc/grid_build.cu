// Kernel K: the build half of the spatial-hash broad phase.
//
// Replaces the insertion half of stark_tpu/collision/broad_phase.py
// `grid_candidates` (:70-97): JAX writes a (T, ins_slots) table of bucket
// ids, argsorts the int64 keys bucket*(T+1) + tid and finds each bucket's
// run with searchsorted. Here the slots come in target order (slot t*ins +
// s), so a STABLE sort of the filled slots by bucket gives JAX's (bucket,
// id) order directly, a target's copies adjacent, with no comparison of
// ids at all:
//   1. cells: a thread per target computes its covered-cell box from
//      tc +- (tr + max_qr) and the cell size h, reports the cell count
//      (atomicMax into max_cells) and stores its box and its filled slot
//      count min(n_cells, ins_slots);
//   2. kernel E's two-level exclusive scan (compact.cu) over the slot
//      counts places each target's filled slots in a compact list, in slot
//      order;
//   3. expand: a warp per target hashes its filled slots' cells (JAX's slot
//      order, x fastest) into the list (bucket key, target id) and counts
//      each bucket (atomicAdd);
//   4. the same scan turns the bucket counts into the bucket offsets
//      (table_size + 1 of them: the total last);
//   5. an LSD radix sort of the list by bucket, 8 bits a pass (2 passes
//      for a table of 65,536). Per pass: a block per tile of 4,096 list
//      entries counts its digits in shared memory (the histogram, digit-
//      major, tiles past the list's end write zeros); the scan turns the
//      histogram into (digit, tile) offsets; a block per tile ranks each
//      entry among the earlier entries of its tile with the same digit (a
//      warp's __match_any_sync, per-warp running counts in shared memory,
//      then a prefix over the warps) and scatters it. Each scatter is
//      stable, so the list ends sorted by (bucket, slot), which is (bucket,
//      id). The last pass writes the ids into tid_sorted and T past the
//      last run.
// Every count is a sum, every position a rank: the build is deterministic,
// and the work is linear in the slots whatever a bucket's run length.
//
// Rounding: the cell index is floor((tc -+ R) / h) with a true division
// (no reciprocal, no FMA), R = tr + max_qr, as the twin computes it; the
// hash multiplies in uint32 and keeps the bits (JAX's int32 wrap-around,
// without C++'s signed-overflow undefined behaviour).
//
// Bound: bytes. The targets' spheres are read once, the offsets and the
// offsets[-1] filled ids written once (the padding past them is read by no
// one; the list, its passes and the histograms are the design's, not the
// function's).
#include "stk_common.cuh"

#define GB_THREADS 256
#define GB_WARPS (GB_THREADS / 32)
#define GB_ROUNDS 16
#define GB_TILE (GB_THREADS * GB_ROUNDS)
#define GB_DIGITS 256

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

static int gb_passes(int table_size) {
  int bits = 0;
  while ((1 << bits) < table_size) ++bits;
  return bits <= 8 ? 1 : (bits + 7) / 8;
}

// scratch layout (ints): per target its box (lo xyz, ext xyz), filled
// slot count and list start; the list's length; the bucket counts
// (zeroed); a pass's digit histogram (digit-major, a column per tile); the
// scans' chunk sums; the list's keys and ids, twice (the passes' ping-pong)
struct GbScratch {
  int* box;
  int* tcount;
  int* tstart;
  int* nvalid;
  int* counts;
  int* hist;
  int* partials;
  int* keys[2];
  int* vals[2];
};

static long long gb_tiles(long long n_slots) { return (n_slots + GB_TILE - 1) / GB_TILE; }

static long long gb_partials(int nt, long long n_slots, int table_size) {
  long long m = nt;
  if (table_size > m) m = table_size;
  if (GB_DIGITS * gb_tiles(n_slots) > m) m = GB_DIGITS * gb_tiles(n_slots);
  return stk_scan_partials(m);
}

STK_API long long stk_grid_build_scratch_ints(int nt, int ins, int table_size) {
  const long long n_slots = (long long)nt * ins;
  return 8LL * nt + 4 + table_size + GB_DIGITS * gb_tiles(n_slots) +
         gb_partials(nt, n_slots, table_size) + 4 * n_slots;
}

static GbScratch gb_layout(int* s, int nt, long long n_slots, int table_size) {
  GbScratch g;
  g.box = s;
  g.tcount = g.box + 6LL * nt;
  g.tstart = g.tcount + nt;
  g.nvalid = g.tstart + nt;
  g.counts = g.nvalid + 4;
  g.hist = g.counts + table_size;
  g.partials = g.hist + GB_DIGITS * gb_tiles(n_slots);
  g.keys[0] = g.partials + gb_partials(nt, n_slots, table_size);
  g.vals[0] = g.keys[0] + n_slots;
  g.keys[1] = g.vals[0] + n_slots;
  g.vals[1] = g.keys[1] + n_slots;
  return g;
}

template <typename T>
__global__ void grid_cells_kernel(const T* __restrict__ tc, const T* __restrict__ tr,
                                  int nt, const T* __restrict__ max_qr,
                                  const T* __restrict__ hp, int ins,
                                  int* __restrict__ box, int* __restrict__ tcount,
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
    box[6LL * t + d] = lo[d];
    box[6LL * t + 3 + d] = ext[d];
  }
  const int n_cells =
      (int)((uint32_t)ext[0] * (uint32_t)ext[1] * (uint32_t)ext[2]);
  atomicMax(max_cells, n_cells);
  tcount[t] = n_cells < ins ? (n_cells > 0 ? n_cells : 0) : ins;
}

// A warp per target: its filled slots' buckets into the list, counted.
__global__ void grid_expand_kernel(const int* __restrict__ box,
                                   const int* __restrict__ tcount,
                                   const int* __restrict__ tstart, int nt, int table_size,
                                   int* __restrict__ keys, int* __restrict__ vals,
                                   int* __restrict__ counts) {
  const int t = blockIdx.x * GB_WARPS + (threadIdx.x >> 5);
  if (t >= nt) return;
  const int* b = box + 6LL * t;
  const int n = tcount[t], start = tstart[t];
  for (int s = threadIdx.x & 31; s < n; s += 32) {
    const int sx = s % b[3];
    const int rem = s / b[3];
    const int key =
        grid_hash(b[0] + sx, b[1] + rem % b[4], b[2] + rem / b[4], table_size);
    keys[start + s] = key;
    vals[start + s] = t;
    atomicAdd(&counts[key], 1);
  }
}

// A block per tile: the counts of the digit at `shift` over the tile's
// list entries, into column `tile` of the digit-major histogram (zeros
// past the list's end).
__global__ void __launch_bounds__(GB_THREADS)
    grid_radix_hist_kernel(const int* __restrict__ keys, const int* __restrict__ nvalid,
                           int shift, int* __restrict__ hist) {
  __shared__ int cnt[GB_DIGITS];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int n = *nvalid;
  const long long t0 = (long long)blockIdx.x * GB_TILE;
  for (long long e = t0 + threadIdx.x; e < t0 + GB_TILE && e < n; e += GB_THREADS)
    atomicAdd(&cnt[(keys[e] >> shift) & (GB_DIGITS - 1)], 1);
  __syncthreads();
  hist[(long long)threadIdx.x * gridDim.x + blockIdx.x] = cnt[threadIdx.x];
}

// One block per tile of GB_TILE list entries: a stable scatter by the digit
// at `shift`, from the scanned histogram. Warp w owns entries [w * 512,
// (w + 1) * 512) of the tile, in GB_ROUNDS rounds of 32, in order. The
// last pass (tid_sorted non-null) writes the ids into tid_sorted and T
// past the list.
__global__ void __launch_bounds__(GB_THREADS)
    grid_radix_pass_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
                           const int* __restrict__ nvalid, const int* __restrict__ hist,
                           int shift, int* __restrict__ keys_out, int* __restrict__ vals_out,
                           int* __restrict__ tid_sorted, long long n_slots, int nt) {
  __shared__ int cnt[GB_WARPS][GB_DIGITS];
  __shared__ int base[GB_DIGITS];
  const int n = *nvalid;
  const long long t0 = (long long)blockIdx.x * GB_TILE;
  if (tid_sorted != nullptr)
    for (long long p = t0 + threadIdx.x; p < t0 + GB_TILE && p < n_slots; p += GB_THREADS)
      if (p >= n) tid_sorted[p] = nt;
  if (t0 >= n) return;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < GB_WARPS * GB_DIGITS; k += GB_THREADS) (&cnt[0][0])[k] = 0;
  base[threadIdx.x] = hist[(long long)threadIdx.x * gridDim.x + blockIdx.x];
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int key[GB_ROUNDS], val[GB_ROUNDS], rank[GB_ROUNDS];
#pragma unroll
  for (int r = 0; r < GB_ROUNDS; ++r) {
    const long long e = t0 + w * (32 * GB_ROUNDS) + r * 32 + lane;
    const bool ok = e < n;
    key[r] = ok ? keys_in[e] : 0;
    val[r] = ok ? vals_in[e] : 0;
    const int dig = ok ? (key[r] >> shift) & (GB_DIGITS - 1) : GB_DIGITS;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int before = ok ? cnt[w][dig] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[w][dig] = before + __popc(peers);
    __syncwarp();
    rank[r] = ok ? before + __popc(peers & below) : -1;
  }
  __syncthreads();
  {
    const int d = threadIdx.x;
    int run = 0;
#pragma unroll
    for (int k = 0; k < GB_WARPS; ++k) {
      const int c = cnt[k][d];
      cnt[k][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < GB_ROUNDS; ++r) {
    if (rank[r] < 0) continue;
    const int dig = (key[r] >> shift) & (GB_DIGITS - 1);
    const int dest = base[dig] + cnt[w][dig] + rank[r];
    if (tid_sorted != nullptr) {
      tid_sorted[dest] = val[r];
    } else {
      keys_out[dest] = key[r];
      vals_out[dest] = val[r];
    }
  }
}

// kSplit (only stk_grid_build_split_*, which times the steps): an event of
// ev recorded before the first step and after each: the memsets, cells, the
// targets' scan, expand, the buckets' scan, then each pass's histogram,
// scan and scatter (6 + 3 * passes events)
template <typename T, bool kSplit>
static int launch_grid_build(const T* tc, const T* tr, int nt, const T* max_qr,
                             const T* h, int ins, int table_size, int* offsets,
                             int* tid_sorted, int* max_cells, int* scratch,
                             cudaStream_t stream, cudaEvent_t* ev) {
  int mark = 0;
  auto step = [&]() {
    if constexpr (kSplit) cudaEventRecord(ev[mark++], stream);
  };
  const long long n_slots = (long long)nt * ins;
  const long long tiles = gb_tiles(n_slots);
  const int passes = gb_passes(table_size);
  const GbScratch g = gb_layout(scratch, nt, n_slots, table_size);
  step();
  cudaMemsetAsync(g.counts, 0, (size_t)table_size * sizeof(int), stream);
  cudaMemsetAsync(max_cells, 0, sizeof(int), stream);
  step();
  if (nt > 0)
    grid_cells_kernel<T><<<stk_blocks(nt, GB_THREADS), GB_THREADS, 0, stream>>>(
        tc, tr, nt, max_qr, h, ins, g.box, g.tcount, max_cells);
  step();
  int rc = stk_exclusive_scan_i32_blocks(g.tcount, nt, g.tstart, g.nvalid, g.partials,
                                         stream);
  if (rc != 0) return rc;
  step();
  if (n_slots > 0)
    grid_expand_kernel<<<stk_blocks(nt, GB_WARPS), GB_THREADS, 0, stream>>>(
        g.box, g.tcount, g.tstart, nt, table_size, g.keys[0], g.vals[0], g.counts);
  step();
  rc = stk_exclusive_scan_i32_blocks(g.counts, table_size, offsets, offsets + table_size,
                                     g.partials, stream);
  if (rc != 0) return rc;
  step();
  for (int p = 0; p < passes && n_slots > 0; ++p) {
    const bool last = p == passes - 1;
    grid_radix_hist_kernel<<<(unsigned)tiles, GB_THREADS, 0, stream>>>(
        g.keys[p & 1], g.nvalid, 8 * p, g.hist);
    step();
    rc = stk_exclusive_scan_i32_blocks(g.hist, GB_DIGITS * tiles, g.hist, g.nvalid + 1,
                                       g.partials, stream);
    if (rc != 0) return rc;
    step();
    grid_radix_pass_kernel<<<(unsigned)tiles, GB_THREADS, 0, stream>>>(
        g.keys[p & 1], g.vals[p & 1], g.nvalid, g.hist, 8 * p, g.keys[(p + 1) & 1],
        g.vals[(p + 1) & 1], last ? tid_sorted : nullptr, n_slots, nt);
    step();
  }
  return stk_launch_status();
}

#define GB_ENTRIES(T, SFX)                                                            \
  STK_API int stk_grid_build_##SFX(const T* tc, const T* tr, int nt, const T* max_qr, \
                                   const T* h, int ins, int table_size, int* offsets, \
                                   int* tid_sorted, int* max_cells, int* scratch,     \
                                   cudaStream_t stream) {                             \
    return launch_grid_build<T, false>(tc, tr, nt, max_qr, h, ins, table_size,        \
                                       offsets, tid_sorted, max_cells, scratch,       \
                                       stream, nullptr);                              \
  }                                                                                   \
  STK_API int stk_grid_build_split_##SFX(                                             \
      const T* tc, const T* tr, int nt, const T* max_qr, const T* h, int ins,         \
      int table_size, int* offsets, int* tid_sorted, int* max_cells, int* scratch,    \
      cudaStream_t stream, cudaEvent_t* ev) {                                         \
    return launch_grid_build<T, true>(tc, tr, nt, max_qr, h, ins, table_size,         \
                                      offsets, tid_sorted, max_cells, scratch,        \
                                      stream, ev);                                    \
  }

GB_ENTRIES(float, f32)
GB_ENTRIES(double, f64)
