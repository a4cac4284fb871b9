// Kernel L: per-query row-K candidate selection, over a hash-grid bucket or
// over every target.
//
// Replaces the query half of stark_tpu/collision/broad_phase.py
// `grid_candidates` (:99-119), the sphere prefilter and per-candidate
// exclusions of contact_engine.py's stage 1 (`_grid_stage1` :613-634 with
// `_pt_allowed_fn` / `_ee_allowed_fn` :636-688 and the intersection
// oracle's `et_excl_fn` :1817-1847; the dense branches of `_pt_stage1`,
// `_ee_stage1` and `_isect_stage1`) and `_rowk_topk` (:586-611). JAX
// materializes an (Nq, M) mask (M = occ_cap on the grid, nt dense) and
// runs lax.top_k on the f32 key nt - tid. Here each query row walks its
// candidates in ascending walk order:
//   grid mode:  the first min(occ, occ_cap) ids of the bucket holding the
//               query's centre (kernel K's offsets and sorted ids); an id
//               equal to its predecessor is a copy and is dropped; the true
//               run length occ feeds max_occ (atomicMax);
//   dense mode: the targets 0 .. nt-1.
// A candidate passes the sphere test |qc - tc|^2 <= rhs^2 (rhs in the form
// its JAX caller sums it, see ops/rowk_select.py) and the stem's exclusion
// predicate, read from mesh ids, the (M, M) allowed table and the primitive
// index tables. The passing lanes' ballot gives each its rank (popc of the
// lanes below): the first K passing ids are written in order, the rest of
// the row is padded with nt, and the row's full count feeds max_row
// (atomicMax; the walk never stops at K). Those are `_rowk_topk`'s K
// smallest ids in its order.
//
// Design: the walk is cut into tiles that blocks take in parallel, and the
// queries that walk the same candidates share them:
//   1. mark: a block takes RK_BLOCK_Q (16) consecutive queries and one tile
//      of RK_TILE (1,024) walk positions. On the grid a thread per query
//      hashes its centre's cell (the twin's rounding) into its bucket, and
//      the block orders its queries by (bucket, query) in shared memory,
//      with their records: each run of equal buckets is one segment. Dense
//      mode is one segment, the targets 0 .. nt-1. Segment by segment, warp
//      w loads its slice of the tile, positions 128w .. 128w + 127, four a
//      lane, into registers (id, centre, the radii the form adds, mesh and
//      vertex ids: the predicate reads no device memory but the (M, M)
//      table) and tests them against each of the segment's queries in turn:
//      the ballot of a round is the bit word of 32 walk positions of a
//      query, stored at (query, position / 32). The copy check reads the
//      run's previous id in device memory, so a copy is dropped wherever a
//      slice or tile boundary cuts the run;
//   2. emit: the (Nq, K) ids are filled with nt in one vectorized pass;
//      then a warp per query reads its words in walk order (32 a round, a
//      warp scan of their set bits), writes the first K set positions' ids
//      (dense the positions, each lane its word's; on the grid the run's
//      ids, a word's 32 from one coalesced line) and feeds max_row.
// Nothing carries from one tile to the next, so a long walk (pt_dd: 8,192
// targets; a heavy bucket) spreads over blocks, a launch with few queries
// (ee_dr: 18 box edges) still fills the card, and every warp works whatever
// a segment's size; no order comes from an atomic. A candidate loaded once
// serves the segment's queries from registers.
// A walk of at most one warp's slice (128 positions: the thin stems pt_dr,
// pt_rr, ee_rr) takes one kernel, a warp per query ranking its kept ids by
// each round's ballot: there the mark, fill and emit take 2.2-3.1x its time
// (PERF.md section 6).
// Rounding: the sphere test and the cell index round as the twin does
// (round-to-nearest intrinsics, no FMA contraction, the twin's order of
// sums, a true division for floor(qc / h)), so a pair on the boundary gets
// the twin's verdict. A target-side prefix of the sum (ta + sl in the pt
// form) or a query-side one (qa + sl in the et form) is summed once, in the
// same order.
//
// The same source builds with g++ (ops/build.py `host_broad_library`, the
// `#else` branches below), so the CPU tests hold the logic that decides the
// order. Shared with the card: the hash, the block's ordering and segments
// (rk_rank, rk_segment_end), the tiles' stride, the candidates and their
// copy check (rk_cand), the test and predicate, a set bit's place
// (stk_rank) and its id (rk_walk_id). Modelled serially: the lanes of a
// round (the ballot) and the emit's warp scan over 32 words.
//
// Bound: bytes on the grid (the queries' records, each distinct bucket run
// and each candidate's record read once, the (Nq, K) ids written once);
// operations dense (a sphere test per pair).
#include "stk_common.cuh"

#define RK_WARPS 8
#define RK_BLOCK_Q 16
#define RK_SLOTS 4
#define RK_SLICE (32 * RK_SLOTS)
#define RK_TILE (RK_WARPS * RK_SLICE)

enum { FORM_GRID = 0, FORM_PT = 1, FORM_EE = 2, FORM_ET = 3 };
enum {
  PRED_NONE = 0,
  PRED_PT_DD = 1,
  PRED_PT_RR = 2,
  PRED_EE_DD = 3,
  PRED_EE_RR = 4,
  PRED_ET = 5,
  PRED_ET_RR = 6
};

// the cell index's true division and floor (the host build: g++ rounds
// a / b correctly)
STK_HD float rk_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
STK_HD double rk_div(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}
STK_HD float rk_floor(float x) { return ::floorf(x); }
STK_HD double rk_floor(double x) { return ::floor(x); }

template <typename T>
struct RowkArgs {
  int form, pred;
  const T* qc;
  int Nq;
  const T *qa, *qb;
  const T* tc;
  int nt;
  const T *ta, *tb, *sl;
  const int *qm, *tm;
  int M;
  const uint8_t* allowed;
  const int* qidx;
  int qk;
  const int* tidx;
  int tk;
  const int *offsets, *tid_sorted;  // grid mode when offsets != nullptr
  int occ_cap, table_size;
  const T* h;
  int K;
  int* tid;
  int* maxes;  // [max_row, max_occ]
};

// a query's record (the sum's query-side prefix qa + sl in the et form)
template <typename T>
struct RkQuery {
  T x, y, z, qa, qb;
  int q, mesh, e0, e1;
};

// a candidate of a lane: its target id (-1 for a dropped copy or a
// position past the walk), centre, the radii its form adds (ta + sl in the
// pt form), mesh id and vertex ids
template <typename T>
struct RkCand {
  T cx, cy, cz, ta, tb;
  int t, tm, v0, v1, v2;
};

// 32-bit words of a query's walk: RK_TILE positions a tile
STK_HD int rk_words(int walk) {
  const int n = walk > 0 ? walk : 1;
  return (n + RK_TILE - 1) / RK_TILE * (RK_TILE / 32);
}

template <typename T>
STK_HD int rk_bucket(const RowkArgs<T>& a, int q) {
  const T h = *a.h;
  const uint32_t hx =
      ((uint32_t)(int)rk_floor(rk_div(a.qc[3LL * q], h)) * 73856093u) ^
      ((uint32_t)(int)rk_floor(rk_div(a.qc[3LL * q + 1], h)) * 19349663u) ^
      ((uint32_t)(int)rk_floor(rk_div(a.qc[3LL * q + 2], h)) * 83492791u);
  return (int)(hx & (uint32_t)(a.table_size - 1));
}

// the place of the block's query t when its nb queries are ordered by
// (bucket, position): the segments of equal buckets are contiguous
STK_HD int rk_rank(const int* b, int nb, int t) {
  int r = 0;
  for (int u = 0; u < nb; ++u) r += (b[u] < b[t] || (b[u] == b[t] && u < t)) ? 1 : 0;
  return r;
}

// the first ordered position past the segment of equal buckets at lo
STK_HD int rk_segment_end(const int* s_b, int lo, int nb) {
  int hi = lo + 1;
  while (hi < nb && s_b[hi] == s_b[lo]) ++hi;
  return hi;
}

// the walk of bucket b: its run's start and min(occ, occ_cap) on the grid,
// every target dense
template <typename T>
STK_HD void rk_run(const RowkArgs<T>& a, int b, int* start, int* n) {
  *start = 0;
  *n = a.nt;
  if (a.offsets != nullptr) {
    *start = a.offsets[b];
    const int occ = a.offsets[b + 1] - *start;
    *n = occ < a.occ_cap ? occ : a.occ_cap;
  }
}

template <typename T, int FORM>
STK_HD RkQuery<T> rk_query(const RowkArgs<T>& a, int q, T sl) {
  RkQuery<T> r;
  r.q = q;
  r.x = a.qc[3LL * q];
  r.y = a.qc[3LL * q + 1];
  r.z = a.qc[3LL * q + 2];
  r.qa = FORM == FORM_ET ? rn_add(a.qa[q], sl) : a.qa[q];
  r.qb = a.qb != nullptr ? a.qb[q] : T(0);
  r.mesh = a.qm[q];
  r.e0 = a.qk > 0 ? a.qidx[(long long)a.qk * q] : -1;
  r.e1 = a.qk > 1 ? a.qidx[(long long)a.qk * q + 1] : -1;
  return r;
}

// the id at walk position k: on the grid the run's (it starts at
// `start`), dense the target k
template <typename T>
STK_HD int rk_walk_id(const RowkArgs<T>& a, int start, int k) {
  return a.offsets != nullptr ? a.tid_sorted[start + k] : k;
}

// walk position k (< n) of the run that starts at `start` (grid) or
// target k (dense); the copy check reads the run's previous id, so a copy
// is dropped wherever the slices and tiles cut the run
template <typename T, int FORM>
STK_HD RkCand<T> rk_cand(const RowkArgs<T>& a, int start, int k, int n, T sl) {
  RkCand<T> c;
  c.t = -1;
  c.cx = c.cy = c.cz = c.ta = c.tb = T(0);
  c.tm = c.v0 = c.v1 = c.v2 = -1;
  if (k >= n) return c;
  const int t = rk_walk_id(a, start, k);
  if (a.offsets != nullptr && (t >= a.nt || (k > 0 && rk_walk_id(a, start, k - 1) == t)))
    return c;
  c.t = t;
  c.cx = a.tc[3LL * t];
  c.cy = a.tc[3LL * t + 1];
  c.cz = a.tc[3LL * t + 2];
  c.ta = FORM == FORM_PT ? rn_add(a.ta[t], sl) : a.ta[t];
  if (FORM == FORM_PT || FORM == FORM_EE) c.tb = a.tb[t];
  c.tm = a.tm[t];
  if (a.tk > 0) c.v0 = a.tidx[(long long)a.tk * t];
  if (a.tk > 1) c.v1 = a.tidx[(long long)a.tk * t + 1];
  if (a.tk > 2) c.v2 = a.tidx[(long long)a.tk * t + 2];
  return c;
}

template <typename T, int FORM>
STK_HD bool rk_sphere(const RkQuery<T>& r, const RkCand<T>& c, T sl) {
  const T dx = rn_sub(r.x, c.cx);
  const T dy = rn_sub(r.y, c.cy);
  const T dz = rn_sub(r.z, c.cz);
  const T d2 = rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
  T rhs;
  if (FORM == FORM_GRID)
    rhs = rn_add(r.qa, c.ta);
  else if (FORM == FORM_PT)  // ((ta + sl) + qa) + tb
    rhs = rn_add(rn_add(c.ta, r.qa), c.tb);
  else if (FORM == FORM_EE)
    rhs = rn_add(rn_add(rn_add(rn_add(r.qa, c.ta), sl), r.qb), c.tb);
  else  // (qa + sl) + ta
    rhs = rn_add(r.qa, c.ta);
  return d2 <= rn_mul(rhs, rhs);
}

// the stem's exclusion predicate on a candidate
template <typename T>
STK_HD bool rk_pred(const RowkArgs<T>& a, const RkQuery<T>& r, const RkCand<T>& c) {
  if (!a.allowed[r.mesh * a.M + c.tm]) return false;
  switch (a.pred) {
    case PRED_PT_DD: {
      const bool inc = r.q == c.v0 || r.q == c.v1 || r.q == c.v2;
      return !(r.mesh == c.tm && inc);
    }
    case PRED_PT_RR:
      return r.mesh != c.tm;
    case PRED_EE_DD: {
      const bool approve = c.tm > r.mesh || (c.tm == r.mesh && c.t > r.q);
      const bool share = r.e0 == c.v0 || r.e0 == c.v1 || r.e1 == c.v0 || r.e1 == c.v1;
      return approve && !share;
    }
    case PRED_EE_RR:
      return c.tm > r.mesh;
    case PRED_ET:
    case PRED_ET_RR: {
      const bool share = r.e0 == c.v0 || r.e0 == c.v1 || r.e0 == c.v2 || r.e1 == c.v0 ||
                         r.e1 == c.v1 || r.e1 == c.v2;
      if (share) return false;
      return a.pred == PRED_ET || r.mesh != c.tm;
    }
    default:
      return true;
  }
}

template <typename T, int FORM>
STK_HD bool rk_pass(const RowkArgs<T>& a, const RkQuery<T>& r, const RkCand<T>& c, T sl) {
  return c.t >= 0 && rk_sphere<T, FORM>(r, c, sl) && rk_pred(a, r, c);
}

// walks of at most one warp's slice take one kernel, a warp per query
STK_HD bool rk_short(int walk) { return walk <= RK_SLICE; }

// scratch ints of a launch (`walk`: nt dense, occ_cap on the grid): the bit
// words of every query's walk, then each query's bucket and run (start,
// length)
STK_API long long stk_rowk_select_scratch_ints(int nq, int walk) {
  return (rk_short(walk) ? 0 : (long long)nq * (rk_words(walk) + 3)) + 1;
}

// the grid's column of blocks: each block walks tiles y, y + gy, ... of its
// queries' walks, gy as many as it takes to give the card ~1,000 blocks
STK_HD int rk_tile_stride(int nq, int W) {
  const int xb = (nq + RK_BLOCK_Q - 1) / RK_BLOCK_Q;
  const int ntiles = W / (RK_TILE / 32);
  const int gy = (1024 + xb - 1) / xb;
  return gy < ntiles ? gy : ntiles;
}

// a query's bucket and run (start, length) on the grid
template <typename T>
STK_HD void rk_query_run(const RowkArgs<T>& a, int q, int* qrun) {
  const int b = rk_bucket(a, q);
  qrun[3LL * q] = b;
  rk_run(a, b, &qrun[3LL * q + 1], &qrun[3LL * q + 2]);
}

#ifdef __CUDACC__
// A thread per query on the grid: its bucket and run, and max_occ.
template <typename T>
__global__ void rk_run_kernel(const RowkArgs<T> a, int* __restrict__ qrun) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.Nq) return;
  rk_query_run(a, q, qrun);
  atomicMax(&a.maxes[1], a.offsets[qrun[3LL * q] + 1] - a.offsets[qrun[3LL * q]]);
}

// A block per RK_BLOCK_Q consecutive queries and a stride of tiles (tiles
// y, y + gy, ... of RK_TILE walk positions). The block orders its queries
// by bucket and stages their records and runs; then, segment by segment,
// warp w takes walk positions [RK_SLICE w, RK_SLICE (w + 1)) of each of its
// tiles, RK_SLOTS per lane, in registers and tests them against each of the
// segment's queries: the ballot of a round is the word of 32 walk
// positions of a query.
template <typename T, int FORM>
__global__ void __launch_bounds__(32 * RK_WARPS)
    rk_mark_kernel(const RowkArgs<T> a, int W, uint32_t* __restrict__ bits,
                   const int* __restrict__ qrun) {
  __shared__ int s_ub[RK_BLOCK_Q], s_b[RK_BLOCK_Q], s_start[RK_BLOCK_Q], s_n[RK_BLOCK_Q];
  __shared__ RkQuery<T> s_q[RK_BLOCK_Q];
  const int p0 = blockIdx.x * RK_BLOCK_Q;
  const int nb = min(RK_BLOCK_Q, a.Nq - p0);
  const bool grid = a.offsets != nullptr;
  const T sl = *a.sl;
  if (threadIdx.x < nb) s_ub[threadIdx.x] = grid ? qrun[3LL * (p0 + threadIdx.x)] : 0;
  __syncthreads();
  if (threadIdx.x < nb) {
    const int q = p0 + threadIdx.x;
    const int r = rk_rank(s_ub, nb, threadIdx.x);
    s_b[r] = s_ub[threadIdx.x];
    s_start[r] = grid ? qrun[3LL * q + 1] : 0;
    s_n[r] = grid ? qrun[3LL * q + 2] : a.nt;
    s_q[r] = rk_query<T, FORM>(a, q, sl);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = W / (RK_TILE / 32);
  for (int lo = 0; lo < nb;) {
    const int hi = rk_segment_end(s_b, lo, nb);
    const int start = s_start[lo], n = s_n[lo];
    for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
      const int k0 = tile * RK_TILE + warp * RK_SLICE;
      if (k0 >= n) break;
      RkCand<T> c[RK_SLOTS];
#pragma unroll
      for (int j = 0; j < RK_SLOTS; ++j)
        c[j] = rk_cand<T, FORM>(a, start, k0 + 32 * j + lane, n, sl);
      for (int p = lo; p < hi; ++p) {
        const RkQuery<T> r = s_q[p];
        uint32_t* wq = bits + (long long)r.q * W + k0 / 32;
#pragma unroll
        for (int j = 0; j < RK_SLOTS; ++j) {
          const unsigned bal = __ballot_sync(0xffffffffu, rk_pass<T, FORM>(a, r, c[j], sl));
          if (lane == 0 && k0 + 32 * j < n) wq[j] = bal;
        }
      }
    }
    lo = hi;
  }
}

// A warp per query whose walk fits one slice: candidates in registers,
// each round's ballot ranking its kept ids, the row padded with nt.
template <typename T, int FORM>
__global__ void __launch_bounds__(256) rk_short_kernel(const RowkArgs<T> a) {
  const int q = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= a.Nq) return;
  const T sl = *a.sl;
  int start = 0, n = a.nt;
  if (a.offsets != nullptr) {
    const int b = rk_bucket(a, q);
    rk_run(a, b, &start, &n);
    if (lane == 0) atomicMax(&a.maxes[1], a.offsets[b + 1] - a.offsets[b]);
  }
  const RkQuery<T> r = rk_query<T, FORM>(a, q, sl);
  int* out = a.tid + (long long)q * a.K;
  int count = 0;
#pragma unroll
  for (int j = 0; j < RK_SLOTS; ++j) {
    const RkCand<T> c = rk_cand<T, FORM>(a, start, 32 * j + lane, n, sl);
    const bool pass = rk_pass<T, FORM>(a, r, c, sl);
    const unsigned bal = __ballot_sync(0xffffffffu, pass);
    const int pos = count + stk_rank(bal, lane);
    if (pass && pos < a.K) out[pos] = c.t;
    count += __popc(bal);
  }
  for (int p = min(count, a.K) + lane; p < a.K; p += 32) out[p] = a.nt;
  if (lane == 0) atomicMax(&a.maxes[0], count);
}

// The (Nq, K) ids filled with nt, four a store, before the emit writes the
// kept ones: the padding of rows far longer than their count (K up to
// 16,384) at the card's write rate.
__global__ void rk_fill_kernel(int4* __restrict__ tid4, long long n4, int* __restrict__ tail,
                               int ntail, int nt) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4 v = make_int4(nt, nt, nt, nt);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride)
    tid4[i] = v;
  if (blockIdx.x == 0 && threadIdx.x < ntail) tail[threadIdx.x] = nt;
}

// A warp per query: its words in walk order (32 a round, a warp scan of
// their set bits), the first K set positions' ids written over the fill,
// its count into max_row.
template <typename T>
__global__ void __launch_bounds__(256)
    rk_emit_kernel(const RowkArgs<T> a, int W, const uint32_t* __restrict__ bits,
                   const int* __restrict__ qrun) {
  const int q = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= a.Nq) return;
  const bool grid = a.offsets != nullptr;
  const int start = grid ? qrun[3LL * q + 1] : 0;
  const int n = grid ? qrun[3LL * q + 2] : a.nt;
  const int nw = (n + 31) / 32;
  const uint32_t* wq = bits + (long long)q * W;
  int* out = a.tid + (long long)q * a.K;
  int count = 0;
  for (int c0 = 0; c0 < nw; c0 += 32) {
    const int wi = c0 + lane;
    const uint32_t w = wi < nw ? wq[wi] : 0u;
    const int pc = __popc(w);
    int x = pc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const int base = count + x - pc;
    if (grid && count < a.K) {
      // word j of the chunk, lane L its bit L: the ids of a word are one
      // coalesced line of the run, and the words' loads overlap
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const uint32_t wj = __shfl_sync(0xffffffffu, w, j);
        const int pos = __shfl_sync(0xffffffffu, base, j) + stk_rank(wj, lane);
        if (((wj >> lane) & 1u) && pos < a.K)
          out[pos] = rk_walk_id(a, start, 32 * (c0 + j) + lane);
      }
    } else if (!grid) {
      // dense: an id is its walk position; lane L writes its word's bits
      for (uint32_t v = w; v != 0u; v &= v - 1u) {
        const int b = __ffs(v) - 1, pos = base + stk_rank(w, b);
        if (pos >= a.K) break;
        out[pos] = rk_walk_id(a, start, 32 * wi + b);
      }
    }
    count += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) atomicMax(&a.maxes[0], count);
}

// the kernels of a launch: the one-kernel path for short walks, else (the
// grid's runs,) the mark, the fill and the emit
template <typename T, int FORM>
static void rk_kernels(const RowkArgs<T>& a, int W, uint32_t* bits, int* qrun,
                       cudaStream_t stream) {
  const unsigned rows8 = (a.Nq + 7) / 8;
  if (rk_short(a.offsets != nullptr ? a.occ_cap : a.nt)) {
    rk_short_kernel<T, FORM><<<rows8, 256, 0, stream>>>(a);
    return;
  }
  if (a.offsets != nullptr)
    rk_run_kernel<T><<<stk_blocks(a.Nq, 256), 256, 0, stream>>>(a, qrun);
  const dim3 grid((a.Nq + RK_BLOCK_Q - 1) / RK_BLOCK_Q, rk_tile_stride(a.Nq, W));
  rk_mark_kernel<T, FORM><<<grid, 32 * RK_WARPS, 0, stream>>>(a, W, bits, qrun);
  // the torch allocation of tid is 16-byte aligned
  const long long n = (long long)a.Nq * a.K, n4 = n / 4;
  const long long fill = (n4 + 255) / 256;
  rk_fill_kernel<<<(unsigned)(fill < 4096 ? (fill > 0 ? fill : 1) : 4096), 256, 0, stream>>>(
      reinterpret_cast<int4*>(a.tid), n4, a.tid + 4 * n4, (int)(n - 4 * n4), a.nt);
  rk_emit_kernel<T><<<rows8, 256, 0, stream>>>(a, W, bits, qrun);
}

template <typename T>
static int launch_rowk(const RowkArgs<T>& a, int* scratch, cudaStream_t stream) {
  cudaMemsetAsync(a.maxes, 0, 2 * sizeof(int), stream);
  if (a.Nq == 0) return stk_launch_status();
  const int W = rk_words(a.offsets != nullptr ? a.occ_cap : a.nt);
  uint32_t* bits = reinterpret_cast<uint32_t*>(scratch);
  int* qrun = scratch + (long long)a.Nq * W;
  switch (a.form) {
    case FORM_GRID:
      rk_kernels<T, FORM_GRID>(a, W, bits, qrun, stream);
      break;
    case FORM_PT:
      rk_kernels<T, FORM_PT>(a, W, bits, qrun, stream);
      break;
    case FORM_EE:
      rk_kernels<T, FORM_EE>(a, W, bits, qrun, stream);
      break;
    default:
      rk_kernels<T, FORM_ET>(a, W, bits, qrun, stream);
      break;
  }
  return stk_launch_status();
}
#define RK_TAIL , cudaStream_t stream
#define RK_PASS_TAIL , stream
#define RK_ENTRY(SFX) STK_API int stk_rowk_select_##SFX
#else
// The host build (g++, the CPU tests): the runs, then each block's ordering,
// segments and tiles, each warp's slice and its rounds' lanes in turn, then
// the emit; a short walk's rows one by one.
template <typename T, int FORM>
static void rk_mark(const RowkArgs<T>& a, int W, uint32_t* bits, const int* qrun) {
  const T sl = *a.sl;
  const bool grid = a.offsets != nullptr;
  const int ntiles = W / (RK_TILE / 32), gy = rk_tile_stride(a.Nq, W);
  for (int p0 = 0; p0 < a.Nq; p0 += RK_BLOCK_Q)
    for (int y = 0; y < gy; ++y) {
      const int nb = a.Nq - p0 < RK_BLOCK_Q ? a.Nq - p0 : RK_BLOCK_Q;
      int s_ub[RK_BLOCK_Q], s_b[RK_BLOCK_Q], s_start[RK_BLOCK_Q], s_n[RK_BLOCK_Q];
      RkQuery<T> s_q[RK_BLOCK_Q];
      for (int k = 0; k < nb; ++k) s_ub[k] = grid ? qrun[3LL * (p0 + k)] : 0;
      for (int k = 0; k < nb; ++k) {
        const int q = p0 + k, r = rk_rank(s_ub, nb, k);
        s_b[r] = s_ub[k];
        s_start[r] = grid ? qrun[3LL * q + 1] : 0;
        s_n[r] = grid ? qrun[3LL * q + 2] : a.nt;
        s_q[r] = rk_query<T, FORM>(a, q, sl);
      }
      for (int lo = 0; lo < nb;) {
        const int hi = rk_segment_end(s_b, lo, nb);
        const int start = s_start[lo], n = s_n[lo];
        for (int w = 0; w < RK_WARPS; ++w)
          for (int tile = y; tile < ntiles; tile += gy) {
            const int k0 = tile * RK_TILE + w * RK_SLICE;
            if (k0 >= n) break;
            RkCand<T> c[RK_SLOTS][32];
            for (int j = 0; j < RK_SLOTS; ++j)
              for (int lane = 0; lane < 32; ++lane)
                c[j][lane] = rk_cand<T, FORM>(a, start, k0 + 32 * j + lane, n, sl);
            for (int p = lo; p < hi; ++p)
              for (int j = 0; j < RK_SLOTS; ++j) {
                uint32_t bal = 0u;
                for (int lane = 0; lane < 32; ++lane)
                  if (rk_pass<T, FORM>(a, s_q[p], c[j][lane], sl)) bal |= 1u << lane;
                if (k0 + 32 * j < n) bits[(long long)s_q[p].q * W + k0 / 32 + j] = bal;
              }
          }
        lo = hi;
      }
    }
}

// A walk of at most one slice (rk_short): each query's rounds, their lanes
// in turn, a lane's kept id placed by the round's ballot.
template <typename T, int FORM>
static void rk_short_rows(const RowkArgs<T>& a) {
  const T sl = *a.sl;
  for (int q = 0; q < a.Nq; ++q) {
    int start = 0, n = a.nt;
    if (a.offsets != nullptr) {
      const int b = rk_bucket(a, q);
      rk_run(a, b, &start, &n);
      const int occ = a.offsets[b + 1] - a.offsets[b];
      if (occ > a.maxes[1]) a.maxes[1] = occ;
    }
    const RkQuery<T> r = rk_query<T, FORM>(a, q, sl);
    int* out = a.tid + (long long)q * a.K;
    int count = 0;
    for (int j = 0; j < RK_SLOTS; ++j) {
      RkCand<T> c[32];
      uint32_t bal = 0u;
      for (int lane = 0; lane < 32; ++lane) {
        c[lane] = rk_cand<T, FORM>(a, start, 32 * j + lane, n, sl);
        if (rk_pass<T, FORM>(a, r, c[lane], sl)) bal |= 1u << lane;
      }
      for (int lane = 0; lane < 32; ++lane) {
        const int pos = count + stk_rank(bal, lane);
        if (((bal >> lane) & 1u) && pos < a.K) out[pos] = c[lane].t;
      }
      count += stk_popc(bal);
    }
    for (int p = count < a.K ? count : a.K; p < a.K; ++p) out[p] = a.nt;
    if (count > a.maxes[0]) a.maxes[0] = count;
  }
}

template <typename T, int FORM>
static void rk_rows(const RowkArgs<T>& a, int W, uint32_t* bits, const int* qrun) {
  if (rk_short(a.offsets != nullptr ? a.occ_cap : a.nt))
    rk_short_rows<T, FORM>(a);
  else
    rk_mark<T, FORM>(a, W, bits, qrun);
}

template <typename T>
static int launch_rowk(const RowkArgs<T>& a, int* scratch) {
  a.maxes[0] = a.maxes[1] = 0;
  if (a.Nq == 0) return 0;
  const bool grid = a.offsets != nullptr;
  const int walk = grid ? a.occ_cap : a.nt;
  const int W = rk_words(walk);
  uint32_t* bits = reinterpret_cast<uint32_t*>(scratch);
  int* qrun = scratch + (long long)a.Nq * W;
  if (grid && !rk_short(walk))
    for (int q = 0; q < a.Nq; ++q) {
      rk_query_run(a, q, qrun);
      const int b = qrun[3LL * q], occ = a.offsets[b + 1] - a.offsets[b];
      if (occ > a.maxes[1]) a.maxes[1] = occ;
    }
  switch (a.form) {
    case FORM_GRID:
      rk_rows<T, FORM_GRID>(a, W, bits, qrun);
      break;
    case FORM_PT:
      rk_rows<T, FORM_PT>(a, W, bits, qrun);
      break;
    case FORM_EE:
      rk_rows<T, FORM_EE>(a, W, bits, qrun);
      break;
    default:
      rk_rows<T, FORM_ET>(a, W, bits, qrun);
      break;
  }
  if (rk_short(walk)) return 0;
  for (int q = 0; q < a.Nq; ++q) {
    const int start = grid ? qrun[3LL * q + 1] : 0;
    const int n = grid ? qrun[3LL * q + 2] : a.nt;
    int* out = a.tid + (long long)q * a.K;
    // the warp scan of the words' set bits, a word at a time
    int count = 0;
    for (int wi = 0; wi < (n + 31) / 32; ++wi) {
      const uint32_t w = bits[(long long)q * W + wi];
      for (int b = 0; b < 32; ++b) {
        const int pos = count + stk_rank(w, b);
        if (((w >> b) & 1u) && pos < a.K) out[pos] = rk_walk_id(a, start, 32 * wi + b);
      }
      count += stk_popc(w);
    }
    for (int p = count < a.K ? count : a.K; p < a.K; ++p) out[p] = a.nt;
    if (count > a.maxes[0]) a.maxes[0] = count;
  }
  return 0;
}
#define RK_TAIL
#define RK_PASS_TAIL
#define RK_ENTRY(SFX) STK_API int stk_host_rowk_select_##SFX
#endif

#define RK_ENTRIES(SFX, T)                                                             \
  RK_ENTRY(SFX)(int form, int pred, const T* qc, int Nq, const T* qa, const T* qb,    \
                const T* tc, int nt, const T* ta, const T* tb, const T* sl,           \
                const int* qm, const int* tm, int M, const uint8_t* allowed,          \
                const int* qidx, int qk, const int* tidx, int tk, const int* offsets, \
                const int* tid_sorted, int occ_cap, int table_size, const T* h,       \
                int K, int* tid, int* maxes, int* scratch RK_TAIL) {                  \
    const RowkArgs<T> a{form, pred, qc, Nq, qa, qb, tc, nt, ta, tb, sl, qm, tm, M,   \
                        allowed, qidx, qk, tidx, tk, offsets, tid_sorted, occ_cap,    \
                        table_size, h, K, tid, maxes};                                \
    return launch_rowk<T>(a, scratch RK_PASS_TAIL);                                   \
  }

RK_ENTRIES(f32, float)
RK_ENTRIES(f64, double)
