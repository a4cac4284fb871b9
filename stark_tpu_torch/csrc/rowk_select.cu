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
// runs lax.top_k on the f32 key nt - tid. Here one warp per query row walks
// its candidates in ascending target id, 32 at a time:
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
// (atomicMax). Those are `_rowk_topk`'s K smallest ids in its order.
//
// Rounding: the sphere test and the cell index round as the twin does
// (round-to-nearest intrinsics, no FMA contraction, the twin's order of
// sums, a true division for floor(qc / h)), so a pair on the boundary gets
// the twin's verdict.
//
// Bound: bytes on the grid (each query's centre, radii and mesh id, its
// bucket run and every candidate's sphere, mesh id and vertex ids read,
// the (Nq, K) ids written); operations dense (a sphere test per pair).
#include "stk_common.cuh"

#define RK_WARPS 8

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

__device__ __forceinline__ float rk_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rk_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rk_floor(float x) { return floorf(x); }
__device__ __forceinline__ double rk_floor(double x) { return ::floor(x); }

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

template <typename T>
__device__ __forceinline__ bool sphere_ok(const RowkArgs<T>& a, T qx, T qy, T qz,
                                          T qa, T qb, T sl, int t) {
  const T* c = a.tc + 3LL * t;
  const T dx = rn_sub(qx, c[0]);
  const T dy = rn_sub(qy, c[1]);
  const T dz = rn_sub(qz, c[2]);
  const T d2 = rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
  const T ta = a.ta[t];
  T rhs;
  switch (a.form) {
    case FORM_GRID:
      rhs = rn_add(qa, ta);
      break;
    case FORM_PT:
      rhs = rn_add(rn_add(rn_add(ta, sl), qa), a.tb[t]);
      break;
    case FORM_EE:
      rhs = rn_add(rn_add(rn_add(rn_add(qa, ta), sl), qb), a.tb[t]);
      break;
    default:  // FORM_ET
      rhs = rn_add(rn_add(qa, sl), ta);
      break;
  }
  return d2 <= rn_mul(rhs, rhs);
}

template <typename T>
__device__ __forceinline__ bool pred_ok(const RowkArgs<T>& a, int q, int qmesh,
                                        int qe0, int qe1, int t) {
  const int tmesh = a.tm[t];
  if (!a.allowed[qmesh * a.M + tmesh]) return false;
  const int* tv = a.tidx != nullptr ? a.tidx + (long long)a.tk * t : nullptr;
  switch (a.pred) {
    case PRED_PT_DD: {
      const bool inc = q == tv[0] || q == tv[1] || q == tv[2];
      return !(qmesh == tmesh && inc);
    }
    case PRED_PT_RR:
      return qmesh != tmesh;
    case PRED_EE_DD: {
      const bool approve = tmesh > qmesh || (tmesh == qmesh && t > q);
      const bool share = qe0 == tv[0] || qe0 == tv[1] || qe1 == tv[0] || qe1 == tv[1];
      return approve && !share;
    }
    case PRED_EE_RR:
      return tmesh > qmesh;
    case PRED_ET:
    case PRED_ET_RR: {
      const bool share = qe0 == tv[0] || qe0 == tv[1] || qe0 == tv[2] ||
                         qe1 == tv[0] || qe1 == tv[1] || qe1 == tv[2];
      if (share) return false;
      return a.pred == PRED_ET || qmesh != tmesh;
    }
    default:
      return true;
  }
}

template <typename T>
__global__ void rowk_select_kernel(const RowkArgs<T> a) {
  const int q = blockIdx.x * RK_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= a.Nq) return;
  const T qx = a.qc[3LL * q], qy = a.qc[3LL * q + 1], qz = a.qc[3LL * q + 2];
  const bool grid = a.offsets != nullptr;
  int start = 0, n = a.nt;
  if (grid) {
    const T h = *a.h;
    const uint32_t hx =
        ((uint32_t)(int)rk_floor(rk_div(qx, h)) * 73856093u) ^
        ((uint32_t)(int)rk_floor(rk_div(qy, h)) * 19349663u) ^
        ((uint32_t)(int)rk_floor(rk_div(qz, h)) * 83492791u);
    const int b = (int)(hx & (uint32_t)(a.table_size - 1));
    start = a.offsets[b];
    const int occ = a.offsets[b + 1] - start;
    if (lane == 0) atomicMax(&a.maxes[1], occ);
    n = min(occ, a.occ_cap);
  }
  const T qa = a.qa[q];
  const T qb = a.qb != nullptr ? a.qb[q] : T(0);
  const T sl = *a.sl;
  const int qmesh = a.qm[q];
  const int qe0 = a.qk > 0 ? a.qidx[(long long)a.qk * q] : -1;
  const int qe1 = a.qk > 1 ? a.qidx[(long long)a.qk * q + 1] : -1;
  int* out = a.tid + (long long)q * a.K;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    bool pass = false;
    int t = 0;
    if (k < n) {
      if (grid) {
        t = a.tid_sorted[start + k];
        pass = t < a.nt && (k == 0 || a.tid_sorted[start + k - 1] != t);
      } else {
        t = k;
        pass = true;
      }
      pass = pass && sphere_ok(a, qx, qy, qz, qa, qb, sl, t) &&
             pred_ok(a, q, qmesh, qe0, qe1, t);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, pass);
    const int pos = count + __popc(bal & below);
    if (pass && pos < a.K) out[pos] = t;
    count += __popc(bal);
  }
  for (int p = min(count, a.K) + lane; p < a.K; p += 32) out[p] = a.nt;
  if (lane == 0) atomicMax(&a.maxes[0], count);
}

template <typename T>
static int launch_rowk(int form, int pred, const T* qc, int Nq, const T* qa,
                       const T* qb, const T* tc, int nt, const T* ta, const T* tb,
                       const T* sl, const int* qm, const int* tm, int M,
                       const uint8_t* allowed, const int* qidx, int qk,
                       const int* tidx, int tk, const int* offsets,
                       const int* tid_sorted, int occ_cap, int table_size,
                       const T* h, int K, int* tid, int* maxes,
                       cudaStream_t stream) {
  cudaMemsetAsync(maxes, 0, 2 * sizeof(int), stream);
  if (Nq == 0) return stk_launch_status();
  RowkArgs<T> a{form, pred, qc, Nq, qa, qb, tc, nt, ta, tb, sl, qm, tm, M,
                allowed, qidx, qk, tidx, tk, offsets, tid_sorted, occ_cap,
                table_size, h, K, tid, maxes};
  rowk_select_kernel<T><<<(Nq + RK_WARPS - 1) / RK_WARPS, 32 * RK_WARPS, 0, stream>>>(a);
  return stk_launch_status();
}

#define RK_ENTRY(SUFFIX, T)                                                      \
  STK_API int stk_rowk_select_##SUFFIX(                                          \
      int form, int pred, const T* qc, int Nq, const T* qa, const T* qb,        \
      const T* tc, int nt, const T* ta, const T* tb, const T* sl, const int* qm, \
      const int* tm, int M, const uint8_t* allowed, const int* qidx, int qk,    \
      const int* tidx, int tk, const int* offsets, const int* tid_sorted,       \
      int occ_cap, int table_size, const T* h, int K, int* tid, int* maxes,     \
      cudaStream_t stream) {                                                    \
    return launch_rowk<T>(form, pred, qc, Nq, qa, qb, tc, nt, ta, tb, sl, qm, tm, \
                          M, allowed, qidx, qk, tidx, tk, offsets, tid_sorted,  \
                          occ_cap, table_size, h, K, tid, maxes, stream);       \
  }

RK_ENTRY(f32, float)
RK_ENTRY(f64, double)
