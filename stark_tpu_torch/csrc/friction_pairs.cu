// Kernel I: the lagged-friction pair lists over the dense candidate grids,
// and in its contact mode the staged contact lists.
//
// Replaces the dense branch of stark_tpu/models/interactions/
// contact_engine.py `friction_tables` (:1549-1577, with `_pt_dense_d` :1019
// and `_ee_dense_d` :1031). Over every (q, t) of a primitive grid (points x
// triangles, or edges x edges) it keeps the pairs with
//     allowed[q, t]  &&  mu[mesh_q[q], mesh_t[t]] != 0  &&  d(q, t) <= dhat,
//     dhat = th[mesh_q[q]] + th[mesh_t[t]],
// and lists them in row-major (q, t) order into (q, t, d, dhat) of capacity
// cap, with the exact total count (it may exceed cap; rows past it are 0).
// JAX builds the full (N, M) distance matrix, lifts mu onto it with one-hot
// matmuls (`_lift_mesh_pair`, an MXU device) and compacts the mask; here mu
// is read through the per-primitive mesh ids and no N x M array is written.
//
// Contact mode (entry points stk_contact_pairs_pt/ee, launch names
// contact_pairs[pt]/[ee]): the same pass without the mu predicate, the
// dense branch of stark_tpu `_contacts_fn` (contact_engine.py:1192-1222):
// every allowed pair with d <= dhat, in row-major order. The grids are
// templated on kMu so the contact mode reads no mu table.
//
// Design. A block takes a tile of PL_WARPS rows x PL_TILE_COLS (512)
// columns, a warp a row of it:
//   0. prep (a thread per column primitive, once per launch): its axis-
//      aligned box, the cull's margin terms and th[mesh] (scratch);
//   1. mark: the block stages its 512 columns' records in shared memory
//      with coalesced loads; lane L reads the mask bytes of columns 16L ..
//      16L + 15 in one 16-byte load; then 16 rounds walk the tile 32
//      columns at a time, lane L taking column 32k + L (consecutive records
//      of shared memory, no bank conflict): the sound box cull below
//      rejects the pairs that cannot be kept, narrow.cuh's exact distance
//      decides the rest, and the round's ballot is the bit word of columns
//      32k .. 32k + 31 (Nq x 16 words per tile); the warp stores the
//      words and the tile's count;
//   2. kernel E's two-level exclusive scan (compact.cu) over the counts in
//      row-major (row, tile) order gives each tile's offset and the total;
//   3. emit: a warp per (row, tile) reads its 16 words and recomputes d and
//      dhat only for the set bits (the same code, so the same bits), lane L
//      writing column 32k + L at the tile's offset plus the set bits before
//      it: the twin's nonzero order, with no order from atomics. The same
//      pass zeroes the rows in [count, cap).
// The distance is narrow.cuh's, which rounds as the twin does (no FMA
// contraction, the twin's operation order), so a pair at d ~ dhat gets the
// twin's verdict and the lists equal the twin's.
//
// The cull. A pair is rejected before its exact distance when
//     l2 * (1 - 2k)  >  dhat^2 (1 + 32u) + 2k D^2,
// l2 the squared separation of the two boxes (the point and the triangle's
// box for PT, box against box for EE), D the sum of the two boxes'
// diagonals, u the unit roundoff of T, k = margin_k(kappa2) below. Why that
// never rejects a pair the exact test keeps. Let S be the diagonal of the
// pair's union box: every difference of two of its vertices is at most S,
// and S <= l + D, so S^2 <= 2 l^2 + 2 D^2 and the test above implies
// l^2 > dhat^2 (1 + 32u) + k S^2 (l2's and the test's own roundings, a few
// u relative, are inside the 32u and k's 64u). The exact test keeps iff
// sqrt(max(sq, tiny)) <= dhat in T, with sq the squared distance of the
// region the classifier picks; sq > dhat^2 (1 + 2u)^2 rounds to d > dhat.
// So it is enough that sq >= l^2 - eps S^2 with eps <= k, region by region
// (first-order error bounds; the constants of margin_k are these bounds
// times 4):
//   - point-point (PT 0-2, EE 0-3): |p - q|^2 to 6u relative, and the
//     vertex lies in its box: sq >= l^2 - 6u S^2.
//   - point-line (PT 3-5; EE 4-7 of the general branch and 4-5 of the
//     parallel one): picked only where the point's computed parameter s
//     on the segment lies in [0, 1]; the true s is within ~8u S / |e| of
//     it, so the foot on the line is within 8u S of the segment and the
//     line distance is the segment's to (8u S)^2 (Pythagoras). The
//     difference of squares |ap|^2 - (ap.ab)^2 / |ab|^2 cancels: its
//     rounding is ~24u |ap|^2 <= 24u S^2 (ROADMAP Queue 3 item 3). A
//     point-line formula with a tiny |ab|^2 is guarded to |ap|^2.
//   - EE 6-7 of the parallel branch (an end of one edge to the other's
//     line, chosen by the parameters of the other edge's ends along the
//     first): the two lines are parallel to sin^2 <= ptol + 48u (the
//     cutoff, plus cross_sq's rounding of ~32u a c), so the foot leaves
//     the segment by at most S tan(theta): eps = 2 (ptol + 48u); k_par
//     doubles it.
//   - PT face (6, the classifier's fallback) and EE line-line (8): the
//     computed normal n_c is off the true one by theta <= 8u kappa, kappa
//     = L^2 / |n| (PT: L the longest edge; EE: |u||v| / |u x v|), so the
//     plane (line-line) distance errs by <= 2 theta S^2 + theta^2 S^2, and
//     the classifier's fallback / interior parameters misplace the foot by
//     <= 4 theta S (PT) or 36u kappa^2 S (EE: the parameters sN / D carry
//     D's cancellation, 4u a c over |u x v|^2): eps <= 10u + 16u kappa^2 +
//     1345 u^2 kappa^4.
//   margin_k(k2) = 64u + 64u k2 + 8192 u^2 k2^2 covers each at kappa2 = k2
//   (>= 1) with a factor 4, and the cull's own roundings.
// kappa2 comes from the data, bounded below by the rounding: PT per
// triangle, (L^2 / (|n_c| - 8u L^2))^2 with n_c the face formula's own
// normal; EE per pair, a c / (|u x v|^2 - 32u a c), or 4.01 where the
// pair is well conditioned (a c - b^2 >= a c / 4 up to rounding, so its
// cross_sq clears both the cutoff and the guard when ptol <= 0.1).
// Where a formula's guard returns 0 (a face normal with |n_c|^2 <= tiny; a
// non-parallel EE pair with |u x v|^2 at or below max(ptol_default a c,
// tiny), evaluated with narrow.cuh's own operations so the verdict is the
// classifier's), the exact test keeps the pair at d = sqrt(tiny), and the
// cull never rejects it; where kappa2's denominator is not positive or
// 2k >= 1/2, it rejects nothing. The EE cull is off for ptol > 0.1.
// tests/test_torch_pair_lists_host.py holds this on the CPU: the g++ build
// of this file lists exactly what it lists with the cull off, and the twin's
// pairs, on grids built to sit inside the margin.
//
// Bound: bytes or operations, from the data: the mask, vertices, table,
// mesh ids, mu and th read once, the lists written once, and the exact
// distance only for the pairs that are kept (chip_smoke.py prices it).
#include "narrow.cuh"

#define PL_LANE_COLS 16
#define PL_TILE_COLS (32 * PL_LANE_COLS)
#define PL_TILE_WORDS (PL_TILE_COLS / 32)
#define PL_WARPS 8

// the unit roundoff of T
template <typename T>
STK_HD T unit_roundoff();
template <>
STK_HD float unit_roundoff<float>() { return 5.9604644775390625e-08f; }
template <>
STK_HD double unit_roundoff<double>() { return 1.1102230246251565e-16; }

template <typename T>
STK_HD T margin_k(T k2) {
  const T u = unit_roundoff<T>();
  return T(64) * u + T(64) * u * k2 + T(8192) * u * u * k2 * k2;
}

template <typename T>
STK_HD T tmax(T a, T b) {
  return a > b ? a : b;
}
template <typename T>
STK_HD T tmin(T a, T b) {
  return a < b ? a : b;
}

// the cull: true where the pair is rejected
template <typename T>
STK_HD bool cull_rejects(T l2, T dh, T B, T A) {
  const T G = T(1) + T(32) * unit_roundoff<T>();
  return l2 * B > dh * dh * G + A;
}

// ---------------------------------------------------------------------------
// PT: rows are points, columns triangles. Column record fields:
// lo xyz, hi xyz, A, B, th[mesh_t]
// ---------------------------------------------------------------------------
template <typename T, bool kMu>
struct PtGrid {
  typedef T Real;
  static constexpr int NF = 9;
  const T* V;
  const int* tris;
  const uint8_t* allowed;
  const int* mesh_q;
  const int* mesh_t;
  const T* mu;
  const T* th;
  int M, Nq, Nt;
  T* col;   // NF x Nt (scratch)

  struct Row {
    V3<T> p;
    T th;
    int mesh;
  };

  STK_HD void prep(int j) const {
    const int* tri = tris + 3LL * j;
    const V3<T> t0 = ld3(V + 3LL * tri[0]), t1 = ld3(V + 3LL * tri[1]),
                t2 = ld3(V + 3LL * tri[2]);
    const T lo[3] = {tmin(tmin(t0.x, t1.x), t2.x), tmin(tmin(t0.y, t1.y), t2.y),
                     tmin(tmin(t0.z, t1.z), t2.z)};
    const T hi[3] = {tmax(tmax(t0.x, t1.x), t2.x), tmax(tmax(t0.y, t1.y), t2.y),
                     tmax(tmax(t0.z, t1.z), t2.z)};
    T diag2 = T(0);
    for (int k = 0; k < 3; ++k) {
      col[k * Nt + j] = lo[k];
      col[(3 + k) * Nt + j] = hi[k];
      diag2 += (hi[k] - lo[k]) * (hi[k] - lo[k]);
    }
    // the face formula's own normal (sq_point_plane) and its guard
    const V3<T> n = cross(sub(t0, t2), sub(t1, t2));
    const T nn = dot(n, n);
    const V3<T> e0 = sub(t1, t0), e1 = sub(t2, t1), e2 = sub(t0, t2);
    const T L2 = tmax(tmax(dot(e0, e0), dot(e1, e1)), dot(e2, e2));
    const T nl = sqrt(nn) - T(8) * unit_roundoff<T>() * L2;
    T A = T(0), B = T(0);   // rejects nothing
    if (nn > T(STK_TINY) && nl > T(0)) {
      const T kap = L2 / nl;
      const T k = margin_k(kap * kap);
      if (k < T(0.25)) {
        B = T(1) - T(2) * k;
        A = T(2) * k * diag2;
      }
    }
    col[6 * Nt + j] = A;
    col[7 * Nt + j] = B;
    col[8 * Nt + j] = th[mesh_t[j]];
  }

  STK_HD Row row(int i) const {
    const int m = mesh_q[i];
    return Row{ld3(V + 3LL * i), th[m], m};
  }

  // c: a column's record in `s` with field stride `stride`
  STK_HD bool rejects(const Row& r, const T* s, int stride, int c) const {
    const T gx = tmax(tmax(s[c] - r.p.x, r.p.x - s[3 * stride + c]), T(0));
    const T gy = tmax(tmax(s[stride + c] - r.p.y, r.p.y - s[4 * stride + c]), T(0));
    const T gz = tmax(tmax(s[2 * stride + c] - r.p.z, r.p.z - s[5 * stride + c]), T(0));
    const T l2 = gx * gx + gy * gy + gz * gz;
    return cull_rejects(l2, r.th + s[8 * stride + c], s[7 * stride + c],
                        s[6 * stride + c]);
  }

  STK_HD bool exact(int i, int j, T* d, T* dhat) const {
    const int* tri = tris + 3LL * j;
    *d = point_triangle_distance(ld3(V + 3LL * i), ld3(V + 3LL * tri[0]),
                                 ld3(V + 3LL * tri[1]), ld3(V + 3LL * tri[2]));
    *dhat = rn_add(th[mesh_q[i]], th[mesh_t[j]]);
    return *d <= *dhat;
  }

  STK_HD bool mu_ok(int i, int j) const {
    return !kMu || mu[mesh_q[i] * M + mesh_t[j]] != T(0);
  }
};

// ---------------------------------------------------------------------------
// EE: rows and columns are the same edges. Record fields: lo xyz, hi xyz,
// v xyz (= e1 - e0, rounded as the classifier's u and v), D (the box's
// diagonal), th[mesh]
// ---------------------------------------------------------------------------
template <typename T, bool kMu>
struct EeGrid {
  typedef T Real;
  static constexpr int NF = 11;
  const T* V;
  const int* edges;
  const uint8_t* allowed;
  const int* mesh;
  const T* mu;
  const T* th;
  int M, Nq, Nt;
  T* col;
  T ptol;

  struct Row {
    T lo[3], hi[3];
    V3<T> u;
    T a, D, th;
    int mesh;
  };

  STK_HD void prep(int j) const {
    const int* e = edges + 2LL * j;
    const V3<T> e0 = ld3(V + 3LL * e[0]), e1 = ld3(V + 3LL * e[1]);
    const T x0[3] = {e0.x, e0.y, e0.z}, x1[3] = {e1.x, e1.y, e1.z};
    T diag2 = T(0);
    for (int k = 0; k < 3; ++k) {
      const T lo = tmin(x0[k], x1[k]), hi = tmax(x0[k], x1[k]);
      col[k * Nt + j] = lo;
      col[(3 + k) * Nt + j] = hi;
      diag2 += (hi - lo) * (hi - lo);
    }
    const V3<T> v = sub(e1, e0);
    col[6 * Nt + j] = v.x;
    col[7 * Nt + j] = v.y;
    col[8 * Nt + j] = v.z;
    col[9 * Nt + j] = sqrt(diag2);
    col[10 * Nt + j] = th[mesh[j]];
  }

  STK_HD Row row(int i) const {
    Row r;
    for (int k = 0; k < 3; ++k) {
      r.lo[k] = col[k * Nt + i];
      r.hi[k] = col[(3 + k) * Nt + i];
    }
    r.u = V3<T>{col[6 * Nt + i], col[7 * Nt + i], col[8 * Nt + i]};
    r.a = dot(r.u, r.u);
    r.D = col[9 * Nt + i];
    r.th = col[10 * Nt + i];
    r.mesh = mesh[i];
    return r;
  }

  // k of the pair (u, v): the well-conditioned constant, else from the
  // classifier's own cross_sq (narrow.cuh's operations, so the parallel
  // cut and the line-line guard decide as the classifier does)
  STK_HD T pair_k(const Row& r, V3<T> v) const {
    const T u = unit_roundoff<T>();
    if (!(ptol <= T(0.1))) return T(1);
    const T c = v.x * v.x + v.y * v.y + v.z * v.z;
    const T b = r.u.x * v.x + r.u.y * v.y + r.u.z * v.z;
    const T ac = r.a * c;
    if (ac > T(1e-30) && ac - b * b >= T(0.25) * ac) return margin_k(T(4.01));
    const V3<T> n = cross(r.u, v);
    const T cs = dot(n, n);
    const T cr = dot(v, v);
    if (cs < rn_mul(rn_mul(ptol, r.a), cr))
      return T(64) * u + T(4) * (ptol + T(48) * u);   // the parallel branch
    T fl = rn_mul(rn_mul(default_parallel_tol<T>(), r.a), cr);
    fl = fl > T(STK_TINY) ? fl : T(STK_TINY);
    if (!(cs > fl)) return T(1);   // line-line would be guarded to 0
    const T acr = r.a * cr;
    const T den = cs - T(32) * u * acr;
    if (!(den > T(0))) return T(1);
    return margin_k(acr / den);
  }

  STK_HD bool rejects(const Row& r, const T* s, int stride, int c) const {
    T l2 = T(0);
    for (int k = 0; k < 3; ++k) {
      const T g = tmax(tmax(s[k * stride + c] - r.hi[k], r.lo[k] - s[(3 + k) * stride + c]),
                       T(0));
      l2 += g * g;
    }
    const T k = pair_k(r, V3<T>{s[6 * stride + c], s[7 * stride + c], s[8 * stride + c]});
    if (!(k < T(0.25))) return false;
    const T D = r.D + s[9 * stride + c];
    return cull_rejects(l2, r.th + s[10 * stride + c], T(1) - T(2) * k,
                        T(2) * k * D * D);
  }

  STK_HD bool exact(int i, int j, T* d, T* dhat) const {
    const int* ea = edges + 2LL * i;
    const int* eb = edges + 2LL * j;
    *d = edge_edge_distance(ld3(V + 3LL * ea[0]), ld3(V + 3LL * ea[1]),
                            ld3(V + 3LL * eb[0]), ld3(V + 3LL * eb[1]), ptol);
    *dhat = rn_add(th[mesh[i]], th[mesh[j]]);
    return *d <= *dhat;
  }

  STK_HD bool mu_ok(int i, int j) const {
    return !kMu || mu[mesh[i] * M + mesh[j]] != T(0);
  }
};

// The 32 mask bits of round k of a row's tile (its columns 32k .. 32k + 31)
// from the lanes' 16-bit masks: lanes 2k and 2k + 1 read them.
STK_HD uint32_t round_word(uint32_t m_lo, uint32_t m_hi) { return m_lo | (m_hi << 16); }

// Whether an allowed pair of a row reaches the exact test: the cull (unless
// `cull` is off, the host build's check of it) does not reject it and its
// mu is nonzero. `s`/`stride`/`c`: the column's record in the tile's records.
template <class G>
STK_HD bool pair_tested(const G& g, const typename G::Row& r, int i, int j,
                        const typename G::Real* s, int stride, int c, bool cull) {
  return !(cull && g.rejects(r, s, stride, c)) && g.mu_ok(i, j);
}

// Whether the exact test keeps a pair.
template <class G>
STK_HD bool pair_exact(const G& g, int i, int j) {
  typename G::Real d, dhat;
  return g.exact(i, j, &d, &dhat);
}

// One kept pair written at pos of the lists.
template <class G>
STK_HD void emit_pair(const G& g, int i, int j, int pos, int* q, int* t,
                      typename G::Real* d_out, typename G::Real* dhat_out) {
  typename G::Real d, dhat;
  g.exact(i, j, &d, &dhat);
  q[pos] = i;
  t[pos] = j;
  d_out[pos] = d;
  dhat_out[pos] = dhat;
}

static inline int pl_tiles(int nt) { return (nt + PL_TILE_COLS - 1) / PL_TILE_COLS; }

// scratch bytes of a launch: the column records (NF T per column), then
// per (row, tile) a count, an offset and 16 bit words, and the scan's chunk
// sums
static long long pl_scratch_bytes(int nq, int nt, int nf, int el) {
  const long long cells = (long long)nq * pl_tiles(nt);
  const long long rec = ((long long)nf * nt * el + 15) / 16 * 16;
  return rec + cells * (2 + PL_TILE_WORDS) * 4 + stk_scan_partials(cells) * 4;
}

STK_API long long stk_pair_lists_scratch_bytes(int nq, int nt, int ee, int el) {
  return pl_scratch_bytes(nq, nt, ee ? EeGrid<float, false>::NF : PtGrid<float, false>::NF,
                          el);
}

#ifdef __CUDACC__
template <class G>
__global__ void pl_prep_kernel(G g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < g.Nt) g.prep(j);
}

// A warp per row of the block's tile. Lane L reads the mask bits of the
// tile's columns 16L .. 16L + 15 (one 16-byte load); the 16 rounds then
// walk the tile 32 columns at a time, lane L taking column 32k + L, so that
// the lanes read consecutive records of shared memory and each round's
// verdicts are one ballot: the bit word of columns 32k .. 32k + 31.
template <class G>
__global__ void __launch_bounds__(32 * PL_WARPS)
    pl_mark_kernel(G g, uint32_t* __restrict__ bits, int* __restrict__ counts) {
  typedef typename G::Real T;
  __shared__ T s[G::NF * PL_TILE_COLS];
  const int tile = blockIdx.y;
  const int ntiles = gridDim.y;
  const int c_base = tile * PL_TILE_COLS;
  const int ncols = min(PL_TILE_COLS, g.Nt - c_base);
  for (int k = threadIdx.x; k < G::NF * PL_TILE_COLS; k += blockDim.x) {
    const int f = k / PL_TILE_COLS, c = k % PL_TILE_COLS;
    s[k] = c < ncols ? g.col[(long long)f * g.Nt + c_base + c] : T(0);
  }
  __syncthreads();
  const int i = blockIdx.x * PL_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= g.Nq) return;
  const typename G::Row r = g.row(i);
  const int j0 = c_base + lane * PL_LANE_COLS;
  const uint32_t m = lane_mask16(g.allowed, (long long)g.Nq * g.Nt,
                                 (long long)i * g.Nt + j0, g.Nt - j0);
  // lanes 0..15 hold the rounds' mask words
  const uint32_t words = round_word(__shfl_sync(0xffffffffu, m, (2 * lane) & 31),
                                    __shfl_sync(0xffffffffu, m, (2 * lane + 1) & 31));
  int c = 0;
  uint32_t mine = 0u;
#pragma unroll 1
  for (int k = 0; k < PL_TILE_WORDS; ++k) {
    const uint32_t w = __shfl_sync(0xffffffffu, words, k);
    if (w == 0u) continue;
    const int col = 32 * k + lane;
    const bool keep = ((w >> lane) & 1u) &&
                      pair_tested(g, r, i, c_base + col, s, PL_TILE_COLS, col, true) &&
                      pair_exact(g, i, c_base + col);
    const uint32_t kw = __ballot_sync(0xffffffffu, keep);
    if (lane == k) mine = kw;
    c += __popc(kw);
  }
  const long long cell = (long long)i * ntiles + tile;
  if (lane < PL_TILE_WORDS) bits[cell * PL_TILE_WORDS + lane] = mine;
  if (lane == 0) counts[cell] = c;
}

// A warp per (row, tile): each round's word, lane L writing column 32k + L
// at the tile's offset plus the set bits before it. The same pass zeroes the
// rows in [count, cap).
template <class G>
__global__ void __launch_bounds__(32 * PL_WARPS)
    pl_emit_kernel(G g, const uint32_t* __restrict__ bits, const int* __restrict__ counts,
                   const int* __restrict__ offsets, const int* __restrict__ total, int cap,
                   int* __restrict__ q, int* __restrict__ t,
                   typename G::Real* __restrict__ d_out,
                   typename G::Real* __restrict__ dhat_out) {
  const long long nthreads = (long long)gridDim.x * gridDim.y * blockDim.x;
  const long long tid =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long p = *total + tid; p < cap; p += nthreads) {
    q[p] = 0;
    t[p] = 0;
    d_out[p] = 0;
    dhat_out[p] = 0;
  }
  const int tile = blockIdx.y;
  const int i = blockIdx.x * PL_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= g.Nq) return;
  const long long cell = (long long)i * gridDim.y + tile;
  if (counts[cell] == 0) return;
  int run = offsets[cell];
  if (run >= cap) return;
  const uint32_t words = lane < PL_TILE_WORDS ? bits[cell * PL_TILE_WORDS + lane] : 0u;
  const unsigned below = (1u << lane) - 1u;
  for (int k = 0; k < PL_TILE_WORDS && run < cap; ++k) {
    const uint32_t w = __shfl_sync(0xffffffffu, words, k);
    if (w == 0u) continue;
    const int pos = run + __popc(w & below);
    if (((w >> lane) & 1u) && pos < cap)
      emit_pair(g, i, tile * PL_TILE_COLS + 32 * k + lane, pos, q, t, d_out, dhat_out);
    run += __popc(w);
  }
}

template <class G>
static int launch_pairs(G g, int cap, int* q, int* t, typename G::Real* d,
                        typename G::Real* dhat, int* count, void* scratch,
                        cudaStream_t stream) {
  typedef typename G::Real T;
  if (g.Nq == 0 || g.Nt == 0) {
    if (cap > 0) {
      cudaMemsetAsync(q, 0, (size_t)cap * sizeof(int), stream);
      cudaMemsetAsync(t, 0, (size_t)cap * sizeof(int), stream);
      cudaMemsetAsync(d, 0, (size_t)cap * sizeof(T), stream);
      cudaMemsetAsync(dhat, 0, (size_t)cap * sizeof(T), stream);
    }
    cudaMemsetAsync(count, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  const int ntiles = pl_tiles(g.Nt);
  const long long cells = (long long)g.Nq * ntiles;
  char* base = static_cast<char*>(scratch);
  g.col = reinterpret_cast<T*>(base);
  base += ((long long)G::NF * g.Nt * sizeof(T) + 15) / 16 * 16;
  int* counts = reinterpret_cast<int*>(base);
  int* offsets = counts + cells;
  uint32_t* bits = reinterpret_cast<uint32_t*>(offsets + cells);
  int* partials = reinterpret_cast<int*>(bits + cells * PL_TILE_WORDS);
  pl_prep_kernel<G><<<stk_blocks(g.Nt, 128), 128, 0, stream>>>(g);
  const dim3 grid((g.Nq + PL_WARPS - 1) / PL_WARPS, ntiles);
  pl_mark_kernel<G><<<grid, 32 * PL_WARPS, 0, stream>>>(g, bits, counts);
  int rc = stk_exclusive_scan_i32_blocks(counts, cells, offsets, count, partials, stream);
  if (rc != 0) return rc;
  pl_emit_kernel<G><<<grid, 32 * PL_WARPS, 0, stream>>>(g, bits, counts, offsets, count,
                                                        cap, q, t, d, dhat);
  return stk_launch_status();
}
#else
// The host build (g++, the CPU tests): the same prep, mask, cull and exact
// functions; each round's lanes run in turn, and a serial scan. With `cull`
// 0 every allowed pair with a nonzero mu takes the exact test (what the
// cull must not change); *n_exact counts the pairs that take it.
template <class G>
static int launch_pairs(G g, int cap, int* q, int* t, typename G::Real* d,
                        typename G::Real* dhat, int* count, void* scratch, int cull,
                        int* n_exact) {
  typedef typename G::Real T;
  for (int p = 0; p < cap; ++p) {
    q[p] = t[p] = 0;
    d[p] = dhat[p] = T(0);
  }
  *count = 0;
  if (g.Nq == 0 || g.Nt == 0) return 0;
  const int ntiles = pl_tiles(g.Nt);
  const long long cells = (long long)g.Nq * ntiles;
  char* base = static_cast<char*>(scratch);
  g.col = reinterpret_cast<T*>(base);
  base += ((long long)G::NF * g.Nt * sizeof(T) + 15) / 16 * 16;
  int* counts = reinterpret_cast<int*>(base);
  int* offsets = counts + cells;
  uint32_t* bits = reinterpret_cast<uint32_t*>(offsets + cells);
  *n_exact = 0;
  for (int j = 0; j < g.Nt; ++j) g.prep(j);
  for (int i = 0; i < g.Nq; ++i) {
    const typename G::Row r = g.row(i);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int c_base = tile * PL_TILE_COLS;
      const long long cell = (long long)i * ntiles + tile;
      uint32_t m[32];
      for (int lane = 0; lane < 32; ++lane) {
        const int j0 = c_base + lane * PL_LANE_COLS;
        m[lane] = lane_mask16(g.allowed, (long long)g.Nq * g.Nt, (long long)i * g.Nt + j0,
                              g.Nt - j0);
      }
      int c = 0;
      for (int k = 0; k < PL_TILE_WORDS; ++k) {
        const uint32_t w = round_word(m[2 * k], m[2 * k + 1]);
        uint32_t kw = 0u;
        for (int lane = 0; lane < 32; ++lane) {
          const int j = c_base + 32 * k + lane;
          if (!((w >> lane) & 1u) || !pair_tested(g, r, i, j, g.col, g.Nt, j, cull != 0))
            continue;
          ++*n_exact;
          if (pair_exact(g, i, j)) kw |= 1u << lane;
        }
        bits[cell * PL_TILE_WORDS + k] = kw;
        c += stk_popc(kw);
      }
      counts[cell] = c;
    }
  }
  int run = 0;
  for (long long c = 0; c < cells; ++c) {
    offsets[c] = run;
    run += counts[c];
  }
  *count = run;
  for (int i = 0; i < g.Nq; ++i)
    for (int tile = 0; tile < ntiles; ++tile) {
      const long long cell = (long long)i * ntiles + tile;
      if (counts[cell] == 0) continue;
      int pos = offsets[cell];
      for (int k = 0; k < PL_TILE_WORDS && pos < cap; ++k) {
        const uint32_t w = bits[cell * PL_TILE_WORDS + k];
        for (int lane = 0; lane < 32 && pos < cap; ++lane)
          if ((w >> lane) & 1u)
            emit_pair(g, i, tile * PL_TILE_COLS + 32 * k + lane, pos++, q, t, d, dhat);
      }
    }
  return 0;
}
#endif

// the entry points' last arguments: the stream on the card; the host
// build's cull switch and exact-test count
#ifdef __CUDACC__
#define PL_TAIL , cudaStream_t stream
#define PL_PASS_TAIL , stream
#define PL_ENTRY(name) STK_API int stk_##name
#else
#define PL_TAIL , int cull, int* n_exact
#define PL_PASS_TAIL , cull, n_exact
#define PL_ENTRY(name) STK_API int stk_host_##name
#endif

template <typename T, bool kMu>
static int launch_pt(const T* V, const int* tris, int Np, int Nt, const uint8_t* allowed,
                     const int* mesh_p, const int* mesh_t, const T* mu, const T* th, int M,
                     int cap, int* q, int* t, T* d, T* dhat, int* count,
                     void* scratch PL_TAIL) {
  PtGrid<T, kMu> g{V, tris, allowed, mesh_p, mesh_t, mu, th, M, Np, Nt, nullptr};
  return launch_pairs(g, cap, q, t, d, dhat, count, scratch PL_PASS_TAIL);
}

template <typename T, bool kMu>
static int launch_ee(const T* V, const int* edges, int Ne, const uint8_t* allowed,
                     const int* mesh_e, const T* mu, const T* th, int M, double ptol,
                     int cap, int* a, int* b, T* d, T* dhat, int* count,
                     void* scratch PL_TAIL) {
  EeGrid<T, kMu> g{V, edges, allowed, mesh_e, mu, th, M, Ne, Ne, nullptr, (T)ptol};
  return launch_pairs(g, cap, a, b, d, dhat, count, scratch PL_PASS_TAIL);
}

#define PL_ENTRIES(T, SFX)                                                               \
  PL_ENTRY(friction_pairs_pt_##SFX)(const T* V, const int* tris, int Np, int Nt,         \
                                    const uint8_t* allowed, const int* mesh_p,           \
                                    const int* mesh_t, const T* mu, const T* th, int M,  \
                                    int cap, int* q, int* t, T* d, T* dhat, int* count,  \
                                    void* scratch PL_TAIL) {                           \
    return launch_pt<T, true>(V, tris, Np, Nt, allowed, mesh_p, mesh_t, mu, th, M, cap,  \
                              q, t, d, dhat, count, scratch PL_PASS_TAIL);             \
  }                                                                                      \
  PL_ENTRY(friction_pairs_ee_##SFX)(const T* V, const int* edges, int Ne,                \
                                    const uint8_t* allowed, const int* mesh_e,           \
                                    const T* mu, const T* th, int M, double ptol,        \
                                    int cap, int* a, int* b, T* d, T* dhat, int* count,  \
                                    void* scratch PL_TAIL) {                           \
    return launch_ee<T, true>(V, edges, Ne, allowed, mesh_e, mu, th, M, ptol, cap, a, b, \
                              d, dhat, count, scratch PL_PASS_TAIL);                   \
  }                                                                                      \
  /* contact mode: no mu table (nullptr, M = 0 are never read) */                        \
  PL_ENTRY(contact_pairs_pt_##SFX)(const T* V, const int* tris, int Np, int Nt,          \
                                   const uint8_t* allowed, const int* mesh_p,            \
                                   const int* mesh_t, const T* th, int cap, int* q,      \
                                   int* t, T* d, T* dhat, int* count,                    \
                                   void* scratch PL_TAIL) {                            \
    return launch_pt<T, false>(V, tris, Np, Nt, allowed, mesh_p, mesh_t, nullptr, th, 0, \
                               cap, q, t, d, dhat, count, scratch PL_PASS_TAIL);       \
  }                                                                                      \
  PL_ENTRY(contact_pairs_ee_##SFX)(const T* V, const int* edges, int Ne,                 \
                                   const uint8_t* allowed, const int* mesh_e,            \
                                   const T* th, double ptol, int cap, int* a, int* b,    \
                                   T* d, T* dhat, int* count,                            \
                                   void* scratch PL_TAIL) {                            \
    return launch_ee<T, false>(V, edges, Ne, allowed, mesh_e, nullptr, th, 0, ptol, cap, \
                               a, b, d, dhat, count, scratch PL_PASS_TAIL);            \
  }

PL_ENTRIES(float, f32)
PL_ENTRIES(double, f64)
