// Kernel F: the bounding-ball broad phase fused with its compaction.
//
// Replaces stark_tpu/models/interactions/contact_engine.py `_ball_wide`
// (:1102-1111, with the ball data of :1076-1100): every pair (i, j) of two
// ball sets with allowed[i, j] and
//     |a_i|^2 + |b_j|^2 - 2 a_i.b_j  <=  (ra_i + rb_j + extra)^2
// is emitted, in row-major (i, j) order, into the flat (q, t) lists of
// capacity cap, with the exact total count (it may exceed cap); q and t are
// 0 past the count. JAX builds the (Na, Nb) squared-distance matrix as one
// MXU matmul, writes the validity mask and compacts it through the trie;
// here no Na x Nb array is written, and every pair is tested once:
//   1. mark: a block takes BW_BLOCK_ROWS (32) rows x BW_TILE_COLS (512)
//      columns, a warp four rows of it. The block stages the tile's balls
//      (B as structure of arrays, |b|^2, rb) in shared memory with
//      coalesced loads (|b|^2 summed there and |a|^2 per row, in the twin's
//      order); lane L reads the mask bytes of columns 16L .. 16L + 15 of
//      each of its warp's rows in one 16-byte load; then 16 rounds
//      walk the tile 32 columns at a time, lane L taking column 32k + L (a
//      ball read once from shared memory serves the warp's four rows, held
//      in registers), and each round's ballot is the bit word of columns
//      32k .. 32k + 31 of a row. The warp stores a count per (row, tile) and
//      the tile's 16 words where the count is not 0;
//   2. kernel E's two-level exclusive scan (compact.cu) over the counts in
//      row-major (row, tile) order gives each tile's offset and the total;
//   3. emit: warps stride over the (row, tile) cells, each reading a cell's
//      count and, where it is not 0, its 16 words (not the mask, not the
//      balls), lane L writing column 32k + L of each nonzero word at the
//      tile's offset plus the set bits before it: the twin's nonzero order,
//      with no order from atomics. The same pass zeroes [count, cap). Pass 3 tests no pair, so
//      it cannot disagree with pass 1.
// The comparison is evaluated with round-to-nearest intrinsics in the twin's
// operation order, so nvcc cannot contract it into FMAs and move a pair
// across the threshold: kernel and twin select the same pairs.
//
// The same source builds with g++ (ops/build.py `host_broad_library`, the
// `#else` branches below), so the CPU tests hold the logic that decides the
// order. Shared with the card: the tiles, the mask words (lane_mask16,
// bw_round_word), the ball test, a set bit's place (stk_rank) and its
// column (bw_col). Modelled serially: the lanes of a round (the ballot),
// the scan over the counts (kernel E's on the card), and the emit's warp
// scan over a cell's words.
//
// Bound: bytes or operations, whichever is larger: the allowed mask (Na*Nb
// bytes) and the balls read once, the lists written once; 12 flops per
// pair. The design reads the mask once (two passes did before) and keeps
// the balls in shared memory and registers.
#include "stk_common.cuh"

#define BW_LANE_COLS 16
#define BW_TILE_COLS (32 * BW_LANE_COLS)
#define BW_TILE_WORDS (BW_TILE_COLS / 32)
#define BW_WARPS 8
#define BW_ROWS 4
#define BW_BLOCK_ROWS (BW_WARPS * BW_ROWS)

// |x|^2 as the twin sums it: (x0 x0 + x1 x1) + x2 x2
template <typename T>
STK_HD T bw_square(T x, T y, T z) {
  return rn_add(rn_add(rn_mul(x, x), rn_mul(y, y)), rn_mul(z, z));
}

// the ball test of one pair, in the twin's operation order
template <typename T>
STK_HD bool ball_test(T ax, T ay, T az, T a2, T ra, T bx, T by, T bz, T b2, T rb,
                      T extra) {
  const T ab = rn_add(rn_add(rn_mul(ax, bx), rn_mul(ay, by)), rn_mul(az, bz));
  const T m2 = rn_sub(rn_add(a2, b2), rn_mul(T(2), ab));
  const T rhs = rn_add(rn_add(ra, rb), extra);
  return m2 <= rn_mul(rhs, rhs);
}

// The 32 mask bits of round k of a row's tile (its columns 32k .. 32k + 31)
// from the lanes' 16-bit masks: lanes 2k and 2k + 1 read them.
STK_HD uint32_t bw_round_word(uint32_t m_lo, uint32_t m_hi) { return m_lo | (m_hi << 16); }

static inline int bw_tiles(int nb) { return (nb + BW_TILE_COLS - 1) / BW_TILE_COLS; }

// the column of bit `lane` of word k of a row's tile
STK_HD int bw_col(int tile, int k, int lane) { return tile * BW_TILE_COLS + 32 * k + lane; }

// scratch ints of a launch: per (row, tile) a count, an offset and 16 bit
// words, then the scan's chunk sums
STK_API long long stk_ball_wide_scratch_ints(int na, int nb) {
  const long long cells = (long long)na * bw_tiles(nb);
  return cells * (2 + BW_TILE_WORDS) + stk_scan_partials(cells);
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(32 * BW_WARPS)
    bw_mark_kernel(const T* __restrict__ A, const T* __restrict__ ra,
                   const T* __restrict__ B, const T* __restrict__ rb, int Na, int Nb,
                   const uint8_t* __restrict__ allowed, const T* __restrict__ extra,
                   uint32_t* __restrict__ bits, int* __restrict__ counts) {
  __shared__ T s[5][BW_TILE_COLS];
  const int tile = blockIdx.y;
  const int c_base = tile * BW_TILE_COLS;
  const int ncols = min(BW_TILE_COLS, Nb - c_base);
  // B's 3 * ncols coordinates are consecutive: coalesced
  for (int k = threadIdx.x; k < 3 * BW_TILE_COLS; k += blockDim.x)
    s[k % 3][k / 3] = k < 3 * ncols ? B[3LL * c_base + k] : T(0);
  for (int c = threadIdx.x; c < BW_TILE_COLS; c += blockDim.x)
    s[4][c] = c < ncols ? rb[c_base + c] : T(0);
  __syncthreads();
  for (int c = threadIdx.x; c < BW_TILE_COLS; c += blockDim.x)
    s[3][c] = bw_square(s[0][c], s[1][c], s[2][c]);
  __syncthreads();
  const T ex = *extra;
  const int lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * BW_BLOCK_ROWS + (threadIdx.x >> 5) * BW_ROWS;
  const int j0 = c_base + lane * BW_LANE_COLS;
  T ax[BW_ROWS], ay[BW_ROWS], az[BW_ROWS], aa[BW_ROWS], ar[BW_ROWS];
  uint32_t words[BW_ROWS];
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int i = min(i0 + r, Na - 1);
    ax[r] = A[3LL * i];
    ay[r] = A[3LL * i + 1];
    az[r] = A[3LL * i + 2];
    aa[r] = bw_square(ax[r], ay[r], az[r]);
    ar[r] = ra[i];
    const uint32_t m = i0 + r < Na ? lane_mask16(allowed, (long long)Na * Nb,
                                                  (long long)i * Nb + j0, Nb - j0)
                                   : 0u;
    // lanes 0..15 hold the rounds' mask words
    words[r] = bw_round_word(__shfl_sync(0xffffffffu, m, (2 * lane) & 31),
                             __shfl_sync(0xffffffffu, m, (2 * lane + 1) & 31));
  }
  uint32_t mine[BW_ROWS];
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) mine[r] = 0u;
#pragma unroll 1
  for (int k = 0; k < BW_TILE_WORDS; ++k) {
    uint32_t w[BW_ROWS];
    uint32_t any = 0u;
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      w[r] = __shfl_sync(0xffffffffu, words[r], k);
      any |= w[r];
    }
    if (any == 0u) continue;
    const int col = bw_col(0, k, lane);
    const T bx = s[0][col], by = s[1][col], bz = s[2][col], bb = s[3][col],
            br = s[4][col];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      // the test runs on every lane (no branch), its verdict masked
      const bool hit = ball_test(ax[r], ay[r], az[r], aa[r], ar[r], bx, by, bz, bb, br, ex) &
                       ((w[r] >> lane) & 1u);
      const uint32_t kw = __ballot_sync(0xffffffffu, hit);
      if (lane == k) mine[r] = kw;
    }
  }
  // lane k holds word k: the (row, tile) count is the sum of their bits
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    int c = __popc(mine[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (i0 + r >= Na) break;
    const long long cell = (long long)(i0 + r) * gridDim.y + tile;
    if (c > 0 && lane < BW_TILE_WORDS) bits[cell * BW_TILE_WORDS + lane] = mine[r];
    if (lane == 0) counts[cell] = c;
  }
}

// One (row, tile) cell of the emit: a warp scan of its words' set bits
// gives each word's offset; only the nonzero words are walked.
__device__ __forceinline__ void bw_emit_cell(long long cell, int ntiles, int c, int run,
                                             uint32_t word, int cap, int lane,
                                             int* __restrict__ q, int* __restrict__ t) {
  if (c == 0 || run >= cap) return;
  const int pc = __popc(word);
  int x = pc;
#pragma unroll
  for (int o = 1; o < BW_TILE_WORDS; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  const int pre = run + x - pc;
  const int i = (int)(cell / ntiles), tile = (int)(cell % ntiles);
  for (unsigned nz = __ballot_sync(0xffffffffu, word != 0u); nz != 0u; nz &= nz - 1u) {
    const int k = __ffs(nz) - 1;
    const uint32_t w = __shfl_sync(0xffffffffu, word, k);
    const int base = __shfl_sync(0xffffffffu, pre, k);
    if (base >= cap) return;
    const int pos = base + stk_rank(w, lane);
    if (((w >> lane) & 1u) && pos < cap) {
      q[pos] = i;
      t[pos] = bw_col(tile, k, lane);
    }
  }
}

// Warps stride over the (row, tile) cells. A cell's count, offset and words
// load together, the next cell's before this one's stores (its words are
// used only where its count is not 0); lane L writes column 32k + L of a
// nonzero word at the word's offset plus the set bits before it. The same
// pass zeroes the rows in [count, cap).
__global__ void __launch_bounds__(32 * BW_WARPS)
    bw_emit_kernel(long long cells, int ntiles, const uint32_t* __restrict__ bits,
                   const int* __restrict__ counts, const int* __restrict__ offsets,
                   const int* __restrict__ total, int cap, int* __restrict__ q,
                   int* __restrict__ t) {
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long p = *total + tid; p < cap; p += nthreads) {
    q[p] = 0;
    t[p] = 0;
  }
  const int lane = threadIdx.x & 31;
  const long long stride = nthreads >> 5;
  long long cell = tid >> 5;
  int c = 0, run = 0;
  uint32_t word = 0u;
  if (cell < cells) {
    c = counts[cell];
    run = offsets[cell];
    word = lane < BW_TILE_WORDS ? bits[cell * BW_TILE_WORDS + lane] : 0u;
  }
  for (; cell < cells; cell += stride) {
    // the next cell's loads go out before this cell's stores
    int c_next = 0, run_next = 0;
    uint32_t word_next = 0u;
    if (cell + stride < cells) {
      c_next = counts[cell + stride];
      run_next = offsets[cell + stride];
      word_next = lane < BW_TILE_WORDS ? bits[(cell + stride) * BW_TILE_WORDS + lane] : 0u;
    }
    bw_emit_cell(cell, ntiles, c, run, word, cap, lane, q, t);
    c = c_next, run = run_next, word = word_next;
  }
}

template <typename T>
static int launch_ball_wide(const T* A, const T* ra, const T* B, const T* rb, int Na, int Nb,
                            const uint8_t* allowed, const T* extra, int cap, int* q, int* t,
                            int* count, int* scratch, cudaStream_t stream) {
  if (Na == 0 || Nb == 0) {
    if (cap > 0) {
      cudaMemsetAsync(q, 0, (size_t)cap * sizeof(int), stream);
      cudaMemsetAsync(t, 0, (size_t)cap * sizeof(int), stream);
    }
    cudaMemsetAsync(count, 0, sizeof(int), stream);
    return stk_launch_status();
  }
  const int ntiles = bw_tiles(Nb);
  const long long cells = (long long)Na * ntiles;
  int* counts = scratch;
  int* offsets = counts + cells;
  uint32_t* bits = reinterpret_cast<uint32_t*>(offsets + cells);
  int* partials = reinterpret_cast<int*>(bits + cells * BW_TILE_WORDS);
  const dim3 mark((Na + BW_BLOCK_ROWS - 1) / BW_BLOCK_ROWS, ntiles);
  bw_mark_kernel<T><<<mark, 32 * BW_WARPS, 0, stream>>>(A, ra, B, rb, Na, Nb, allowed,
                                                        extra, bits, counts);
  int rc = stk_exclusive_scan_i32_blocks(counts, cells, offsets, count, partials, stream);
  if (rc != 0) return rc;
  // a few blocks per SM, each warp striding over cells
  const long long emit = (cells + BW_WARPS - 1) / BW_WARPS;
  bw_emit_kernel<<<(unsigned)(emit < 2048 ? emit : 2048), 32 * BW_WARPS, 0, stream>>>(
      cells, ntiles, bits, counts, offsets, count, cap, q, t);
  return stk_launch_status();
}
#define BW_TAIL , cudaStream_t stream
#define BW_PASS_TAIL , stream
#define BW_ENTRY(SFX) STK_API int stk_ball_wide_##SFX
#else
// The host build (g++, the CPU tests): the block's staged tile, each warp's
// rows, mask words and rounds with their lanes in turn, a serial scan, then
// the emit from the stored words alone.
template <typename T>
static int launch_ball_wide(const T* A, const T* ra, const T* B, const T* rb, int Na, int Nb,
                            const uint8_t* allowed, const T* extra, int cap, int* q, int* t,
                            int* count, int* scratch) {
  for (int p = 0; p < cap; ++p) q[p] = t[p] = 0;
  *count = 0;
  if (Na == 0 || Nb == 0) return 0;
  const int ntiles = bw_tiles(Nb);
  const long long cells = (long long)Na * ntiles;
  int* counts = scratch;
  int* offsets = counts + cells;
  uint32_t* bits = reinterpret_cast<uint32_t*>(offsets + cells);
  const T ex = *extra;
  T s[5][BW_TILE_COLS];
  for (int tile = 0; tile < ntiles; ++tile) {
    const int c_base = tile * BW_TILE_COLS;
    const int ncols = Nb - c_base < BW_TILE_COLS ? Nb - c_base : BW_TILE_COLS;
    for (int k = 0; k < 3 * BW_TILE_COLS; ++k)
      s[k % 3][k / 3] = k < 3 * ncols ? B[3LL * c_base + k] : T(0);
    for (int c = 0; c < BW_TILE_COLS; ++c) {
      s[4][c] = c < ncols ? rb[c_base + c] : T(0);
      s[3][c] = bw_square(s[0][c], s[1][c], s[2][c]);
    }
    for (int i = 0; i < Na; ++i) {
      uint32_t m[32];
      for (int lane = 0; lane < 32; ++lane) {
        const int j0 = c_base + lane * BW_LANE_COLS;
        m[lane] = lane_mask16(allowed, (long long)Na * Nb, (long long)i * Nb + j0, Nb - j0);
      }
      const long long cell = (long long)i * ntiles + tile;
      int c = 0;
      for (int k = 0; k < BW_TILE_WORDS; ++k) {
        const uint32_t w = bw_round_word(m[2 * k], m[2 * k + 1]);
        uint32_t kw = 0u;
        for (int lane = 0; lane < 32; ++lane) {
          const int col = bw_col(0, k, lane);
          if (((w >> lane) & 1u) &&
              ball_test(A[3LL * i], A[3LL * i + 1], A[3LL * i + 2],
                        bw_square(A[3LL * i], A[3LL * i + 1], A[3LL * i + 2]), ra[i],
                        s[0][col], s[1][col], s[2][col], s[3][col], s[4][col], ex))
            kw |= 1u << lane;
        }
        bits[cell * BW_TILE_WORDS + k] = kw;
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
  for (int i = 0; i < Na; ++i)
    for (int tile = 0; tile < ntiles; ++tile) {
      const long long cell = (long long)i * ntiles + tile;
      if (counts[cell] == 0) continue;
      // the warp scan of the words' set bits, a word at a time
      int base = offsets[cell];
      for (int k = 0; k < BW_TILE_WORDS && base < cap; ++k) {
        const uint32_t w = bits[cell * BW_TILE_WORDS + k];
        for (int lane = 0; lane < 32; ++lane) {
          const int pos = base + stk_rank(w, lane);
          if (((w >> lane) & 1u) && pos < cap) {
            q[pos] = i;
            t[pos] = bw_col(tile, k, lane);
          }
        }
        base += stk_popc(w);
      }
    }
  return 0;
}
#define BW_TAIL
#define BW_PASS_TAIL
#define BW_ENTRY(SFX) STK_API int stk_host_ball_wide_##SFX
#endif

#define BW_ENTRIES(T, SFX)                                                            \
  BW_ENTRY(SFX)(const T* A, const T* ra, const T* B, const T* rb, int Na, int Nb,     \
                const uint8_t* allowed, const T* extra, int cap, int* q, int* t,      \
                int* count, int* scratch BW_TAIL) {                                   \
    return launch_ball_wide<T>(A, ra, B, rb, Na, Nb, allowed, extra, cap, q, t, count, \
                               scratch BW_PASS_TAIL);                                 \
  }

BW_ENTRIES(float, f32)
BW_ENTRIES(double, f64)
