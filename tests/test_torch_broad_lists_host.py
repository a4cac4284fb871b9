"""Kernels F and L decide their lists' order on the CPU as on the card: the
g++ build of csrc/ball_wide.cu and csrc/rowk_select.cu (the card's sources,
each round's lanes run in turn; ops/build.py `host_broad_library`) equals
the plain twins exactly, in float32 and float64, on the inputs of
`stark_tpu_torch/tools/broad_cases.py` at small sizes:

- F (`ball_wide`): the (row, tile) counts, their offsets and the emit from
  the bit words give the twin's (q, t) in row-major order and its exact
  count, with a ragged last tile and lane, rows without an allowed pair,
  and the capacity cut inside a tile (0, 17) or out of reach;
- L (`rowk_select`): on a hand-built bucket index, the grouping of the
  queries by bucket (one bucket of 40 queries across three blocks of 16,
  buckets of one query, empty buckets), the staged tiles of a run past two
  tiles with a copy at each tile boundary, the run cut at occ_cap inside a
  tile, rows over K and rows that K holds whole; dense, every form and
  predicate over targets past two tiles; walks of at most one warp's slice
  (128 positions), which take one kernel, a warp per query, on the grid and
  dense. tid, max_row and max_occ equal the twin's.

What the host build shares with the card's code and what it models: the
tiles, mask words, ball test, hash, query ordering and segments, candidate
records with their copy check, predicates, a set bit's place in its word
or round (`stk_rank`) and its column or id (`bw_col`, `rk_walk_id`) are
the same functions in both builds; the lanes of a round (the card's
ballot), F's scan over the counts (kernel E's on the card) and the emits'
warp scans over the words are serial loops of the host branch. Only the card tests
(tests/test_torch_cuda.py) run those warp forms.
"""
import pytest
import torch

from stark_tpu_torch.ops import ball_wide as bw, rowk_select as rk
from stark_tpu_torch.tools import broad_cases as bc

DTYPES = [torch.float64, torch.float32]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(70, 1037), (40, 2000), (33, 15), (1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ball_wide_host_equals_twin(dtype, shape):
    """Kernel F's g++ build: q, t and the count exactly the twin's, with the
    capacity cut at 0, inside a tile, and out of reach."""
    na, nb = shape
    args = bc.ball_case(na + nb, na, nb, dtype)
    for cap in (0, 17, 10 ** 6):
        ref = bw.ball_wide_plain(*args, cap)
        out = bw.host_ball_wide(*args, cap)
        for a, b, what in zip(out, ref, ("q", "t", "count")):
            assert torch.equal(a, b), (what, cap)
    if na > 1:
        assert int(ref[2]) > 17


@pytest.mark.parametrize("code", list(rk.PREDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_rowk_grid_host_equals_twin(dtype, code):
    """Kernel L's g++ build in grid mode: the queries grouped by bucket,
    the long run staged in tiles with copies across their boundaries and
    cut at occ_cap, rows over K and rows K holds whole; tid, max_row and
    max_occ exactly."""
    qc, tc, sph, pred, grid = bc.rowk_grid_case(5, code, dtype)
    for K in (4, 512):
        ref = rk.rowk_select_plain(qc, tc, sph, pred, K, grid)
        out = rk.host_rowk_select(qc, tc, sph, pred, K, grid)
        for a, b, what in zip(out, ref, ("tid", "max_row", "max_occ")):
            assert torch.equal(a, b), (what, K)
    assert int(ref[2]) > grid.occ_cap > 2 * bc.RK_TILE
    assert 4 < int(ref[1]) < 512


@pytest.mark.parametrize("form,code", bc.ROWK_DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rowk_dense_host_equals_twin(dtype, form, code):
    """Kernel L's g++ build in dense mode: every form and predicate over
    2,600 targets (past two tiles) for 37 queries; tid and max_row exactly."""
    qc, tc, sph, pred = bc.rowk_dense_case(7, form, code, dtype)
    ref = rk.rowk_select_plain(qc, tc, sph, pred, 4)
    out = rk.host_rowk_select(qc, tc, sph, pred, 4)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert out[2] is None and int(ref[1]) > 4


@pytest.mark.parametrize("code", list(rk.PREDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_rowk_grid_short_walk_host_equals_twin(dtype, code):
    """Kernel L's g++ build on the grid with occ_cap 90 (a walk within one
    slice: the one-kernel path), the heavy run of 100 ids cut there."""
    qc, tc, sph, pred, grid = bc.rowk_grid_case(9, code, dtype, run=100, heavy=20, light=30,
                                                nt=300, occ_cap=90)
    for K in (2, 128):
        ref = rk.rowk_select_plain(qc, tc, sph, pred, K, grid)
        out = rk.host_rowk_select(qc, tc, sph, pred, K, grid)
        for a, b, what in zip(out, ref, ("tid", "max_row", "max_occ")):
            assert torch.equal(a, b), (what, K)
    assert int(ref[2]) > grid.occ_cap and int(ref[1]) > 2


@pytest.mark.parametrize("form,code", bc.ROWK_DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rowk_dense_short_walk_host_equals_twin(dtype, form, code):
    """Kernel L's g++ build dense over 100 targets (within one slice: the
    one-kernel path) for 37 queries; tid and max_row exactly."""
    qc, tc, sph, pred = bc.rowk_dense_case(3, form, code, dtype, nt=100)
    ref = rk.rowk_select_plain(qc, tc, sph, pred, 4)
    out = rk.host_rowk_select(qc, tc, sph, pred, 4)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
