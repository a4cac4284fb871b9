"""Kernels A-W (and the staged solver's sites: B [staged], A [direct], I's
contact mode) on a CUDA card against their plain twins, and small scenes on
the card against the port on the CPU.

These tests need a card and skip without one. On a machine with a card
(where JAX may be absent, so the suite's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is compared with its twin on the same inputs, including the
ragged cases the main path does not reach (empty segments, dropped rows,
widths other than 9, every supported matrix size).
"""
import numpy as np
import pytest
import torch

from stark_tpu_torch.collision import narrow_phase as nph
from stark_tpu_torch.ops import ball_wide as bw, compact as cp, narrow as nw
from stark_tpu_torch.ops import block3, build, hvp_bucket as hb, pd_project as pd
from stark_tpu_torch.ops import friction_pairs as fp, friction_rows as fr
from stark_tpu_torch.ops import segment_reduce as sr, segment_triangle as st
from stark_tpu_torch.ops import grid_build as gb, rowk_select as rk
from stark_tpu_torch.collision import broad_phase as bp
from stark_tpu_torch.ops import egh
from stark_tpu_torch.solver import project as tproj
from stark_tpu_torch.tools import broad_cases as bc, egh_cases as ec, pair_grids

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(absref, dtype, k):
    return k * torch.finfo(dtype).eps * absref + torch.finfo(dtype).tiny


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [1, 9, 13])
def test_segment_reduce_matches_cpu_twin(dev, dtype, width):
    rng = np.random.default_rng(width)
    n_seg = 500
    rows = torch.as_tensor(rng.integers(0, n_seg + 40, size=4000))
    rows[rows % 7 == 3] = 17            # one long segment
    rows[(rows > 200) & (rows < 260)] = n_seg + 5   # empty segments, dropped rows
    pay = torch.as_tensor(rng.normal(size=(4000, width)), dtype=dtype)
    csr_cpu = sr.build_csr(rows, n_seg)
    ref = sr.segment_reduce_plain(pay, csr_cpu)
    csr = sr.build_csr(rows.to(dev), n_seg)
    before = build.launches["segment_reduce[test]"]
    out = sr.segment_reduce(pay.to(dev), csr, "test")
    torch.cuda.synchronize()
    assert build.launches["segment_reduce[test]"] == before + 1
    # the same additions in the same order as the CPU twin
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    assert torch.all(out[201:260] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_direct_matches_cpu_twin(dev, dtype):
    """Kernel A's direct site (DirectLLT's dense matrix) on seeded pair
    keys, bit for bit against its twin: long runs on a few pairs, dropped
    keys, an empty block row, one block, no rows."""
    rng = np.random.default_rng(13)
    for n, R in ((1, 5), (37, 0), (64, 4000), (300, 20000)):
        pids = rng.integers(-2, n * n + 20, R)
        pids[: R // 4] = rng.integers(0, min(3, n * n), R // 4)
        pids[pids // max(n, 1) == 5] = n * n
        pay = torch.as_tensor(rng.normal(size=(R, 9)) * 10.0 ** rng.integers(-5, 5, (R, 1)),
                              dtype=dtype)
        ps = sr.sort_pairs(torch.as_tensor(pids), n)
        ref = sr.dense_direct_plain(pay, ps)
        before = build.launches["segment_reduce[direct]"]
        out = sr.dense_direct(pay.to(dev), sr.PairSort(ps.perm.to(dev), ps.key.to(dev), n))
        torch.cuda.synchronize()
        assert build.launches["segment_reduce[direct]"] == before + 1
        assert torch.equal(out.cpu(), ref), (n, R)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3, 4, 5])
def test_hvp_bucket_matches_twin(dev, dtype, b):
    rng = np.random.default_rng(b)
    n, E = 300, 700
    conn = torch.as_tensor(rng.integers(0, n + 1, size=(E, b)), dtype=torch.int32)
    A = rng.normal(size=(E, 3 * b, 3 * b))
    H = torch.as_tensor(A + A.transpose(0, 2, 1), dtype=dtype)
    p = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype)
    csr = sr.build_csr(conn.reshape(-1).to(dev), n)
    q = hb.hvp_bucket(p.to(dev), conn.to(dev), H.to(dev), csr)
    ref = hb.hvp_bucket_plain(p, conn, H, sr.build_csr(conn.reshape(-1), n))
    absref = hb.hvp_bucket_plain(p.abs(), conn, H.abs(),
                                 sr.build_csr(conn.reshape(-1), n))
    err = (q.cpu() - ref).abs()
    assert torch.all(err <= _tol(absref, dtype, 64.0))


def _skewed_groups(dtype, n=300, arities=(1, 3, 4, 5), hot=7, hot_entries=1500, seed=11):
    """Kernel B's groups on a skewed layout: block `hot` in `hot_entries`
    entries spread over the groups (a rigid body's row), 30 blocks in
    none, about one slot in ten the dummy id n."""
    rng = np.random.default_rng(seed)
    empty = rng.choice(np.setdiff1d(np.arange(n), [hot]), 30, replace=False)
    ids = np.setdiff1d(np.arange(n), empty)
    groups = []
    for g, a in enumerate(arities):
        n_hot = hot_entries // len(arities)
        conn = np.concatenate([rng.choice(ids, size=(200, a)), rng.choice(ids, size=(n_hot, a))])
        conn[rng.random(conn.shape) < 0.1] = n
        conn[-n_hot:, 0] = hot
        A = rng.normal(size=(len(conn), 3 * a, 3 * a))
        conn = torch.as_tensor(conn, dtype=torch.int32)
        groups.append((conn, torch.as_tensor(A + A.transpose(0, 2, 1), dtype=dtype),
                       sr.build_csr(conn.reshape(-1), n)))
    p = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype)
    return groups, p, empty


def _on(groups, dev):
    return [(c.to(dev), H.to(dev), sr.Csr(s.perm.to(dev), s.offsets.to(dev), s.seg.to(dev),
                                          s.n_seg, s.n_rows)) for c, H, s in groups]


@pytest.mark.parametrize("dtype", DTYPES)
def test_hvp_groups_match_twin_on_a_skewed_layout(dev, dtype):
    """Kernel B over four groups in one launch (one row of 1,500 entries,
    empty rows, dummy ids) against its twin (each group's product, added in
    order) within 64 eps sum|terms|; the same bits from two launches; one
    launch per product; a single group and eight groups too, and twelve
    groups in two launches, the second adding its four to the first's q."""
    groups, p, empty = _skewed_groups(dtype)
    ref = hb.hvp_groups_plain(p, groups)
    absref = hb.hvp_groups_plain(p.abs(), [(c, H.abs(), s) for c, H, s in groups])
    g = _on(groups, dev)
    lens = sum(s.offsets[1:] - s.offsets[:-1] for _c, _H, s in groups)
    assert int(lens.max()) > 1000 and int(lens[empty].max()) == 0
    before = build.launches["hvp_bucket"]
    q, q2 = hb.hvp_groups(p.to(dev), g), hb.hvp_groups(p.to(dev), g)
    torch.cuda.synchronize()
    assert build.launches["hvp_bucket"] == before + 2
    assert torch.equal(q, q2)
    assert torch.all((q.cpu() - ref).abs() <= _tol(absref, dtype, 64.0))
    assert torch.all(q.cpu()[empty] == 0)
    one = hb.hvp_bucket(p.to(dev), *g[2])
    eight = hb.hvp_groups(p.to(dev), g + g)
    torch.cuda.synchronize()
    ref1 = hb.hvp_bucket_plain(p, *groups[2])
    abs1 = hb.hvp_bucket_plain(p.abs(), groups[2][0], groups[2][1].abs(), groups[2][2])
    assert torch.all((one.cpu() - ref1).abs() <= _tol(abs1, dtype, 64.0))
    assert torch.all((eight.cpu() - hb.hvp_groups_plain(p, groups + groups)).abs()
                     <= _tol(2 * absref, dtype, 64.0))
    before = build.launches["hvp_bucket"]
    twelve = hb.hvp_groups(p.to(dev), g + g + g)
    torch.cuda.synchronize()
    assert build.launches["hvp_bucket"] == before + 2
    assert torch.all((twelve.cpu() - hb.hvp_groups_plain(p, groups + groups + groups)).abs()
                     <= _tol(3 * absref, dtype, 64.0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [2, 3, 9, 12, 15, 16])
@pytest.mark.parametrize("mirroring,masked", [(False, False), (True, True)])
def test_pd_project_matches_twin(dev, dtype, d, mirroring, masked):
    rng = np.random.default_rng(d)
    A = rng.normal(size=(257, d, d))
    H = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), dtype=dtype, device=dev)
    H[::3] = H[::3] @ H[::3].transpose(1, 2)            # PD: passes through
    mask = torch.as_tensor(rng.random(257) < 0.8, device=dev) if masked else None
    out, ch = pd.pd_project(H, 1e-9, mirroring, mask, 8)
    ref, ch_ref = pd.pd_project_plain(H, 1e-9, mirroring, mask, 8)
    torch.cuda.synchronize()
    scale = H.abs().amax(dim=(1, 2), keepdim=True)
    assert torch.all((out - ref).abs() <= 2000.0 * torch.finfo(dtype).eps * scale)
    keep = ~ch
    assert torch.equal(out[keep], H[keep])
    if d > 3 and dtype == torch.float64:
        w = torch.linalg.eigvalsh(out[ch])
        assert float(w.min()) > -1e-8 * float(scale.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [17, 24, 33, 64, 65, 96, 112, 128])
@pytest.mark.parametrize("sweeps", [8, 16])
def test_pd_project_wide_matches_twin(dev, dtype, d, sweeps):
    """Kernel C's one-warp layout (16 < d <= 64), and past it kernel Z's
    wide layouts (A and V in shared memory to d = 119 in float64 and 169 in
    float32, else a global scratch buffer: d = 128 in float64), reached
    through project_family_to_pd as a family of more than 16 DOFs reaches
    them, against the twin's Jacobi on the same sweeps. A matrix whose twin
    result lies within 100 eps max|H_e| of the exact projection (eigh in
    float64) has converged: there the kernel is within 2000 eps max|H_e|
    of the twin, as at d <= 16. Where the sweeps leave matrices
    unconverged (8 sweeps from d ~ 24 in float64, ~ 48 in float32),
    rounding differences steer the two through different rotations, so
    they are held to the projection instead: the kernel's largest
    distance from it within twice the twin's."""
    rng = np.random.default_rng(d)
    A = rng.normal(size=(129, d, d))
    H = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), dtype=dtype, device=dev)
    H[::3] = H[::3] @ H[::3].transpose(1, 2)            # PD: passes through
    mask = torch.as_tensor(rng.random(129) < 0.8, device=dev)
    site = "pd_project[wide]" if d <= pd.KERNEL_WIDE_MAX_D else "pd_project_z"
    before = build.launches[site]
    out, ch = tproj.project_family_to_pd(H, 1e-9, True, mask, jacobi_sweeps=sweeps)
    ref, ch_ref = pd.pd_project_plain(H, 1e-9, True, mask, sweeps)
    torch.cuda.synchronize()
    assert build.launches[site] == before + 1
    assert torch.equal(ch, ch_ref)
    assert torch.equal(out[~ch], H[~ch])
    H64 = H.double().cpu()
    w, V = torch.linalg.eigh(H64)
    exact = torch.einsum("eij,ej,ekj->eik", V, torch.where(w < 1e-9, -w, w), V)
    eps = torch.finfo(dtype).eps
    scale = H64.abs().amax(dim=(1, 2))
    spread = (ref.double().cpu() - exact).abs().amax(dim=(1, 2))
    dist = (out.double().cpu() - exact).abs().amax(dim=(1, 2))
    err = (out - ref).double().cpu().abs().amax(dim=(1, 2))
    c = ch.cpu()
    conv = c & (spread <= 100.0 * eps * scale)
    print(f"d={d} {dtype} sweeps={sweeps} ({pd.z_layout(d, dtype)}): "
          f"{int(conv.sum())} of {int(c.sum())} "
          f"converged, |kernel - twin| / (eps max|H_e|) there "
          f"{float((err / (eps * scale))[conv].max()) if conv.any() else 0.0:.4g}; "
          f"largest distance from the projection / (eps max|H_e|), kernel "
          f"{float((dist / (eps * scale))[c].max()):.4g}, twin "
          f"{float((spread / (eps * scale))[c].max()):.4g}")
    assert torch.all(err[conv] <= 2000.0 * eps * scale[conv])
    un = c & ~conv
    if un.any():
        assert float((dist / scale)[un].max()) <= 2.0 * float((spread / scale)[un].max())


def test_pd_project_refuses_exact_eigh_on_cuda(dev):
    """Exact eigh (jacobi_sweeps = 0) on the card no longer refuses: it is
    kernel Z's converged Jacobi, within 2000 eps max|H_e| of its twin and
    of the float64 eigh projection, every matrix converged."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 4, 4))
    H = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), device=dev)
    before = build.launches["pd_project_z"]
    unconv = torch.zeros((), dtype=torch.int32, device=dev)
    out, ch = pd.pd_project_z(H, 1e-9, False, None, 0, unconv)
    legacy, ch_legacy = pd.pd_project(H, 1e-9, False, None, 0)
    ref, ch_ref = pd.pd_project_z_plain(H.cpu(), 1e-9, False, None, 0)
    exact, _ch = pd.pd_project_plain(H.cpu(), 1e-9, False, None, 0)
    torch.cuda.synchronize()
    assert build.launches["pd_project_z"] == before + 2 and int(unconv) == 0
    assert torch.equal(ch.cpu(), ch_ref) and torch.equal(ch_legacy.cpu(), ch_ref)
    tol = 2000.0 * torch.finfo(H.dtype).eps * H.cpu().abs().amax(dim=(1, 2), keepdim=True)
    assert torch.all((out.cpu() - ref).abs() <= tol)
    assert torch.all((out.cpu() - exact).abs() <= tol)
    assert torch.equal(out, legacy)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block3_matches_twin(dev, dtype):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(1000, 3, 3))
    D = torch.as_tensor(A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3), dtype=dtype)
    D[::10] = 0.0
    D[5::10] = 1.0
    Di = block3.block3_inverse(D.to(dev))
    Di_ref = block3.block3_inverse_plain(D)
    cond = D.abs().sum(-1).amax(-1) * Di_ref.abs().sum(-1).amax(-1)
    tol = 64 * torch.finfo(dtype).eps * cond[:, None, None] \
        * Di_ref.abs().amax(dim=(1, 2), keepdim=True)
    assert torch.all((Di.cpu() - Di_ref).abs() <= tol + torch.finfo(dtype).tiny)
    assert torch.equal(Di[::10].cpu(), torch.eye(3, dtype=dtype).expand(100, 3, 3))
    r = torch.as_tensor(rng.normal(size=(1000, 3)), dtype=dtype)
    z = block3.block3_apply(Di_ref.to(dev), r.to(dev))
    absref = block3.block3_apply_plain(Di_ref.abs(), r.abs())
    assert torch.all((z.cpu() - block3.block3_apply_plain(Di_ref, r)).abs()
                     <= _tol(absref, dtype, 8.0))


@pytest.mark.parametrize("n,cap,p", [(0, 16, 0.5), (1000, 64, 0.3),
                                     (12345, 20000, 0.01), (300001, 100, 0.2)])
def test_compact_matches_twin(dev, n, cap, p):
    """Kernel E: the same ascending buffer, zero padding and total count
    (also past the capacity, and for an empty mask)."""
    mask = torch.as_tensor(np.random.default_rng(n).random(n) < p)
    idx_ref, cnt_ref = cp.compact_plain(mask, cap)
    before = build.launches["compact[test]"]
    idx, cnt = cp.compact(mask.to(dev), cap, "test")
    torch.cuda.synchronize()
    assert build.launches["compact[test]"] == before + 1
    assert int(cnt) == int(cnt_ref)
    assert torch.equal(idx.cpu(), idx_ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [50, 100000])
def test_ball_wide_matches_twin(dev, dtype, cap):
    """Kernel F: the same pairs in the same order as the twin's dense mask
    plus nonzero; exact count past the capacity."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.random((333, 3)), dtype=dtype)
    B = torch.as_tensor(rng.random((517, 3)), dtype=dtype)
    ra = torch.as_tensor(0.05 * rng.random(333), dtype=dtype)
    rb = torch.as_tensor(0.05 * rng.random(517), dtype=dtype)
    allowed = torch.as_tensor(rng.random((333, 517)) < 0.8).to(torch.uint8)
    extra = torch.tensor(0.01, dtype=dtype)
    ref = bw.ball_wide_plain(A, ra, B, rb, allowed, extra, cap)
    out = bw.ball_wide(A.to(dev), ra.to(dev), B.to(dev), rb.to(dev),
                       allowed.to(dev), extra.to(dev), cap)
    torch.cuda.synchronize()
    assert int(out[2]) == int(ref[2]) > 50
    assert torch.equal(out[0].cpu(), ref[0]) and torch.equal(out[1].cpu(), ref[1])


def _to(dev, x):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [None if y is None else _to(dev, y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(700, 5037), (2000, 513), (45, 15), (1, 1)])
def test_ball_wide_tiles_match_twin(dev, dtype, shape):
    """Kernel F's tiles (tools/broad_cases.py): a last tile and lane cut
    short, rows without an allowed pair, the capacity cut at 0, inside a
    tile and out of reach: (q, t, count) bit for bit the twin's, and a
    relaunch gives the same bits."""
    na, nb = shape
    args = bc.ball_case(na + nb, na, nb, dtype)
    n = int(bw.ball_wide_plain(*args, 1)[2])
    for cap in (0, 17, n // 2 + 5, n + 1000):
        ref = bw.ball_wide_plain(*args, cap)
        out = bw.ball_wide(*_to(dev, args), cap)
        again = bw.ball_wide(*_to(dev, args), cap)
        torch.cuda.synchronize()
        for a, b, c, what in zip(out, again, ref, ("q", "t", "count")):
            assert torch.equal(a.cpu(), c) and torch.equal(a, b), (what, cap)
    assert na == 1 or n > 17


@pytest.mark.parametrize("dtype", DTYPES)
def test_ball_wide_w_et_size(dev, dtype):
    """Kernel F at the oracle's w_et size of the 64x64 scale point: 12,434 x
    8,204 balls (102 M pairs, the mask past the 50 MB L2), ~1 M hits;
    bit for bit the twin's (on the card) and the same bits when relaunched."""
    args = _to(dev, bc.ball_case(17, 12434, 8204, dtype, hits_per_row=80.0))
    cap = 1 << 21
    ref = bw.ball_wide_plain(*args, cap)
    out = bw.ball_wide(*args, cap)
    again = bw.ball_wide(*args, cap)
    torch.cuda.synchronize()
    for a, b, c, what in zip(out, again, ref, ("q", "t", "count")):
        assert torch.equal(a, c) and torch.equal(a, b), what
    assert 500_000 < int(ref[2]) < cap


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("code", list(rk.PREDS))
def test_rowk_grid_tiles_match_twin(dev, dtype, code):
    """Kernel L's grid mode on a hand-built bucket index: 150 queries in one
    bucket, whose run of 6,000 ids (copies at each staged tile's boundary)
    occ_cap cuts at 5,000, inside a tile; 200 buckets of one query or none;
    rows over K and rows K holds whole. tid, max_row and max_occ exactly
    the twin's."""
    qc, tc, sph, pred, grid = bc.rowk_grid_case(11, code, dtype, run=6000, heavy=150,
                                                light=200, nt=8000, occ_cap=5000,
                                                table_size=65536)
    for K in (4, 1024):
        ref = rk.rowk_select_plain(qc, tc, sph, pred, K, grid)
        out = rk.rowk_select(*_to(dev, (qc, tc, sph, pred)), K, _to(dev, grid))
        torch.cuda.synchronize()
        for a, b, what in zip(out, ref, ("tid", "max_row", "max_occ")):
            assert torch.equal(a.cpu(), b), (what, K)
    assert int(ref[2]) > grid.occ_cap and 4 < int(ref[1]) < 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form,code", bc.ROWK_DENSE)
def test_rowk_dense_tiles_match_twin(dev, dtype, form, code):
    """Kernel L's dense mode, every form and predicate: 301 queries (off the
    block's 16) over 5,000 targets (past four staged tiles); tid and
    max_row exactly the twin's."""
    qc, tc, sph, pred = bc.rowk_dense_case(13, form, code, dtype, nq=301, nt=5000)
    ref = rk.rowk_select_plain(qc, tc, sph, pred, 8)
    out = rk.rowk_select(*_to(dev, (qc, tc, sph, pred)), 8)
    torch.cuda.synchronize()
    assert torch.equal(out[0].cpu(), ref[0]) and int(out[1]) == int(ref[1]) > 8


ROWK_SHORT = [("grid", p) for p in rk.PREDS] + [("dense", fc) for fc in bc.ROWK_DENSE]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,case", ROWK_SHORT)
def test_rowk_short_walks_match_twin(dev, dtype, mode, case):
    """Kernel L where every walk fits one warp's slice (occ_cap 90 on the
    grid, 100 targets dense): the one-kernel path, exactly the twin's."""
    if mode == "grid":
        qc, tc, sph, pred, grid = bc.rowk_grid_case(9, case, dtype, run=100, heavy=40,
                                                    light=200, nt=300, occ_cap=90,
                                                    table_size=65536)
    else:
        (qc, tc, sph, pred), grid = bc.rowk_dense_case(3, *case, dtype, nq=301, nt=100), None
    ref = rk.rowk_select_plain(qc, tc, sph, pred, 8, grid)
    out = rk.rowk_select(*_to(dev, (qc, tc, sph, pred)), 8, _to(dev, grid))
    torch.cuda.synchronize()
    n = 3 if grid is not None else 2
    for a, b, what in zip(out[:n], ref[:n], ("tid", "max_row", "max_occ")):
        assert torch.equal(a.cpu(), b), what


def _grid_spheres(rng, dtype, Q, T, lo, hi):
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    return (f(rng.uniform(lo, hi, (Q, 3))), f(rng.uniform(0.01, 0.05, Q)),
            f(rng.uniform(lo, hi, (T, 3))), f(rng.uniform(0.01, 0.3, T)))


# (Q, T, centre range, ins_slots, table_size): both signs of cells; negative
# cells only; insertions cut at ins_slots (max_cells > ins) in a small table
GRID_BUILD_CASES = [(500, 700, (-1.0, 1.0), 512, 4096),
                    (64, 90, (-3.0, -1.0), 512, 256),
                    (151, 397, (-0.5, 0.5), 8, 256)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", GRID_BUILD_CASES)
def test_grid_build_matches_twin(dev, dtype, case):
    """Kernel K: the bucket offsets, the ids sorted by (bucket, id) with
    their copies, the T past the last run and max_cells equal the twin's
    argsort formulation exactly."""
    Q, T, (lo, hi), ins, tsz = case
    qc, qr, tc, tr = _grid_spheres(np.random.default_rng(Q + T), dtype, Q, T, lo, hi)
    h = bp.pick_cell_size(qr, tr)
    mq = bp.max_query_radius(qr)
    ref = gb.grid_build_plain(tc, tr, mq, h, ins, tsz)
    out = gb.grid_build(tc.to(dev), tr.to(dev), mq.to(dev), h.to(dev), ins, tsz)
    torch.cuda.synchronize()
    for x, y, what in zip(out, ref, ("offsets", "tid_sorted", "max_cells")):
        assert torch.equal(x.cpu(), y), what
    assert int(ref[0][-1]) > 0 and (ins > int(ref[2])) == (case[3] == 512)


def _rowk_inputs(rng, dtype, pred, Nq, nt, M=3, nv=60):
    """Queries and targets in a 0.4 m box around the origin (cells of both
    signs) with mesh ids from M meshes, a random allowed table, and vertex
    tables drawn from nv vertices (so shared vertices and same-mesh
    incidence occur)."""
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)
    qc, tc = f(rng.uniform(-0.2, 0.2, (Nq, 3))), f(rng.uniform(-0.2, 0.2, (nt, 3)))
    qa, qb = f(rng.uniform(0.005, 0.03, Nq)), f(rng.uniform(0.0, 0.01, Nq))
    ta, tb = f(rng.uniform(0.005, 0.05, nt)), f(rng.uniform(0.0, 0.01, nt))
    allowed = torch.as_tensor(rng.random(M * M) < 0.8).to(torch.uint8)
    allowed[0] = 1
    tk = 3 if pred in ("pt_dd", "et", "et_rr") else 2
    p = rk.Pred(pred, i32(rng.integers(0, M, Nq)), i32(rng.integers(0, M, nt)),
                allowed, qidx=i32(rng.integers(0, nv, (Nq, 2))),
                tidx=i32(rng.integers(0, nv, (nt, tk))))
    return qc, tc, qa, qb, ta, tb, p


ROWK_CASES = [("grid", "grid", p) for p in rk.PREDS] + \
    [("dense", "pt", "pt_dd"), ("dense", "pt", "pt_rr"), ("dense", "pt", "none"),
     ("dense", "ee", "ee_dd"), ("dense", "ee", "ee_rr"), ("dense", "ee", "none"),
     ("dense", "et", "et"), ("dense", "et", "et_rr"), ("dense", "et", "none")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,form,pred", ROWK_CASES)
def test_rowk_select_matches_twin(dev, dtype, mode, form, pred):
    """Kernel L: the same (Nq, K) ids, max_row and max_occ as the twin's
    mask + top_k, for every stem's predicate, on the hash grid (bucket runs
    cut at occ_cap, copies dropped) and dense, with rows over K."""
    rng = np.random.default_rng(len(pred) * 7 + len(form))
    Nq, nt, K = 700, 900, 4
    qc, tc, qa, qb, ta, tb, p = _rowk_inputs(rng, dtype, pred, Nq, nt)
    sl = torch.tensor(0.004, dtype=dtype)
    grid = None
    if mode == "grid":
        sph = rk.Sphere("grid", qa, ta)
        h = bp.pick_cell_size(qa, ta)
        offs, tids, _cells = gb.grid_build_plain(tc, ta, bp.max_query_radius(qa), h,
                                                 64, bp.table_size_for(nt))
        grid = rk.GridIndex(offs, tids, h, 24)
    else:
        sph = rk.Sphere(form, qa, ta, qb=qb, tb=tb, sl=sl)
    ref = rk.rowk_select_plain(qc, tc, sph, p, K, grid)
    to = lambda x: None if x is None else x.to(dev)
    sph_d = rk.Sphere(sph.form, *(to(x) for x in sph[1:]))
    p_d = rk.Pred(p.code, *(to(x) for x in p[1:]))
    grid_d = None if grid is None else rk.GridIndex(
        grid.offsets.to(dev), grid.tid_sorted.to(dev), grid.h.to(dev), grid.occ_cap)
    out = rk.rowk_select(qc.to(dev), tc.to(dev), sph_d, p_d, K, grid_d)
    torch.cuda.synchronize()
    assert torch.equal(out[0].cpu(), ref[0])
    assert int(out[1]) == int(ref[1]) > K
    if mode == "grid":
        assert int(out[2]) == int(ref[2]) > grid.occ_cap
    assert int(build.launches["rowk_select"]) > 0


def _contact_geometry(rng, dtype, n_rows=5000):
    V = torch.as_tensor(rng.normal(size=(400, 3)), dtype=dtype)
    V[200:220] = V[180:200] + 1e-9          # near-coincident vertices
    tris = torch.as_tensor(rng.integers(0, 400, size=(300, 3)), dtype=torch.int32)
    edges = torch.as_tensor(rng.integers(0, 400, size=(350, 2)), dtype=torch.int32)
    edges[:20, 1] = edges[:20, 0]                   # zero-length edges
    V[edges[20:40, 1].long()] = V[edges[20:40, 0].long()] \
        + 0.5 * (V[edges[40:60, 1].long()] - V[edges[40:60, 0].long()])  # parallel
    q = torch.as_tensor(rng.integers(0, 400, size=n_rows), dtype=torch.int32)
    t = torch.as_tensor(rng.integers(0, 300, size=n_rows), dtype=torch.int32)
    a = torch.as_tensor(rng.integers(0, 350, size=n_rows), dtype=torch.int32)
    b = torch.as_tensor(rng.integers(0, 350, size=n_rows), dtype=torch.int32)
    b[:200] = torch.as_tensor(np.arange(40, 60).repeat(10), dtype=torch.int32)
    a[:200] = torch.as_tensor(np.arange(20, 40).repeat(10), dtype=torch.int32)
    act = torch.as_tensor(rng.random(n_rows) < 0.9)
    return V, tris, edges, q, t, a, b, act


@pytest.mark.parametrize("dtype", DTYPES)
def test_pt_ee_distance_matches_twin(dev, dtype):
    """Kernel G: distances within a few eps of the twin's (the same region
    logic and guards), keep masks equal away from the bound."""
    rng = np.random.default_rng(4)
    V, tris, edges, q, t, a, b, act = _contact_geometry(rng, dtype)
    bound = torch.as_tensor(rng.random(q.shape[0]) * 2.0, dtype=dtype)
    off = torch.as_tensor(0.1 * rng.random(q.shape[0]), dtype=dtype)
    eps = torch.finfo(dtype).eps
    g = [x.to(dev) for x in (V, tris, edges, q, t, a, b, act, bound, off)]
    d, keep = nw.pt_distance(g[0], g[0], g[1], g[3], g[4], g[7], g[9], g[8])
    d_ref, keep_ref = nw.pt_distance_plain(V, V, tris, q, t, act, off, bound)
    scale = 1.0 + V.abs().max()
    assert torch.all((d.cpu() - d_ref).abs() <= 64 * eps * scale)
    far = ((d_ref - off) - bound).abs() > 64 * eps * scale
    assert torch.equal(keep.cpu()[far], keep_ref[far])
    d, keep = nw.ee_distance(g[0], g[2], g[5], g[6], None, g[7], g[8])
    d_ref, keep_ref = nw.ee_distance_plain(V, edges, a, b, None, act, bound)
    # the line-line formula's cancellation grows as the edges approach the
    # parallel cutoff: sqrt(eps)-level agreement within a factor of it
    near = nw.ee_near_cutoff(V, edges, a, b)
    tol = torch.where(near, 8 * eps ** 0.5 * scale, 64 * eps * scale)
    assert torch.all((d.cpu() - d_ref).abs() <= tol)
    far = ~near & ((d_ref - bound).abs() > 64 * eps * scale)
    assert torch.equal(keep.cpu()[far], keep_ref[far])
    assert int(far.sum()) > 0.9 * q.shape[0]
    assert int(build.launches["pt_ee_distance[pt]"]) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_triangle_any_matches_twin(dev, dtype):
    """Kernel H: the same verdict on hitting and missing lists, inactive
    rows ignored, the overflow flag ORed in. Rows whose edge shares a vertex
    with the triangle touch it on the inclusive boundary, where the verdict
    is decided by rounding: the kernel rounds as the twin does, so each of
    them, checked alone, gets the twin's verdict too."""
    rng = np.random.default_rng(5)
    V, tris, edges, _q, t, a, _b, act = _contact_geometry(rng, dtype)
    share = (edges[a.long()][:, :, None] == tris[t.long()][:, None, :]).any(-1).any(-1)
    hits = nph.segment_triangle_intersects(
        *(V[edges[a.long()][:, i].long()] for i in range(2)),
        *(V[tris[t.long()][:, k].long()] for k in range(3)))
    assert bool(hits.any()) and bool((share & ~hits).any())
    no = torch.zeros((), dtype=torch.bool)
    yes = torch.ones((), dtype=torch.bool)
    g = [x.to(dev) for x in (V, edges, tris, a, t)]
    for act_case in (act, act & ~hits, torch.zeros_like(act)):
        for ovf in (no, yes):
            ref = st.segment_triangle_any_plain(V, edges, tris, a, t, act_case, ovf)
            out = st.segment_triangle_any(*g, act_case.to(dev), ovf.to(dev))
            assert bool(out) == bool(ref)
    for r in torch.nonzero(share).reshape(-1).tolist():
        one = torch.zeros_like(act)
        one[r] = True
        out = st.segment_triangle_any(*g, one.to(dev), no.to(dev))
        assert bool(out) == bool(hits[r]), r


def _nudge(x, k):
    """x moved by k ulps (down for k < 0)."""
    to = torch.full_like(x, float("inf") if k > 0 else float("-inf"))
    for _ in range(abs(k)):
        x = torch.nextafter(x, to)
    return x


def _pair_grid(dtype, kind):
    """A PT or EE pair grid where each query row's nearest allowed pair sits
    at d = dhat, and 1 and 3 ulps on either side of it, through the query's
    own thickness (every primitive is its own mesh; the targets' thickness
    is 0); some mesh pairs have mu = 0. Returns (V, table, allowed, meshes,
    mu, th, rows, j, steps, nt)."""
    rng = np.random.default_rng(8)
    V = torch.as_tensor(0.05 * rng.normal(size=(300, 3)), dtype=dtype)
    if kind == "pt":
        nq, nt = 300, 250
        table = torch.as_tensor(rng.integers(0, 300, size=(nt, 3)), dtype=torch.int32)
        mesh_q = torch.arange(nq, dtype=torch.int32)
        mesh_t = torch.arange(nq, nq + nt, dtype=torch.int32)
        M = nq + nt
    else:
        nq = nt = 280
        table = torch.as_tensor(rng.integers(0, 300, size=(nt, 2)), dtype=torch.int32)
        table[:, 1] = torch.where(table[:, 1] == table[:, 0], (table[:, 0] + 1) % 300,
                                  table[:, 1])
        mesh_q = mesh_t = torch.arange(nq, dtype=torch.int32)
        M = nq
    allowed = torch.as_tensor(rng.random((nq, nt)) < 0.8)
    if kind == "ee":   # queries are the first 140 edges, targets the rest
        allowed[140:] = False
        allowed[:, :140] = False
    mu = torch.ones((M, M), dtype=dtype)
    mu[5] = mu[:, 5] = 0.0
    mu[9, M - 1] = mu[M - 1, 9] = 0.0
    tq = table.long()
    if kind == "pt":
        d_all = nph.point_triangle_distance(V[:, None], V[tq[:, 0]][None], V[tq[:, 1]][None],
                                            V[tq[:, 2]][None])
    else:
        d_all = nph.edge_edge_distance(V[tq[:, 0]][:, None], V[tq[:, 1]][:, None],
                                       V[tq[:, 0]][None], V[tq[:, 1]][None])
    rows = torch.nonzero(allowed.any(1)).reshape(-1)
    j = torch.argmin(torch.where(allowed, d_all, torch.inf), dim=1)[rows]
    th = torch.zeros(M, dtype=dtype)
    steps = torch.as_tensor(rng.choice([-3, -1, 0, 1, 3], size=rows.numel()))
    d_near = d_all[rows, j]
    for k in (-3, -1, 0, 1, 3):
        sel = steps == k
        th[mesh_q[rows[sel]].long()] = _nudge(d_near[sel], k)
    meshes = (mesh_q, mesh_t) if kind == "pt" else (mesh_q,)
    return V, table, allowed.to(torch.uint8), meshes, mu, th, rows, j, steps, nt


def _check_pair_lists(dev, name, kernel, plain, args, V, rows, j, steps, nt, cap, mu_of):
    """A pair-list kernel against its twin on the CPU: one launch counted,
    the same kept pairs in the same order, the exact count past the
    capacity, distances within 64 eps; with room for all, each boundary
    pair kept exactly when it lies at or below dhat (and mu_of allows it)."""
    dtype = V.dtype
    ref = plain(*args)
    before = build.launches[name]
    out = kernel(*(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args))
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1
    n = int(ref[4])
    assert int(out[4]) == n > 100
    assert torch.equal(out[0].cpu(), ref[0]) and torch.equal(out[1].cpu(), ref[1])
    assert torch.equal(out[3].cpu(), ref[3])
    eps = torch.finfo(dtype).eps
    assert torch.all((out[2].cpu() - ref[2]).abs() <= 64 * eps * (1 + V.abs().max()))
    if cap > n:
        kept = set((ref[0].long() * nt + ref[1].long())[:n].tolist())
        for r, jj, k in zip(rows.tolist(), j.tolist(), steps.tolist()):
            if mu_of(r, jj):
                assert (r * nt + jj in kept) == (k >= 0), (r, k)
    return n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("cap", [40, 100000])
def test_friction_pairs_matches_twin(dev, dtype, kind, cap):
    """Kernel I: the same kept pairs in the same row-major order as the
    twin on the CPU, and the exact count past the capacity, on pairs placed
    at d = dhat and 1 and 3 ulps either side; some mesh pairs have mu = 0."""
    V, table, allowed, meshes, mu, th, rows, j, steps, nt = _pair_grid(dtype, kind)
    args = (V, table, allowed, *meshes, mu, th, cap)
    plain = fp.friction_pairs_pt_plain if kind == "pt" else fp.friction_pairs_ee_plain
    kernel = fp.friction_pairs_pt if kind == "pt" else fp.friction_pairs_ee
    _check_pair_lists(dev, f"friction_pairs[{kind}]", kernel, plain, args, V, rows, j,
                      steps, nt, cap,
                      lambda r, jj: bool(mu[meshes[0][r], meshes[-1][jj]] != 0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("cap", [40, 100000])
def test_contact_pairs_matches_twin(dev, dtype, kind, cap):
    """Kernel I's contact mode (the staged contact refresh, K16): every
    allowed pair at d <= dhat whatever the mu table, the same list as the
    twin's, and more pairs than the friction mode keeps on the same grid."""
    V, table, allowed, meshes, mu, th, rows, j, steps, nt = _pair_grid(dtype, kind)
    args = (V, table, allowed, *meshes, th, cap)
    plain = fp.contact_pairs_pt_plain if kind == "pt" else fp.contact_pairs_ee_plain
    kernel = fp.contact_pairs_pt if kind == "pt" else fp.contact_pairs_ee
    n = _check_pair_lists(dev, f"contact_pairs[{kind}]", kernel, plain, args, V, rows, j,
                          steps, nt, cap, lambda r, jj: True)
    fplain = fp.friction_pairs_pt_plain if kind == "pt" else fp.friction_pairs_ee_plain
    assert n > int(fplain(V, table, allowed, *meshes, mu, th, cap)[4])


@pytest.mark.parametrize("mode", ["contact", "friction"])
@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pair_lists_at_the_cull_margin(dev, dtype, kind, mode):
    """Kernel I on grids whose pairs sit at and just past its box cull's
    margin (tools/pair_grids.py: long edges far from the origin with points
    and edges millimetres beside them, slivers, collapsed and parallel
    primitives, dhat set within the margin of the partner's f64 distance):
    the card's lists equal bit for bit the g++ host build's of the same
    source, with its cull and without it (the cull drops no pair the exact
    test keeps), and the twin's (f64: q, t, dhat and the count exactly, d to
    an ulp of torch's CPU sqrt; f32: but for rounding-decided pairs); the
    cull leaves most allowed pairs out of the exact distance."""
    V, table, allowed, meshes, mu, th, scale = pair_grids.grid(kind, dtype, 0)
    mu_arg = mu if mode == "friction" else None
    cap = 10 ** 6
    host, n_exact = fp.host_lists(mode, kind, V, table, allowed, meshes, mu_arg, th, cap)
    every, n_every = fp.host_lists(mode, kind, V, table, allowed, meshes, mu_arg, th, cap,
                                   cull=False)
    name = f"{mode}_pairs[{kind}]"
    before = build.launches[name]
    out = fp.launch(mode, kind, V.to(dev), table.to(dev), allowed.to(dev),
                    tuple(m.to(dev) for m in meshes),
                    None if mu_arg is None else mu_arg.to(dev), th.to(dev), cap)
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1
    for a, b, c, what in zip(out, host, every, ("q", "t", "d", "dhat", "count")):
        assert torch.equal(a.cpu(), b), what
        assert torch.equal(b, c), what
    assert 0 < n_exact < n_every // 4
    plain = {("friction", "pt"): fp.friction_pairs_pt_plain,
             ("friction", "ee"): fp.friction_pairs_ee_plain,
             ("contact", "pt"): fp.contact_pairs_pt_plain,
             ("contact", "ee"): fp.contact_pairs_ee_plain}[(mode, kind)]
    ref = plain(V, table, allowed, *meshes, *(() if mu_arg is None else (mu,)), th, cap)
    nt = allowed.shape[1]
    k_out, k_ref = pair_grids.keys(host, nt), pair_grids.keys(ref, nt)
    if dtype == torch.float64:
        assert k_out == k_ref and torch.equal(host[3], ref[3])
        d, r = host[2], ref[2]
        assert torch.all((d == r) | (torch.nextafter(r, d) == d))
    else:
        only = sorted(set(k_out) ^ set(k_ref))
        assert all(pair_grids.rounding_decided(kind, V, table, meshes, th, only, nt, scale))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_build_at_the_scale_points_size(dev, dtype):
    """Kernel K at the 64x64 scale point's size: T = 12,416 targets with 64
    slots each into a table of 65,536 (two radix passes), exactly the
    twin's offsets, ids and max_cells."""
    T = 12416
    tsz = bp.table_size_for(T)
    assert tsz == 65536
    qc, qr, tc, tr = _grid_spheres(np.random.default_rng(T), dtype, 2000, T, -1.0, 1.0)
    h, mq = bp.pick_cell_size(qr, tr), bp.max_query_radius(qr)
    ref = gb.grid_build_plain(tc, tr, mq, h, 64, tsz)
    out = gb.grid_build(tc.to(dev), tr.to(dev), mq.to(dev), h.to(dev), 64, tsz)
    torch.cuda.synchronize()
    for x, y, what in zip(out, ref, ("offsets", "tid_sorted", "max_cells")):
        assert torch.equal(x.cpu(), y), what
    assert int(ref[0][-1]) > 10 * T


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_run", [40, 5000, 70000])
def test_grid_build_long_runs(dev, dtype, n_run):
    """Kernel K where buckets hold runs of about n_run ids: past a warp
    (32), past a radix tile (GB_TILE of csrc/grid_build.cu, 4,096 list
    entries) and past what one block's shared memory could sort (~58,000
    ids), beside short runs of a spread background; exactly the twin's
    outputs."""
    rng = np.random.default_rng(n_run)
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    c = np.array([0.3, -0.2, 0.1])
    tc = f(np.concatenate([c + 1e-4 * rng.uniform(-1, 1, (n_run, 3)),
                           rng.uniform(-1, 1, (500, 3))]))
    tr = f(np.concatenate([np.full(n_run, 1e-3), rng.uniform(0.01, 0.05, 500)]))
    qr = f(rng.uniform(0.01, 0.02, 100))
    h, mq = bp.pick_cell_size(qr, tr), bp.max_query_radius(qr)
    tsz = bp.table_size_for(tc.shape[0])
    ref = gb.grid_build_plain(tc, tr, mq, h, 8, tsz)
    out = gb.grid_build(tc.to(dev), tr.to(dev), mq.to(dev), h.to(dev), 8, tsz)
    torch.cuda.synchronize()
    for x, y, what in zip(out, ref, ("offsets", "tid_sorted", "max_cells")):
        assert torch.equal(x.cpu(), y), what
    assert int((ref[0][1:] - ref[0][:-1]).max()) >= 0.9 * n_run


def _pt_row_geometry(rng, n):
    """Point-triangle rows in every region, on a vertex (a zero point-point
    direction) and straight above one (the n_z >= 0.99 axis)."""
    t0 = rng.normal(size=(n, 3))
    t1 = t0 + rng.normal(size=(n, 3))
    t2 = t0 + rng.normal(size=(n, 3))
    p = 2.0 * rng.normal(size=(n, 3))
    k = n // 8
    w = rng.dirichlet([1.0, 1.0, 1.0], size=k)
    p[:k] = np.einsum("ki,kij->kj", w, np.stack([t0[:k], t1[:k], t2[:k]], 1)) \
        + 0.1 * rng.normal(size=(k, 3))
    p[k:2 * k] = t1[k:2 * k] + 0.02 * rng.normal(size=(k, 3))
    p[2 * k] = t0[2 * k]
    p[2 * k + 1] = t2[2 * k + 1] + np.array([0.0, 0.0, 0.5])
    return np.concatenate([p, t0, t1, t2])


def _ee_row_geometry(rng, n):
    """Edge pairs in every region, exactly parallel pairs, and crossing
    pairs at sin^2 of the angle ~ 1e-5 (the line-line region, with the
    degenerate parameter branch in float32 when the classifier's cutoff is
    below the dtype's default 1e-4)."""
    a0 = rng.normal(size=(n, 3))
    a1 = a0 + rng.normal(size=(n, 3))
    b0 = rng.normal(size=(n, 3))
    b1 = b0 + rng.normal(size=(n, 3))
    k = n // 8
    axis = np.eye(3)[rng.integers(0, 3, k)]
    a0[:k] = rng.integers(-4, 4, (k, 3))
    a1[:k] = a0[:k] + rng.integers(1, 4, (k, 1)) * axis
    b0[:k] = a0[:k] + rng.integers(-2, 3, (k, 3))
    b1[:k] = b0[:k] + (rng.integers(-3, 4, (k, 1)) + 0.5) * axis
    dl = np.sqrt(1e-5)
    R = np.linalg.qr(rng.normal(size=(k, 3, 3)))[0]
    h = rng.uniform(0.01, 0.1, (k, 1))
    loc = np.stack([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    a0[k:2 * k], a1[k:2 * k] = [np.einsum("kij,j->ki", R, x) for x in loc]
    b0[k:2 * k] = np.einsum("kij,kj->ki", R, np.concatenate(
        [-np.ones((k, 1)), np.full((k, 1), dl), h], 1))
    b1[k:2 * k] = np.einsum("kij,kj->ki", R, np.concatenate(
        [np.ones((k, 1)), np.full((k, 1), -dl), h], 1))
    return np.concatenate([a0, a1, b0, b1]), k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("barrier", ["Cubic", "Log"])
def test_friction_rows_matches_twin(dev, dtype, barrier):
    """Kernel J against its twin on the CPU: the same region on every row
    (all 7 PT and 9 EE regions hit), anchors and tangent bases within 64 eps
    of the coordinate scale (8 sqrt(eps) on the near-parallel crossing rows,
    whose basis is ill-conditioned), mu exactly, fn within 64 eps of its
    scale, and rows past the count zero with region -1. In float32 the
    crossing rows run with a parallel cutoff below the dtype's default and
    take the degenerate line-parameter branch (in float64 the classifier's
    parallel test and that branch's test coincide to rounding)."""
    rng = np.random.default_rng(9)
    n = 512
    eps = torch.finfo(dtype).eps
    k_t = torch.tensor(1e5, dtype=dtype)
    mu = torch.as_tensor(rng.uniform(0.0, 1.0, (4, 4)), dtype=dtype)
    mu = 0.5 * (mu + mu.T)
    dhat = torch.as_tensor(rng.uniform(1e-3, 1e-2, n), dtype=dtype)
    d = dhat * torch.as_tensor(rng.uniform(0.0, 1.2, n), dtype=dtype)
    count = torch.tensor(n - 7, dtype=torch.int32)
    i = torch.arange(n, dtype=torch.int32)
    # PT
    V = torch.as_tensor(_pt_row_geometry(rng, n), dtype=dtype)
    tris = torch.stack([n + i, 2 * n + i, 3 * n + i], 1)
    p_mesh = torch.as_tensor(rng.integers(0, 4, 4 * n), dtype=torch.int32)
    t_mesh = torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32)
    args = (V, tris, i, i, count, d, dhat, p_mesh, t_mesh, mu, k_t, barrier)
    ref = fr.friction_rows_pt_plain(*args)
    out = [x.cpu() for x in fr.friction_rows_pt(*(
        x.to(dev) if isinstance(x, torch.Tensor) else x for x in args))]
    scale = 1.0 + float(V.abs().max())
    assert torch.equal(out[0], ref[0]) and len(torch.unique(ref[0][:n - 7])) == 7
    assert torch.all(ref[0][n - 7:] == -1)
    for x, y in zip(out[1:3], ref[1:3]):
        assert torch.all((x - y).abs() <= 64 * eps * scale)
    assert torch.equal(out[3], ref[3])
    assert torch.all((out[4] - ref[4]).abs() <= 64 * eps * ref[4].abs().max())
    assert float(ref[4].abs().max()) > 0.0
    # EE
    Vg, k = _ee_row_geometry(rng, n)
    V = torch.as_tensor(Vg, dtype=dtype)
    edges = torch.cat([torch.stack([i, n + i], 1), torch.stack([2 * n + i, 3 * n + i], 1)])
    e_mesh = torch.as_tensor(rng.integers(0, 4, 2 * n), dtype=torch.int32)
    ptol = 1e-6 if dtype == torch.float32 else None
    args = (V, edges, i, n + i, count, d, dhat, e_mesh, mu, k_t, barrier, ptol)
    ref = fr.friction_rows_ee_plain(*args)
    out = [x.cpu() for x in fr.friction_rows_ee(*(
        x.to(dev) if isinstance(x, torch.Tensor) else x for x in args))]
    scale = 1.0 + float(V.abs().max())
    assert torch.equal(out[0], ref[0]) and len(torch.unique(ref[0][:n - 7])) == 9
    tol = torch.full((n,), 64 * eps * scale, dtype=torch.float64)
    tol[k:2 * k] = 8 * eps ** 0.5 * scale
    for x, y in zip(out[1:3], ref[1:3]):
        err = (x - y).abs().double().reshape(n, -1).amax(1)
        assert torch.all(err <= tol)
    assert torch.equal(out[3], ref[3])
    assert torch.all((out[4] - ref[4]).abs() <= 64 * eps * ref[4].abs().max())
    if dtype == torch.float32:
        degen = (ref[0][k:2 * k] == 8) & (ref[1][k:2 * k] == 0.5).all(1)
        assert int(degen.sum()) > 0


def test_cloth_on_card_tracks_the_cpu_port(dev):
    """Three f64 steps of a 6x6 hanging cloth on the card (every kernel)
    against the same port on the CPU (twins, exact eigh)."""
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    def run(device):
        s = Settings()
        s.output.enable_output = False
        s.output.enable_frame_writes = False
        s.simulation.init_frictional_contact = False
        s.device.device = device
        sim = Simulation(s)
        h = sim.presets.deformables.add_surface_grid(
            "", (0.3, 0.3), (6, 6), SurfaceParams.Cotton_Fabric())
        sim.deformables.prescribed_positions.add(h.point_set, [0, 6],
                                                 PrescribedPositionsParams())
        for _ in range(3):
            assert sim.run_one_time_step()
        return h.point_set.get_positions(), sim.get_logger().series["solver_code"]

    build.reset_launches()
    x_gpu, codes_gpu = run("cuda")
    for k in ("segment_reduce[egh]", "segment_reduce[diag]", "segment_reduce[dense]",
              "hvp_bucket", "pd_project", "block3_inverse", "block3_apply"):
        assert build.launches[k] > 0, k
    x_cpu, codes_cpu = run("cpu")
    assert codes_gpu == codes_cpu
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-8


def test_spinning_box_on_card_tracks_the_cpu_port(dev):
    """Four f64 steps of a 6x6 spinning box through first contact on the
    card (kernels A-H) against the same port on the CPU (twins, exact
    eigh): the same solver codes and Newton counts, and close positions."""
    import math

    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.interactions.contact import ContactGlobalParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    def run(device):
        s = Settings()
        s.output.enable_output = False
        s.output.enable_frame_writes = False
        s.device.device = device
        sim = Simulation(s)
        gp = ContactGlobalParams()
        gp.default_contact_thickness = 0.002
        sim.interactions.contact.set_global_params(gp)
        h = sim.presets.deformables.add_surface_grid(
            "", (0.4, 0.4), (6, 6), SurfaceParams.Cotton_Fabric())
        box = sim.presets.rigidbodies.add_box("", 1.0, 0.08)
        box.rigidbody.add_translation([0.0, 0.0, -0.08])
        fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
        sim.add_time_event(0.0, 10.0, lambda t: fix.set_transformation(
            [0.0, 0.0, -0.08 - 0.1 * math.sin(t)], angle_deg=90.0 * t,
            axis=[0.0, 0.0, 1.0]))
        for _ in range(4):
            assert sim.run_one_time_step()
        lg = sim.get_logger()
        return (h.point_set.get_positions(), lg.series["solver_code"],
                lg.series["newton_iterations"], sim.stark.newton.live_contact_pairs())

    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu, live_gpu = run("cuda")
    for k in ("ball_wide", "pt_ee_distance[pt]", "pt_ee_distance[ee]",
              "segment_triangle_any", "compact[refine_pt]", "compact[live]",
              "hvp_bucket", "pd_project"):
        assert build.launches[k] > 0, k
    x_cpu, codes_cpu, newton_cpu, live_cpu = run("cpu")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert live_cpu > 0
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-6


def test_friction_box_on_card_tracks_the_cpu_port(dev):
    """Five f64 steps of the 6x6 spinning box with friction mu = 1 (cloth and
    box, cloth and itself) on the card (kernels A-J) against the same port
    on the CPU: the same solver codes, Newton counts and friction counts,
    and close positions."""
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    def run(device):
        sim, cloth, spin = spinning_box_cloth(6, "float64", device, mu=1.0)
        sim.add_time_event(0.0, 10.0, spin)
        fric = []
        for _ in range(5):
            assert sim.run_one_time_step()
            fric.append({k: v for k, v in sim.stark.newton._last_counts.items()
                         if k.startswith("f_")})
        lg = sim.get_logger()
        return (cloth.point_set.get_positions(), lg.series["solver_code"],
                lg.series["newton_iterations"], fric)

    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu, fric_gpu = run("cuda")
    for k in ("friction_pairs[pt]", "friction_pairs[ee]", "friction_rows[pt]",
              "compact[route_f_pt_dd]"):
        assert build.launches[k] > 0, k
    x_cpu, codes_cpu, newton_cpu, fric_cpu = run("cpu")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert fric_gpu == fric_cpu and fric_cpu[-1]["f_pt"] > 0
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-6


def _soft_boxes(device, sweeps: int, steps: int = 4):
    """deformable_and_rigid_collisions at n1 = 2, n2 = 1, mu = 1, f64, for
    `steps` steps with kernel C's Jacobi (or its twin) at `sweeps`:
    (positions of both boxes, solver codes, Newton counts, friction counts
    per step)."""
    from stark_tpu_torch.tools.scenes import deformable_and_rigid_collisions

    sim, (h1, h2, _floor) = deformable_and_rigid_collisions("float64", device, 2, 1)
    sim.stark.settings.device.jacobi_sweeps = sweeps
    fric = []
    for _ in range(steps):
        assert sim.run_one_time_step()
        fric.append({k: v for k, v in sim.stark.newton._last_counts.items()
                     if k.startswith("f_")})
    lg = sim.get_logger()
    x = np.concatenate([h1.point_set.get_positions(), h2.point_set.get_positions()])
    return x, lg.series["solver_code"], lg.series["newton_iterations"], fric


def test_soft_boxes_on_card_track_the_cpu_port(dev):
    """Four f64 steps of deformable_and_rigid_collisions at n1 = 2, n2 = 1,
    mu = 1 (kernels S, Q, N, O, P and A-J) on the card against the same
    port on the CPU: the same solver codes, Newton counts and friction
    counts, and close positions; no family ran torch.func on the card.
    Both run kernel C's Jacobi (and its twin) with 16 sweeps: the 8 of the
    card's default (JAX's accelerator default) leave the tets' 12x12
    projections of this scene unconverged, 42 Newton iterations at step 0
    against 9 (ROADMAP Queue 3; the next test runs them), and the CPU's
    default is the exact eigh."""
    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu, fric_gpu = _soft_boxes("cuda", 16)
    for k in ("egh_tet[tet]", "egh_friction[friction_pt_dr]", "egh_friction[friction_ee_dr]"):
        assert build.launches[k] > 0, k
    assert not build.func_on_card, dict(build.func_on_card)
    x_cpu, codes_cpu, newton_cpu, fric_cpu = _soft_boxes("cpu", 16)
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert fric_gpu == fric_cpu and fric_cpu[-1]["f_pt"] > 0
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-8


def test_soft_boxes_on_card_at_8_sweeps_track_the_cpu_port(dev):
    """The previous test's soft boxes at the card's default of 8 Jacobi
    sweeps, the setting phases 18 and 19 run, on both sides: the same
    solver codes, Newton counts (printed per step) and friction counts, and
    positions within 1e-6 m, the scene-parity bound of PERF.md section 2.
    The 16-sweep test holds 1e-8 m; 8 sweeps leave the tets' projections
    unconverged, so each Newton step carries its inputs' rounding, and the
    card's and the CPU twin's converged states part by more (4.2e-8 m on an
    H100; ROADMAP Queue 3 item 4)."""
    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu, fric_gpu = _soft_boxes("cuda", 8)
    assert build.launches["pd_project"] > 0 and not build.func_on_card
    x_cpu, codes_cpu, newton_cpu, fric_cpu = _soft_boxes("cpu", 8)
    dev_m = float(np.max(np.abs(x_gpu - x_cpu)))
    print(f"8 sweeps: Newton per step card {newton_gpu}, CPU {newton_cpu}; "
          f"positions within {dev_m:.3e} m")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu and fric_gpu == fric_cpu
    assert dev_m < 1e-6


def _first_iteration_projections(sweeps: int):
    """[(H, eps, mirroring, elem_mask)] that the first Newton iteration of
    the soft boxes' first step (the scene of _soft_boxes) hands the PD
    projection on the CPU at `sweeps` sweeps, for every family wider than
    3, in call order."""
    from stark_tpu_torch.solver import project
    from stark_tpu_torch.tools.scenes import deformable_and_rigid_collisions

    sim, _h = deformable_and_rigid_collisions("float64", "cpu", 2, 1)
    sim.stark.settings.device.jacobi_sweeps = sweeps
    calls, seen = [], []
    inner, inner_all = project.project_family_to_pd, project.project_all

    def all_(*a, **k):
        seen.append(1)
        return inner_all(*a, **k)

    def fam(H, eps, mirroring, elem_mask=None, jacobi_sweeps=0, unconverged=None):
        if len(seen) == 1 and jacobi_sweeps == sweeps and H.shape[-1] > 3:
            calls.append((H.clone(), eps, mirroring,
                          None if elem_mask is None else elem_mask.clone()))
        return inner(H, eps, mirroring, elem_mask, jacobi_sweeps, unconverged)

    project.project_family_to_pd, project.project_all = fam, all_
    try:
        assert sim.run_one_time_step()
    finally:
        project.project_family_to_pd, project.project_all = inner, inner_all
    return calls


def test_pd_project_on_the_soft_boxes_first_iteration(dev):
    """Kernel C at 8 sweeps on the exact inputs of the soft boxes' first
    Newton iteration (the tets' 12x12, the rigid bodies' 6x6 and the contact
    pool's 15x15, f64) against its twin on the CPU, by the rule of
    test_pd_project_wide_matches_twin (max|H_e| at least the projection's
    eps, which a zero H_e becomes): the same changed flags, unchanged
    matrices passed through, a converged matrix within 2000 eps max|H_e|
    of the twin, an unconverged one no farther from the exact projection
    than twice the twin. Prints, per width, the entries that differ from
    the CPU twin bit for bit, for the kernel and for the twin run on the
    card (CUDA's atan2, cos and sin). Built with STARK_TPU_TORCH_NO_FMA=
    pd_project.cu it measures kernel C without FMA contraction (ROADMAP
    Queue 3 item 2)."""
    calls = _first_iteration_projections(8)
    assert any(H.shape[-1] == 12 for H, _e, _m, _k in calls)
    before = build.launches["pd_project"]
    for H, eps, mirroring, mask in calls:
        m_dev = None if mask is None else mask.to(dev)
        out, ch = pd.pd_project(H.to(dev), eps, mirroring, m_dev, 8)
        twin_card = pd.pd_project_plain(H.to(dev), eps, mirroring, m_dev, 8)[0]
        ref, ch_ref = pd.pd_project_plain(H, eps, mirroring, mask, 8)
        torch.cuda.synchronize()
        out, ch, twin_card = out.cpu(), ch.cpu(), twin_card.cpu()
        eps64 = torch.finfo(H.dtype).eps
        scale = H.abs().amax(dim=(1, 2)).clamp_min(eps)     # a zero H_e becomes eps I
        print(f"d={H.shape[-1]} x {H.shape[0]} ({build.NO_FMA_SOURCES}): entries differing "
              f"from the CPU twin, kernel {int((out != ref).sum())}, twin on the card "
              f"{int((twin_card != ref).sum())} of {H.numel()}; matrices "
              f"{int((out != ref).any(dim=(1, 2)).sum())}; largest |kernel - twin| / "
              f"max|H_e| {float(((out - ref).abs().amax(dim=(1, 2)) / scale).max()):.4g}")
        assert torch.equal(ch, ch_ref)
        assert torch.equal(out[~ch], H[~ch])
        exact = pd.pd_project_plain(H, eps, mirroring, mask, 0)[0]
        spread = (ref - exact).abs().amax(dim=(1, 2))
        dist = (out - exact).abs().amax(dim=(1, 2))
        err = (out - ref).abs().amax(dim=(1, 2))
        conv = ch & (spread <= 100.0 * eps64 * scale)
        assert torch.all(err[conv] <= 2000.0 * eps64 * scale[conv])
        un = ch & ~conv
        if un.any():
            assert float((dist / scale)[un].max()) <= 2.0 * float((spread / scale)[un].max())
    assert build.launches["pd_project"] == before + len(calls)


def test_hanging_rod_and_net_on_card_track_the_cpu_port(dev):
    """Kernels R (and P, A-D): tests/test_newton_cloth.py's hanging rod for
    0.2 s and a 6x6 hanging_net for 3 steps, f64, on the card against the
    port on the CPU: the same codes and Newton counts, positions within
    1e-8 m."""
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import LineParams
    from stark_tpu_torch.tools.scenes import hanging_net

    def rod(device):
        s = Settings()
        s.output.enable_output = False
        s.simulation.init_frictional_contact = False
        s.simulation.max_time_step_size = 1 / 60
        s.device.device = device
        sim = Simulation(s)
        h = sim.presets.deformables.add_line_as_segments(
            "", (0, 0, 0), (0, 0, -0.3), 10, LineParams.Elastic_Rubberband())
        sim.deformables.prescribed_positions.add(h.point_set, [0],
                                                 PrescribedPositionsParams())
        return sim, h, 12

    def net(device):
        sim, h = hanging_net("float64", device, n=6)
        return sim, h, 3

    for make in (rod, net):
        out = []
        for device in ("cuda", "cpu"):
            build.reset_launches()
            sim, h, steps = make(device)
            for _ in range(steps):
                assert sim.run_one_time_step()
            if device == "cuda":
                assert build.launches["egh_rod[segment]"] > 0
                assert not build.func_on_card
            lg = sim.get_logger()
            out.append((h.point_set.get_positions(), lg.series["solver_code"],
                        lg.series["newton_iterations"]))
        (xg, cg, ng), (xc, cc, nc) = out
        assert cg == cc and ng == nc
        assert np.max(np.abs(xg - xc)) < 1e-8


def test_rigid_joint_chain_on_card_tracks_the_cpu_port(dev):
    """Kernels T and U (and P, A-D): tools/scenes.rigid_joint_chain (every
    joint family on three bodies) for 8 f64 steps of 10 ms on the card
    against the same port on the CPU: the same solver codes and Newton
    counts, the bodies' translations and quaternions within 1e-8."""
    from stark_tpu_torch.tools.scenes import rigid_joint_chain

    def run(device):
        sim, bodies = rigid_joint_chain("float64", device)
        out = []
        for _ in range(8):
            assert sim.run_one_time_step()
            out.append(np.concatenate([np.concatenate([b.get_translation(),
                                                       b.get_quaternion()])
                                       for b in bodies]))
        lg = sim.get_logger()
        return np.asarray(out), lg.series["solver_code"], lg.series["newton_iterations"]

    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu = run("cuda")
    for f in ("points", "point_on_axis", "distances", "distance_limits", "damped_spring",
              "directions", "angle_limits", "linear_velocity", "angular_velocity"):
        assert build.launches[f"egh_joints[{f}]"] > 0, f
    assert not build.func_on_card, dict(build.func_on_card)
    x_cpu, codes_cpu, newton_cpu = run("cpu")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-8


def test_compact_attachments_on_card_track_the_cpu_port(dev):
    """Kernel W (and M, P, A-D): stark_tpu_torch.examples' attachments at n
    = 6 (point-edge, point-triangle and rigid-point rows), 6 f64 steps of
    10 ms on the card against the same port on the CPU: the same solver
    codes and Newton counts, positions within 1e-8 m."""
    from stark_tpu_torch import Settings
    from stark_tpu_torch.examples import build_attachments

    def run(device):
        s = Settings()
        s.output.enable_output = False
        s.output.enable_frame_writes = False
        s.device.device = device
        s.simulation.max_time_step_size = 0.01
        sim, h = build_attachments(s, n=6)
        out = []
        for _ in range(6):
            assert sim.run_one_time_step()
            out.append(np.concatenate([h.a.point_set.get_positions(),
                                       h.b.point_set.get_positions(),
                                       h.box.rigidbody.get_translation()[None]]))
        lg = sim.get_logger()
        return np.asarray(out), lg.series["solver_code"], lg.series["newton_iterations"]

    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu = run("cuda")
    for f in ("att_pe", "att_pt", "att_rbd"):
        assert build.launches[f"egh_attachments[{f}]"] > 0, f
    assert not build.func_on_card, dict(build.func_on_card)
    x_cpu, codes_cpu, newton_cpu = run("cpu")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-8


def test_full_shell_cloth_on_card_at_8_sweeps_tracks_the_cpu_port(dev):
    """Kernel V: a 6x6 hanging cloth with full DiscreteShells
    (flat_rest_angle off: every interior edge starts flat, where acos is
    steepest), f64, 3 steps, kernel C's Jacobi (and its twin on the CPU) at
    the card's default 8 sweeps on both sides: the same solver codes and
    Newton counts, positions within 1e-6 m (PERF.md section 2's scene
    bound)."""
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    def run(device):
        s = Settings()
        s.output.enable_output = False
        s.output.enable_frame_writes = False
        s.simulation.init_frictional_contact = False
        s.device.device = device
        s.device.jacobi_sweeps = 8
        sim = Simulation(s)
        p = SurfaceParams.Cotton_Fabric()
        p.bending.flat_rest_angle = False
        h = sim.presets.deformables.add_surface_grid("", (0.3, 0.3), (6, 6), p)
        sim.deformables.prescribed_positions.add(h.point_set, [0, 6],
                                                 PrescribedPositionsParams())
        for _ in range(3):
            assert sim.run_one_time_step()
        lg = sim.get_logger()
        return (h.point_set.get_positions(), lg.series["solver_code"],
                lg.series["newton_iterations"])

    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu = run("cuda")
    assert build.launches["egh_shells[shells]"] > 0 and build.launches["pd_project"] > 0
    assert not build.func_on_card, dict(build.func_on_card)
    x_cpu, codes_cpu, newton_cpu = run("cpu")
    dev_m = float(np.max(np.abs(x_gpu - x_cpu)))
    print(f"full shells, 8 sweeps: Newton per step card {newton_gpu}, CPU {newton_cpu}; "
          f"positions within {dev_m:.3e} m")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert dev_m < 1e-6


def _staged_cloth(device, mode="ProjectedNewton", solver="BDPCG", n=6, squeeze=1.0):
    """A 6x6 hanging cloth, f64, on the staged solver's configuration;
    squeeze < 1 scales its x-coordinates after pinning, so the compressed
    triangles' strain Hessians are indefinite and the projection ladder
    escalates."""
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.core.settings import LinearSolver, ProjectionToPD
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    s = Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    s.device.device = device
    s.newton.projection_mode = getattr(ProjectionToPD, mode)
    s.newton.linear_solver = getattr(LinearSolver, solver)
    sim = Simulation(s)
    h = sim.presets.deformables.add_surface_grid(
        "", (0.3, 0.3), (n, n), SurfaceParams.Cotton_Fabric())
    sim.deformables.prescribed_positions.add(h.point_set, [0, n],
                                             PrescribedPositionsParams())
    b, m = h.point_set.get_begin(), h.point_set.size()
    sim._dyn._x0_host[b:b + m, 0] *= squeeze
    return sim, h


@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_hvp_and_direct_assembly_match_twins(dev, dtype):
    """Kernel B at its staged site (one launch over the arity groups) and
    kernel A's direct site (DirectLLT's dense Hessian) on a 6x6 cloth's
    element Hessians at a random state, against the twins on the CPU: B
    within the sum tolerance 64 eps * sum|terms|, A's direct site bit for
    bit (it sums each block pair in the twin's order)."""
    sim, _h = _staged_cloth("cpu", solver="DirectLLT")
    sim.stark._initialize()
    nm = sim.stark.newton
    ev = nm._ev

    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    data = {k: {"conn": v["conn"], "rows": {r: cast(x) for r, x in v["rows"].items()}}
            for k, v in sim._get_data().items()}
    glob = {k: cast(v) for k, v in sim._get_glob().items()}
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.normal(0.0, 0.1, (nm.n_blocks, 3)), dtype=dtype)
    p = torch.as_tensor(rng.normal(size=(nm.n_blocks, 3)), dtype=dtype)
    _E, _aux, _g, hess = ev.energy_grad_hess(u, data, glob, None, ev.egh_csr(data))
    absh = {k: v.abs() for k, v in hess.items()}

    def on(device):
        dd = {k: {"conn": v["conn"].to(device),
                  "rows": {r: x.to(device) for r, x in v["rows"].items()}}
              for k, v in data.items()}
        hh = {k: v.to(device) for k, v in hess.items()}
        groups = ev.staged_groups(dd)
        before = build.launches["hvp_bucket[staged]"]
        q = ev.hvp_ctx(p.to(device), ev.hvp_context(groups, hh))
        launched = build.launches["hvp_bucket[staged]"] - before
        before_d = build.launches["segment_reduce[direct]"]
        D = ev.assemble_dense_direct(dd, hh)
        launched_d = build.launches["segment_reduce[direct]"] - before_d
        return q.cpu(), D.cpu(), launched, launched_d, len(groups)

    q_g, D_g, launched, launched_d, n_groups = on(dev)
    q_c, D_c, _l, _ld, _n = on("cpu")
    groups = ev.staged_groups(data)
    aq = ev.hvp_ctx(p.abs(), ev.hvp_context(groups, absh))
    assert launched == 1 and n_groups >= 3 and launched_d == 1
    assert torch.all((q_g - q_c).abs() <= _tol(aq, dtype, 64.0))
    assert torch.equal(D_g, D_c)


@pytest.mark.parametrize("mode,solver", [("ProjectedNewton", "DirectLLT"),
                                         ("Progressive", "BDPCG"),
                                         ("ProjectOnDemand", "BDPCG")])
def test_staged_cloth_on_card_tracks_the_cpu_port(dev, mode, solver):
    """Three f64 steps of the 6x6 cloth through the staged solver on the card
    against the same port on the CPU: the same Newton counts, positions
    within 1e-8 m; kernel A's direct site (DirectLLT) or B at its staged
    site launched."""
    def run(device):
        sim, h = _staged_cloth(device, mode, solver)
        for _ in range(3):
            assert sim.run_one_time_step()
        return h.point_set.get_positions(), sim.get_logger().series["newton_iterations"]

    build.reset_launches()
    x_gpu, newton_gpu = run("cuda")
    site = "segment_reduce[direct]" if solver == "DirectLLT" else "hvp_bucket[staged]"
    assert build.launches[site] > 0
    x_cpu, newton_cpu = run("cpu")
    assert newton_gpu == newton_cpu
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-8


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_selective_matches_twin(dev, dtype):
    """The Progressive mode's projection (kernel C with an element mask from
    a block mask) on a squeezed 6x6 cloth's element Hessians, whose strain
    blocks are indefinite, against the twin with the same 8 Jacobi sweeps on
    the CPU: rebuilt matrices within 2000 eps of each matrix's largest
    entry, unselected elements untouched. The families PSD by construction
    pass through, as in the solver's call: on their flat-bending blocks (a
    triple eigenvalue over nine near-zero ones) the 8-sweep projection
    moves with the rounding of its input, the twin's and JAX's alike
    (tests/test_torch_staged.py::test_jacobi_sweeps_on_clustered_spectra),
    so the kernel's and the twin's end far apart there."""
    from stark_tpu_torch.solver import project

    sim, _h = _staged_cloth("cpu", "Progressive", squeeze=0.3)
    sim.stark._initialize()
    ev = sim.stark.newton._ev
    psd = sim.stark.newton._psd_names
    data, glob = sim._get_data(), sim._get_glob()
    u = torch.zeros((ev.n_blocks, 3), dtype=torch.float64)
    _E, _aux, grad, hess = ev.energy_grad_hess(u, data, glob, None, ev.egh_csr(data))
    hess = {k: v.to(dtype) for k, v in hess.items()}
    gmax = torch.max(torch.abs(grad), dim=1).values
    block_mask = gmax >= torch.quantile(gmax, 0.5)

    def on(device):
        dd = {k: {"conn": v["conn"].to(device),
                  "rows": {r: x.to(device) for r, x in v["rows"].items()}}
              for k, v in data.items()}
        out, n = project.project_selective({k: v.to(device) for k, v in hess.items()},
                                           dd, 1e-10, False, block_mask.to(device),
                                           jacobi_sweeps=8, psd_names=psd)
        return {k: v.cpu() for k, v in out.items()}, int(n)

    before = build.launches["pd_project"]
    out_g, n_g = on(dev)
    assert build.launches["pd_project"] > before
    out_c, n_c = on("cpu")
    assert n_g > 0 and n_c > 0
    assert "EnergyTriangleStrain" not in psd
    for name, H in hess.items():
        conn = data[name]["conn"]
        sel = torch.any(block_mask[conn], dim=1) & (data[name]["rows"]["active"] > 0.5) \
            & (name not in psd)
        assert torch.equal(out_g[name][~sel], H[~sel]), name
        scale = H.abs().amax(dim=(1, 2), keepdim=True)
        tol = 2000.0 * torch.finfo(dtype).eps * scale + torch.finfo(dtype).tiny
        assert torch.all((out_g[name] - out_c[name]).abs() <= tol), name


def test_staged_friction_box_on_card_tracks_the_cpu_port(dev, monkeypatch):
    """Five f64 steps of the 6x6 spinning box with friction mu = 1 through
    the staged solver on the card (K16: kernel I's contact mode before every
    energy evaluation; I and J once per step) against the same port on the
    CPU: the same codes, Newton counts and live pairs, close positions."""
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    monkeypatch.setenv("STARK_TPU_TORCH_NO_FUSED", "1")

    def run(device):
        sim, cloth, spin = spinning_box_cloth(6, "float64", device, mu=1.0)
        sim.add_time_event(0.0, 10.0, spin)
        live = []
        for _ in range(5):
            assert sim.run_one_time_step()
            live.append((sim.stark.newton.live_contact_pairs(),
                         sim.stark.newton.friction_rows()))
        lg = sim.get_logger()
        return (cloth.point_set.get_positions(), lg.series["solver_code"],
                lg.series["newton_iterations"], live)

    build.reset_launches()
    x_gpu, codes_gpu, newton_gpu, live_gpu = run("cuda")
    for k in ("contact_pairs[pt]", "contact_pairs[ee]", "friction_pairs[pt]",
              "friction_rows[pt]", "hvp_bucket[staged]", "segment_triangle_any"):
        assert build.launches[k] > 0, k
    x_cpu, codes_cpu, newton_cpu, live_cpu = run("cpu")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert live_gpu == live_cpu and live_cpu[-1][0] > 0
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-6


# ---------------------------------------------------------------------------
# kernels M-V: element energies, gradients and Hessians (K11)
# ---------------------------------------------------------------------------
# the barrier (Cubic, Log) of the contact families, the friction type (C0,
# C1) of kernel Q's
EGH_CASES = [(n, "Cubic") for n in ec.KERNEL_FAMILIES if not n.startswith("friction_")] + \
    [(n, "Log") for n in ec.KERNEL_FAMILIES if n.startswith("contact_")] + \
    [(n, m) for m in ("C0", "C1") for n in ec.KERNEL_FAMILIES if n.startswith("friction_")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,barrier", EGH_CASES)
def test_egh_kernels_match_twin(dev, dtype, name, barrier):
    """Each family's kernel on the card against its torch.func twin on the
    CPU: f64 within 1e-10 of each element's largest entry; f32 within 64
    eps of it (where the f32 twin, or rounding the positions to float32,
    moves farther from the f64 twin: or within twice that distance, element
    by element, tools/egh_cases.f32_ratio); the value-only e bit for bit the derivative form's;
    H symmetric, inactive rows zero; one launch counted per call."""
    case = ec.make_case(name, sum(map(ord, name + barrier)))
    fam = ec.port_families(*(("Cubic", barrier) if barrier in ("C0", "C1")
                             else (barrier,)))[name]
    glob64, u64, conn64, rows64 = ec.to_torch(*case)
    ref = egh.plain(fam.energy_fn, u64, conn64, rows64, glob64)
    spread = ec.f64_spread(fam.energy_fn, u64, conn64, rows64, glob64)
    glob, u, conn, rows = ec.to_torch(*case, dtype=dtype, device=dev)
    before = dict(build.launches)
    out = fam.kernel(u, conn, rows, glob, True)
    e_v = fam.kernel(u, conn, rows, glob, False)
    torch.cuda.synchronize()
    new = {k: v - before.get(k, 0) for k, v in build.launches.items()
           if v != before.get(k, 0)}
    assert len(new) == 2 and all(v == 1 for v in new.values()), new
    assert torch.equal(out[0], e_v)
    H = out[2]
    assert torch.equal(H, H.transpose(1, 2))
    inactive = rows["active"] <= 0.5
    assert bool(torch.all(H[inactive] == 0)) and bool(torch.all(out[0][inactive] == 0))
    if dtype == torch.float64:
        for part, o, r in zip("egH", out, ref):
            assert ec.f64_err(o.cpu().numpy(), r.numpy(), part) <= 1e-10
    else:
        glob32, u32, conn32, rows32 = ec.to_torch(*case, dtype=torch.float32)
        twin32 = egh.plain(fam.energy_fn, u32, conn32, rows32, glob32)
        for part, o, t, r, s in zip("egH", out, twin32, ref, spread):
            assert ec.f32_ratio(o.cpu(), t, r, part, s)[0] <= 1.0


# ---------------------------------------------------------------------------
# K12: kernel X (the graph's loop control), kernel Y (the PCG step) and the
# fused solve as one CUDA graph against the eager driver
# ---------------------------------------------------------------------------
def test_graph_ctl_nested_while_if_while(dev):
    """Kernel X: a WHILE holding an IF holding a WHILE whose body runs torch
    ops, captured once and replayed for several n, against the eager
    driver and the closed form."""
    from stark_tpu_torch.tools import k12_checks

    build.reset_launches()
    res = k12_checks.nested_check(dev)
    assert res["ok"], res["cases"]
    assert build.launches["graph_ctl"] > 0


def _box_on_card(dtype, n=8, steps=3):
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    sim, cloth, spin = spinning_box_cloth(n, dtype, "cuda")
    sim.add_time_event(0.0, 10.0, spin)
    for _ in range(steps):
        assert sim.run_one_time_step()
    return sim, cloth


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pcg_step_matches_twin_on_the_box(dev, dtype):
    """Kernel Y's two halves against their twin over three CG iterations of
    the 8x8 spinning box's Newton system after three steps, within the sum
    rule; the flags equal."""
    from stark_tpu_torch.tools import k12_checks

    sim, _cloth = _box_on_card(dtype)
    A, Minv, b = k12_checks.newton_system(sim)
    build.reset_launches()
    res = k12_checks.pcg_step_check(A, Minv, b)
    assert res["flags_equal"] and res["max_err_ratio"] <= 1.0, res
    assert build.launches["pcg_step[1]"] == 3 and build.launches["pcg_step[2]"] == 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_graph_matches_eager_driver_bit_for_bit(dev, dtype):
    """Three solves of the 8x8 box on the card through the captured graph
    (one host read each), then each again under the eager driver from the
    recorded inputs: u, the stats and the counts, bit for bit."""
    from stark_tpu_torch.tools import k12_checks

    sim, _cloth = _box_on_card(dtype, steps=2)
    nm = sim.stark.newton
    rec = k12_checks.record(nm)
    lg = sim.get_logger()
    for _ in range(3):
        retraces = lg.get_int("fused_retraces")
        assert sim.run_one_time_step()
        assert nm.stats.host_syncs == 1 + lg.get_int("fused_retraces") - retraces
    k12_checks.stop_recording(nm, rec)
    assert nm._fused.captures >= 1
    res = k12_checks.graph_vs_eager(nm, rec)
    assert res["solves"] >= 3 and all(res["bitwise_equal"]), res
    assert sim.stark.newton.live_contact_pairs() > 0


def test_fused_graph_recaptures_on_overflow(dev):
    """A forced capacity overflow on the card re-solves through a new
    capture (two host reads) and gives, bit for bit, the step of a run that
    starts it with the bumped capacities."""
    small = {"w_pt": 16, "m_pt": 16, "w_ee": 16, "m_ee": 16, "pt_dd": 4,
             "pt_dr": 4, "ee_dd": 4, "ee_dr": 4}
    a, ca = _box_on_card("float64", n=6, steps=2)
    b, cb = _box_on_card("float64", n=6, steps=2)
    nm_a = a.stark.newton
    eng_a = a.interactions.contact.engine()
    eng_a.set_caps(small)
    nm_a._pool_cap = 8
    captures = nm_a._fused.captures
    assert a.run_one_time_step()
    retraces = a.get_logger().get_int("fused_retraces")
    assert retraces >= 1 and nm_a.stats.host_syncs == 1 + retraces
    # the smaller capacities are a new key (one capture), each re-solve another
    assert nm_a._fused.captures == captures + 1 + retraces
    b.interactions.contact.engine().set_caps(dict(eng_a._caps))
    b.stark.newton._pool_cap = nm_a._pool_cap
    assert b.run_one_time_step()
    assert b.stark.newton.stats.host_syncs == 1
    assert np.array_equal(ca.point_set.get_positions(), cb.point_set.get_positions())


def test_soft_boxes_exact_eigh_on_card_track_the_cpu_port(dev, monkeypatch):
    """jacobi_sweeps = 0, JAX's exact eigh, on the card: kernel Z's
    converged Jacobi inside the fused solve's CUDA graph (one host read per
    solve) runs the soft boxes for two f64 steps with the CPU port's codes
    and Newton counts (the CPU's exact eigh), positions within 1e-6 m; the
    staged solver (STARK_TPU_TORCH_NO_FUSED=1) likewise."""
    from stark_tpu_torch.tools.scenes import deformable_and_rigid_collisions

    build.reset_launches()
    sim, (h1, h2, _f) = deformable_and_rigid_collisions("float64", "cuda", 2, 1)
    sim.stark.settings.device.jacobi_sweeps = 0
    lg = sim.get_logger()
    for _ in range(2):
        retraces = lg.get_int("fused_retraces")
        assert sim.run_one_time_step()
        nm = sim.stark.newton
        assert nm.stats.host_syncs == 1 + lg.get_int("fused_retraces") - retraces
    assert nm._fused.captures >= 1 and build.launches["pd_project_z"] > 0
    assert build.launches["pd_project"] == 0
    x_fused = np.concatenate([h1.point_set.get_positions(), h2.point_set.get_positions()])
    x_cpu, codes_cpu, newton_cpu, _f = _soft_boxes("cpu", 0, steps=2)
    print(f"sweeps 0, fused: Newton per step card {lg.series['newton_iterations']}, "
          f"CPU {newton_cpu}")
    assert lg.series["solver_code"] == codes_cpu
    assert lg.series["newton_iterations"] == newton_cpu
    assert np.max(np.abs(x_fused - x_cpu)) < 1e-6
    monkeypatch.setenv("STARK_TPU_TORCH_NO_FUSED", "1")
    x_gpu, codes_gpu, newton_gpu, _f = _soft_boxes("cuda", 0, steps=2)
    x_cpu, codes_cpu, newton_cpu, _f = _soft_boxes("cpu", 0, steps=2)
    print(f"sweeps 0, staged: Newton per step card {newton_gpu}, CPU {newton_cpu}")
    assert codes_gpu == codes_cpu and newton_gpu == newton_cpu
    assert np.max(np.abs(x_gpu - x_cpu)) < 1e-6



# ---------------------------------------------------------------------------
# kernel Z: JAX's exact-eigh branch as Jacobi to convergence, and d > 64
# ---------------------------------------------------------------------------
def _z_case(d, dtype, dev, E):
    rng = np.random.default_rng(d)
    A = rng.normal(size=(E, d, d))
    H = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), dtype=dtype, device=dev)
    # PD, passing through: shifted by d so that no eigenvalue lies within
    # the dtype's noise (eps d |H|) of the clamp, where `changed` would be
    # a coin toss between two correct eigensolvers
    H[::3] = H[::3] @ H[::3].transpose(1, 2) + d * torch.eye(d, dtype=dtype, device=dev)
    mask = torch.as_tensor(rng.random(E) < 0.8, device=dev)
    return H, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [3, 9, 64, 65, 96, 112, 128, 176])
def test_pd_project_z_matches_twin(dev, dtype, d):
    """Kernel Z converged (jacobi_sweeps = 0) against its twin, both within
    2000 eps max|H_e| of the float64 eigh projection (the stop test makes
    both converge), every matrix converged; at d > 64 each matrix after the
    twin's number of sweeps (the wide layouts round their rotations as the
    twin does; the warp layouts contract FMAs, which can move a stop test
    by a sweep), and the wide layouts (shared to d = 119 in float64 and 169
    in float32, global past that: d = 128 in float64, 176 in both) at JAX's
    fixed sweeps (12) against the twin's `_jacobi_eigh`: where the
    twin converged (within 100 eps max|H_e| of eigh) within 2000 eps
    max|H_e| of it, else the kernel's largest distance from the projection
    within twice the twin's."""
    E = 257 if d <= 16 else 33
    H, mask = _z_case(d, dtype, dev, E)
    eps = torch.finfo(dtype).eps
    scale = H.double().cpu().abs().amax(dim=(1, 2))
    w, V = torch.linalg.eigh(H.double().cpu())
    exact = torch.einsum("eij,ej,ekj->eik", V, torch.where(w < 1e-9, -w, w), V)
    unconv = torch.zeros((), dtype=torch.int32, device=dev)
    out, ch = tproj.project_family_to_pd(H, 1e-9, True, mask, jacobi_sweeps=0,
                                         unconverged=unconv)
    ref, ch_ref = pd.pd_project_z_plain(H, 1e-9, True, mask, 0)
    ran = torch.zeros((E,), dtype=torch.int32, device=dev)
    pd.pd_project_z(H, 1e-9, True, mask, 0, None, ran)
    ran_ref = pd._jacobi_eigh_converged(H)[3]
    torch.cuda.synchronize()
    assert int(unconv) == 0 and torch.equal(ch, ch_ref)
    if d > pd.KERNEL_WIDE_MAX_D:
        assert torch.equal(ran.long(), ran_ref), (ran.tolist(), ran_ref.tolist())
    assert torch.equal(out[~ch], H[~ch])
    c = ch.cpu()
    tol = 2000.0 * eps * scale[:, None, None]
    assert torch.all(((out - ref).double().cpu().abs() <= tol)[c])
    assert torch.all(((out.double().cpu() - exact).abs() <= tol)[c])
    if d <= 64:
        return
    sweeps = 12
    before = build.launches["pd_project_z"]
    out, ch = tproj.project_family_to_pd(H, 1e-9, True, mask, jacobi_sweeps=sweeps)
    ref, ch_ref = pd.pd_project_z_plain(H, 1e-9, True, mask, sweeps)
    torch.cuda.synchronize()
    assert build.launches["pd_project_z"] == before + 1 and torch.equal(ch, ch_ref)
    spread = (ref.double().cpu() - exact).abs().amax(dim=(1, 2))
    dist = (out.double().cpu() - exact).abs().amax(dim=(1, 2))
    err = (out - ref).double().cpu().abs().amax(dim=(1, 2))
    conv = c & (spread <= 100.0 * eps * scale)
    print(f"d={d} {dtype} {sweeps} sweeps ({pd.z_layout(d, dtype)}): "
          f"{int(conv.sum())} of {int(c.sum())} converged")
    assert torch.all(err[conv] <= 2000.0 * eps * scale[conv])
    un = c & ~conv
    if un.any():
        assert float((dist / scale)[un].max()) <= 2.0 * float((spread / scale)[un].max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [3, 12, 96])
def test_pd_project_z_in_a_captured_graph(dev, dtype, d, monkeypatch):
    """Kernel Z captured into a CUDA graph and replayed: the converged mode
    with its device-side stop, and its count of unconverged matrices (a
    sweep limit of 1, which no matrix here meets: every one counted, as the
    twin counts them at that limit), with no host read."""
    E = 64 if d <= 16 else 5
    H, _m = _z_case(d, dtype, dev, E)
    ref, ch_ref = pd.pd_project_z_plain(H, 1e-9, False, None, 0)
    for limit in (pd.Z_MAX_SWEEPS, 1):
        monkeypatch.setattr(pd, "Z_MAX_SWEEPS", limit)
        unconv = torch.zeros((), dtype=torch.int32, device=dev)
        pd.pd_project_z(H, 1e-9, False, None, 0, unconv)      # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            unconv.zero_()
            out, ch = pd.pd_project_z(H, 1e-9, False, None, 0, unconv)
        graph.replay()
        torch.cuda.synchronize()
        _w, _V, n_un, _sw = pd._jacobi_eigh_converged(H.cpu(), max_sweeps=limit)
        assert int(unconv) == int(n_un)
        if limit == 1:
            assert int(n_un) > 0
            continue
        assert int(unconv) == 0 and torch.equal(ch, ch_ref)
        tol = 2000.0 * torch.finfo(dtype).eps * H.abs().amax(dim=(1, 2), keepdim=True)
        assert torch.all((out - ref).abs() <= tol)


# ---------------------------------------------------------------------------
# kernels AA-AC: JAX's gather-table and dense-direct helpers
# ---------------------------------------------------------------------------
def _bucket(dev, dtype, n=300, E=900, b=5, seed=0):
    rng = np.random.default_rng(seed)
    conn = rng.integers(0, n, size=(E, b))
    conn[rng.random((E, b)) < 0.1] = n
    conn[: E // 10] = n                                  # inactive rows
    conn[E // 2: E // 2 + 40, 0] = 7                     # one hot block
    A = rng.normal(size=(E, 3 * b, 3 * b))
    H = torch.as_tensor(A @ A.transpose(0, 2, 1), dtype=dtype)
    return torch.as_tensor(conn, dtype=torch.int32), H


def _skewed_bucket(dtype, n, K, b=5, seed=3):
    """A bucket whose gather table is skewed: block 7 fills its row of K
    entries, the other rows hold 0-3 entries, 30 of them none."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, n)
    counts[rng.choice(n, 30, replace=False)] = 0
    counts[7] = K
    ids = rng.permutation(np.repeat(np.arange(n), counts))
    E = -(-2 * len(ids) // b)
    flat = np.full(E * b, n)
    flat[rng.choice(E * b, len(ids), replace=False)] = ids
    A = rng.normal(size=(E, 3 * b, 3 * b))
    return (torch.as_tensor(flat.reshape(E, b), dtype=torch.int32),
            torch.as_tensor(A @ A.transpose(0, 2, 1), dtype=dtype))


@pytest.mark.parametrize("K", [4, 32])
def test_gather_tables_match_twin(dev, K):
    """Kernel AA's three table builds (and kernel E's compactions in them)
    against their twins, bit for bit, overflow signals included (K = 4:
    runs longer than K, more hot blocks than the side table holds; a slot
    capacity below the slot count)."""
    from stark_tpu_torch.ops import tables as tb

    conn, _H = _bucket(dev, torch.float64)
    n = 300
    rows = conn.reshape(-1)
    before = dict(build.launches)
    e, m = tb.gather_table(rows.to(dev), n, K)
    e_r, m_r = tb.gather_table_plain(rows.long(), n, K)
    out = tb.gather_table_rows(rows.to(dev), n, K, 4, 16)
    out_r = tb.gather_table_rows_plain(rows.long(), n, K, 4, 16)
    torch.cuda.synchronize()
    assert torch.equal(e.cpu(), e_r) and int(m) == int(m_r)
    for a, b in zip(out, out_r):
        assert torch.equal(a.cpu().long(), b.long())
    if K == 4:
        assert int(m) > K and int(out[3]) > 4
    for cap in (64, 1 << 14):
        d = tb.direct_tables(conn.to(dev), n, cap)
        d_r = tb.direct_tables_plain(conn, n, cap)
        torch.cuda.synchronize()
        for a, b in zip(d, d_r):
            assert torch.equal(a.cpu().long(), b.long())
    assert build.launches["gather_tables[scatter_table]"] == \
        before.get("gather_tables[scatter_table]", 0) + 1
    assert build.launches["gather_tables[scatter_table_rows]"] == \
        before.get("gather_tables[scatter_table_rows]", 0) + 2
    assert build.launches["gather_tables[direct_tables]"] == \
        before.get("gather_tables[direct_tables]", 0) + 6


@pytest.mark.parametrize("dtype", DTYPES)
def test_hvp_table_and_dense_runs_match_twin(dev, dtype):
    """Kernel AB against its twin within 64 eps sum|terms|, on the shared
    bucket and on a skewed table (one row full, most of 0-3 entries, some
    all pads), and the same bits from two launches; kernel AC's two
    layouts against theirs within 64 eps sum|terms|: the segmented scan in
    the input dtype over each run's terms, the f64 cumsum (JAX's
    direct_solve) over each run's terms in the dtype and over the prefix it
    differences in float64."""
    from stark_tpu_torch.ops import dense_runs as dr, hvp_table as htb, tables as tb

    n = 300
    p = torch.as_tensor(np.random.default_rng(1).normal(size=(n, 3)), dtype=dtype)
    for cn, Hn in (_bucket(dev, dtype), _skewed_bucket(dtype, n, 64)):
        entry, _m = tb.gather_table_plain(cn.reshape(-1).long(), n, 64)
        args = (p.to(dev), [(cn.to(dev), Hn.to(dev))], entry.to(dev))
        q, q2 = htb.hvp_table(*args), htb.hvp_table(*args)
        ref = htb.hvp_table_plain(p, [(cn, Hn)], entry)
        absref = htb.hvp_table_plain(p.abs(), [(cn, Hn.abs())], entry)
        torch.cuda.synchronize()
        assert torch.all((q.cpu() - ref).abs() <= _tol(absref, dtype, 64.0))
        assert torch.equal(q, q2)
    conn, H = _bucket(dev, dtype)
    dtab = tb.direct_tables_plain(conn, n, 1 << 15)
    dtab_d = tb.DirectTables(*(t.to(dev) for t in dtab))
    for layout in (dr.PERM, dr.DIRECT):
        out = dr.dense_runs(H.to(dev), dtab_d, n, layout)
        ref = dr.dense_runs_plain(H, dtab, n, layout)
        if layout == dr.PERM:
            tol = _tol(dr.dense_runs_plain(H.abs().double(), dtab, n, layout), dtype, 64.0)
        else:
            # the twin differences JAX's f64 cumsum: its error scales with
            # the prefix's sum |terms|, the kernel's with the run's
            run_abs, prefix_abs = dr.direct_sum_scales(H, dtab, n)
            tol = _tol(run_abs, dtype, 64.0) + _tol(prefix_abs, torch.float64, 64.0)
        torch.cuda.synchronize()
        assert torch.all((out.cpu().double() - ref.double()).abs() <= tol), layout
