"""Kernels A-V (and the staged solver's sites: B [staged], A [direct], I's
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
from stark_tpu_torch.tools import egh_cases as ec

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


def test_pd_project_refuses_exact_eigh_on_cuda(dev):
    with pytest.raises(ValueError, match="exact eigh"):
        pd.pd_project(torch.eye(4, device=dev)[None], 1e-9, False, None, 0)


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
    """Kernel B at its staged site (one launch per arity group) and kernel
    A's direct site (DirectLLT's dense Hessian) on a 6x6 cloth's element
    Hessians at a random state, against the twins on the CPU: within the
    sum tolerance 64 eps * sum|terms|."""
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
    aD = ev.assemble_dense_direct(data, absh)
    assert launched == n_groups >= 3 and launched_d == 1
    assert torch.all((q_g - q_c).abs() <= _tol(aq, dtype, 64.0))
    assert torch.all((D_g - D_c).abs() <= _tol(aD, dtype, 64.0))


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
