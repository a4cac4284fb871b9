"""Kernels A-J on a CUDA card against their plain twins, and three small
scenes on the card against the port on the CPU.

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("cap", [40, 100000])
def test_friction_pairs_matches_twin(dev, dtype, kind, cap):
    """Kernel I: the same kept pairs in the same row-major order as the
    twin on the CPU, and the exact count past the capacity. Each query row's
    nearest allowed pair is placed at d = dhat, and 1 and 3 ulps on either
    side of it, through the query's own thickness (every primitive is its
    own mesh; the targets' thickness is 0); some mesh pairs have mu = 0."""
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
    args = (V, table, allowed.to(torch.uint8),
            *((mesh_q, mesh_t) if kind == "pt" else (mesh_q,)), mu, th, cap)
    plain = fp.friction_pairs_pt_plain if kind == "pt" else fp.friction_pairs_ee_plain
    kernel = fp.friction_pairs_pt if kind == "pt" else fp.friction_pairs_ee
    ref = plain(*args)
    before = build.launches[f"friction_pairs[{kind}]"]
    out = kernel(*(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args))
    torch.cuda.synchronize()
    assert build.launches[f"friction_pairs[{kind}]"] == before + 1
    n = int(ref[4])
    assert int(out[4]) == n > 100
    assert torch.equal(out[0].cpu(), ref[0]) and torch.equal(out[1].cpu(), ref[1])
    assert torch.equal(out[3].cpu(), ref[3])
    eps = torch.finfo(dtype).eps
    assert torch.all((out[2].cpu() - ref[2]).abs() <= 64 * eps * (1 + V.abs().max()))
    if cap > n:
        kept = set((ref[0].long() * nt + ref[1].long())[:n].tolist())
        for r, jj, k in zip(rows.tolist(), j.tolist(), steps.tolist()):
            if mu[mesh_q[r], mesh_t[jj]] != 0:
                assert (r * nt + jj in kept) == (k >= 0), (r, k)


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
