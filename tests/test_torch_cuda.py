"""Kernels A-H on a CUDA card against their plain twins, and two small
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
