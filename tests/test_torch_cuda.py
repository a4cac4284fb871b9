"""Kernels A-D on a CUDA card against their plain twins.

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

from stark_tpu_torch.ops import block3, build, hvp_bucket as hb, pd_project as pd
from stark_tpu_torch.ops import segment_reduce as sr

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
