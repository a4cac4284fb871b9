"""The port's kernel twins against the JAX functions they replace.

Every kernel of `stark_tpu_torch/ops` runs its plain PyTorch twin on the CPU
(a CUDA tensor would launch the kernel instead). Here each twin, and the
port function built on it, is held against the `stark_tpu` function it
replaces on the same numpy inputs: the frozen tables of a small hanging
cloth carried across with `utils/from_jax.py`, and seeded random states.

Tolerance: 1e-10 relative in f64 — the two sides differ only in summation
order (and the JAX side pads its single bucket to 15x15, the port to 12x12,
so layouts differ while values agree).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu.solver import assembly as jas
from stark_tpu.solver import project as jproj
from stark_tpu_torch.ops import block3, hvp_bucket as hb, pd_project as pd
from stark_tpu_torch.ops import segment_reduce as sr
from stark_tpu_torch.solver import project as tproj
from stark_tpu_torch.utils.from_jax import state_from_numpy, tables_from_numpy

RTOL = 1e-10


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _cloth(pkg, n, cpu):
    from importlib import import_module
    P = import_module(pkg.__name__ + ".models.deformables.energies").PrescribedPositionsParams
    S = import_module(pkg.__name__ + ".presets.presets").SurfaceParams
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    if cpu:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    h = sim.presets.deformables.add_surface_grid("", (0.3, 0.3), (n, n),
                                                 S.Cotton_Fabric())
    sim.deformables.prescribed_positions.add(h.point_set, [0, n], P())
    sim.stark._initialize()
    return sim


class Pair:
    """The same frozen scene in both packages; the port computes on the
    JAX package's tables and state, carried across as numpy."""

    def __init__(self, n=5, seed=0):
        self.js = _cloth(stark_tpu, n, cpu=False)
        self.ts = _cloth(stark_tpu_torch, n, cpu=True)
        self.jev = self.js.stark.newton._ev
        self.tev = self.ts.stark.newton._ev
        self.jdata = self.js._get_static_data()
        jglob = self.js._get_glob()
        self.jglob = jglob
        np_tables = {k: {"conn": np.asarray(fd["conn"]),
                         "rows": {r: np.asarray(v) for r, v in fd["rows"].items()}}
                     for k, fd in self.jdata.items()}
        self.tdata = tables_from_numpy(np_tables)
        self.tglob = {"dt": torch.tensor(float(jglob["dt"]), dtype=torch.float64),
                      "gravity": torch.as_tensor(np.asarray(jglob["gravity"]))}
        self.tglob.update(state_from_numpy(np.asarray(jglob["x0"]),
                                           np.asarray(jglob["v0"]),
                                           np.asarray(jglob["X"])))
        self.n_blocks = self.tev.n_blocks
        rng = np.random.default_rng(seed)
        self.u = rng.normal(0.0, 0.3, (self.n_blocks, 3))
        self.topo = self.tev.topology(self.tdata, dense=True)

    def jax_hess_cat(self, hess):
        ev = self.jev
        stat, _ = ev.split_dyn(hess.keys())
        hs = {k: hess[k] for k in stat}
        hp, _ = jax.jit(jproj.project_all, static_argnums=(1, 2))(
            hs, 1e-10, False, {k: self.jdata[k] for k in stat})
        conn_live, H_live, _v, _c = ev.live_select(
            ev.dyn_conn_cat(self.jdata), ev.dyn_hess_cat(hess), 8)
        return ev.cat_with_live(ev.cat_static_conn(self.jdata), hp, conn_live, H_live)

    def torch_hess_cat(self, hess):
        ev = self.tev
        stat, _ = ev.split_dyn(hess.keys())
        hp, _ = tproj.project_all({k: hess[k] for k in stat}, 1e-10, False,
                                  {k: self.tdata[k] for k in stat})
        return ev.cat_with_live(self.topo.conn_cat, hp)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def egh(pair):
    """energy_grad_hess of both packages at the same random state."""
    j = jax.jit(pair.jev.energy_grad_hess)(jnp.asarray(pair.u), pair.jdata,
                                           pair.jglob)
    t = pair.tev.energy_grad_hess(torch.as_tensor(pair.u), pair.tdata,
                                  pair.tglob, pair.topo)
    return j, t


def test_egh_grad_and_aux_match_jax(egh):
    """Kernel A's twin at the egh site: the (R, 9) payload sums."""
    (E_j, aux_j, g_j, _), (E_t, aux_t, g_t, _) = egh
    assert _rel(E_t, E_j) < RTOL
    assert _rel(g_t, g_j) < RTOL
    for k in ("e_nsq", "g_nsq", "hsum"):
        assert _rel(aux_t[k], aux_j[k]) < RTOL, k


@pytest.fixture(scope="module")
def hess_cat(pair, egh):
    (_, _, _, hj), (_, _, _, ht) = egh
    cj, Hj = pair.jax_hess_cat(hj)
    ct, Ht = pair.torch_hess_cat(ht)
    return cj, Hj, ct, Ht


def test_diag_bucket_matches_jax(pair, hess_cat):
    """Kernel A's twin at the diag_bucket site."""
    cj, Hj, _ct, Ht = hess_cat
    D_j = pair.jev.diag_bucket(cj, Hj)
    D_t = pair.tev.diag_bucket(Ht, pair.topo)
    assert D_t.shape == (pair.n_blocks, 3, 3)
    assert _rel(D_t, D_j) < RTOL


def test_hvp_bucket_matches_jax(pair, hess_cat):
    """Kernel B's twin against ev.hvp_bucket (15x15 bucket vs 12x12)."""
    cj, Hj, _ct, Ht = hess_cat
    assert Ht.shape[-1] == 12 and next(iter(Hj.values())).shape[-1] == 15
    p = np.random.default_rng(3).normal(size=(pair.n_blocks, 3))
    q_j = pair.jev.hvp_bucket(jnp.asarray(p), cj, Hj, pair.jev.scatter_rows(cj))
    q_t = pair.tev.hvp_bucket(torch.as_tensor(p), Ht, pair.topo)
    assert _rel(q_t, q_j) < RTOL


@pytest.mark.parametrize("d", [9, 12, 15])
def test_jacobi_eigh_matches_jax(rng, d):
    A = rng.standard_normal((40, d, d))
    H = 0.5 * (A + np.swapaxes(A, 1, 2))
    w_j, V_j = jax.jit(jproj._jacobi_eigh, static_argnums=1)(jnp.asarray(H), 8)
    w_t, V_t = pd._jacobi_eigh(torch.as_tensor(H), 8)
    assert _rel(w_t, w_j) < RTOL
    assert _rel(V_t, V_j) < 1e-8   # rotation angles agree to rounding
    R_j = np.einsum("eij,ej,ekj->eik", V_j, w_j, V_j)
    R_t = torch.einsum("eij,ej,ekj->eik", V_t, w_t, V_t)
    assert _rel(R_t, R_j) < RTOL


@pytest.mark.parametrize("d", [9, 12, 15])
@pytest.mark.parametrize("mirroring,masked", [(False, False), (True, False),
                                              (False, True)])
@pytest.mark.parametrize("sweeps", [0, 8])
def test_pd_project_matches_jax(rng, d, mirroring, masked, sweeps):
    """Kernel C's twin against project_family_to_pd."""
    A = rng.standard_normal((32, d, d))
    H = 0.5 * (A + np.swapaxes(A, 1, 2))
    H[::5] = H[::5] @ np.swapaxes(H[::5], 1, 2)      # some PD elements
    mask = rng.random(32) < 0.7 if masked else None
    Hp_j, ch_j = jax.jit(jproj.project_family_to_pd, static_argnums=(1, 2, 4))(
        jnp.asarray(H), 1e-9, mirroring,
        None if mask is None else jnp.asarray(mask), sweeps)
    Hp_t, ch_t = tproj.project_family_to_pd(
        torch.as_tensor(H), 1e-9, mirroring,
        None if mask is None else torch.as_tensor(mask), jacobi_sweeps=sweeps)
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch_j))
    assert _rel(Hp_t, Hp_j) < (RTOL if sweeps else 1e-9)


def test_block3_matches_jax(pair, hess_cat):
    """Kernel D's twins against precondition_inverse/apply_preconditioner,
    singular blocks included."""
    _cj, _Hj, _ct, Ht = hess_cat
    D = pair.tev.diag_bucket(Ht, pair.topo).numpy().copy()
    D[::4] = 0.0
    D[1::7] = 1.0          # rank one: det == 0
    Di_j = jas.precondition_inverse(jnp.asarray(D))
    Di_t = block3.block3_inverse(torch.as_tensor(D))
    assert _rel(Di_t, Di_j) < RTOL
    np.testing.assert_array_equal(Di_t.numpy()[::4], np.broadcast_to(np.eye(3), D[::4].shape))
    r = np.random.default_rng(5).normal(size=(D.shape[0], 3))
    z_j = jas.apply_preconditioner(Di_j, jnp.asarray(r))
    z_t = block3.block3_apply(Di_t, torch.as_tensor(r))
    assert _rel(z_t, z_j) < RTOL


def test_ns_refresh_and_dense_apply_match_jax(pair, hess_cat):
    """The dense Newton-Schulz preconditioner (assembled through kernel A's
    twin keyed by block-pair id): cold start, then a warm sweep."""
    cj, Hj, _ct, Ht = hess_cat
    n = 3 * (pair.n_blocks + 1)
    M_j, q_j, bad_j = pair.jev.ns_refresh(jnp.zeros((n, n)), cj, Hj)
    M_t, q_t, bad_t = pair.tev.ns_refresh(torch.zeros((n, n), dtype=torch.float64),
                                          Ht, pair.topo)
    assert bool(bad_j) and bool(bad_t)
    assert _rel(M_t, M_j) < RTOL
    # q = max|I - Hs Ms| sits at the f64 rounding floor on both sides
    assert float(q_t) < 1e-10 and float(q_j) < 1e-10
    Mw_j, qw_j, badw_j = pair.jev.ns_refresh(M_j, cj, Hj)
    Mw_t, qw_t, badw_t = pair.tev.ns_refresh(M_t, Ht, pair.topo)
    assert not bool(badw_j) and not bool(badw_t)
    assert _rel(Mw_t, Mw_j) < RTOL
    r = np.random.default_rng(11).normal(size=(pair.n_blocks, 3))
    a_j = pair.jev.apply_dense_perm(Mw_j, jnp.asarray(r))
    a_t = pair.tev.apply_dense_perm(Mw_t, torch.as_tensor(r))
    assert _rel(a_t, a_j) < RTOL


def test_dense_assembly_matches_jax(pair, hess_cat):
    cj, Hj, _ct, Ht = hess_cat
    A_j = pair.jev.assemble_dense_scatter(cj, Hj)
    A_t = pair.tev.assemble_dense_scatter(Ht, pair.topo)
    assert _rel(A_t, A_j) < RTOL


def test_segment_reduce_csr_semantics():
    """Rows with id >= n_seg are dropped, empty segments give 0, and each
    segment sums its rows in their original order."""
    rows = torch.tensor([3, 0, 5, 3, 7, 0, 1])
    pay = torch.arange(14, dtype=torch.float64).reshape(7, 2)
    csr = sr.build_csr(rows, 5)
    assert csr.offsets.tolist() == [0, 2, 3, 3, 5, 5]
    assert csr.perm.tolist()[:5] == [1, 5, 6, 0, 3]
    assert sorted(csr.perm.tolist()[5:]) == [2, 4]
    out = sr.segment_reduce(pay, csr, "test")
    ref = np.zeros((5, 2))
    for r, p in zip(rows.tolist(), pay.numpy()):
        if r < 5:
            ref[r] += p
    np.testing.assert_array_equal(out.numpy(), ref)


def test_hvp_twin_equals_dense_product(rng):
    """Kernel B's twin is the matrix-free form of the assembled product."""
    n, E, b = 7, 9, 3
    conn = torch.as_tensor(rng.integers(0, n + 1, size=(E, b)))
    A = rng.standard_normal((E, 3 * b, 3 * b))
    H = torch.as_tensor(A + np.swapaxes(A, 1, 2))
    p = torch.as_tensor(rng.standard_normal((n, 3)))
    csr = sr.build_csr(conn.reshape(-1), n)
    q = hb.hvp_bucket(p, conn.to(torch.int32), H, csr)
    K = np.zeros((n + 1, 3, n + 1, 3))
    Hb = H.numpy().reshape(E, b, 3, b, 3)
    for e in range(E):
        for i in range(b):
            for j in range(b):
                K[conn[e, i], :, conn[e, j], :] += Hb[e, i, :, j, :]
    p_pad = np.concatenate([p.numpy(), np.zeros((1, 3))])
    ref = np.einsum("iajb,jb->ia", K, p_pad)[:n]
    np.testing.assert_allclose(q.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the twin. Any other device goes to the kernel
    path, whose checks raise before a launch (no silent fallback)."""
    meta = torch.zeros((4, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="exact eigh"):
        pd.pd_project(meta, 1e-9, False, None, 0)
    with pytest.raises(ValueError, match="exceeds"):
        pd.pd_project(torch.zeros((4, 17, 17), device="meta"), 1e-9, False, None, 8)
    with pytest.raises(ValueError, match="CUDA"):
        block3.block3_inverse(meta)
    csr = sr.build_csr(torch.tensor([0, 1, 1, 2]), 3)
    with pytest.raises(ValueError, match="CUDA"):
        sr.segment_reduce(torch.zeros((4, 9), device="meta"), csr, "test")
