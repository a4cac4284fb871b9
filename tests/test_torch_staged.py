"""The port's staged Newton solver against `stark_tpu`'s.

The staged solver takes DirectLLT, the ProjectOnDemand and Progressive
projection modes, custom solver callbacks and the STARK_TPU_TORCH_NO_FUSED
switch. Here both packages run on the CPU (the port's kernels by their
plain twins) on the same scenes and the same frozen inputs: the four
projection modes on the 4x4 hanging cloth, the staged linear algebra
(per-arity Hessian-vector products, diagonal blocks, the DirectLLT step),
the line-search failure dump, and the distance regions at their
boundaries. The JAX package's staged path is reached with its own
STARK_TPU_NO_FUSED switch, set here per test only. The contact refresh and
the friction scenes are in tests/test_torch_staged_contact.py.
"""
import math
import os
from fractions import Fraction
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu.collision import narrow_phase as jnph
from stark_tpu.solver import project as jproj
from stark_tpu_torch.collision import narrow_phase as tnph
from stark_tpu_torch.utils.from_jax import tables_from_numpy

RTOL = 1e-10
MODES = ["ProjectedNewton", "Newton", "ProjectOnDemand", "Progressive"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def staged(monkeypatch):
    """Both packages' no-fused switches on for this test only."""
    monkeypatch.setenv("STARK_TPU_NO_FUSED", "1")
    monkeypatch.setenv("STARK_TPU_TORCH_NO_FUSED", "1")


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _settings(pkg, mode=None, solver=None, dtype="float64"):
    st = import_module(pkg.__name__ + ".core.settings")
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    s.simulation.max_time_step_size = 1 / 60
    s.device.dtype = dtype
    if mode is not None:
        s.newton.projection_mode = getattr(st.ProjectionToPD, mode)
    if solver is not None:
        s.newton.linear_solver = getattr(st.LinearSolver, solver)
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    return s


def _cloth(pkg, settings, n=4):
    """tests/test_solver_modes.py's scene: a 0.2 m n x n cloth pinned at
    two corners."""
    e = import_module(pkg.__name__ + ".models.deformables.energies")
    p = import_module(pkg.__name__ + ".presets.presets")
    sim = pkg.Simulation(settings)
    h = sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (n, n),
                                                 p.SurfaceParams.Cotton_Fabric())
    sim.deformables.prescribed_positions.add(h.point_set, [0, n],
                                             e.PrescribedPositionsParams())
    return sim, h


def _run_cloth(pkg, settings, steps=12):
    sim, h = _cloth(pkg, settings)
    for _ in range(steps):
        assert sim.run_one_time_step()
    return np.asarray(h.point_set.get_positions()), sim


# ---------------------------------------------------------------------------
# projection modes and the staged/fused equivalence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_projection_modes(mode):
    """Port of tests/test_solver_modes.py::test_projection_modes (the modes
    the fused solve does not take go through the staged solver)."""
    x, sim = _run_cloth(stark_tpu_torch, _settings(stark_tpu_torch, mode, dtype="float32"))
    assert np.all(np.isfinite(x))
    assert np.mean(x[:, 2]) < -0.002  # sagged
    staged = mode in ("ProjectOnDemand", "Progressive")
    assert sim.stark.newton._fused_eligible() is not staged


@pytest.mark.parametrize("mode,solver", [(m, None) for m in MODES]
                         + [("ProjectedNewton", "DirectLLT")])
def test_projection_modes_match_stark_tpu(staged, mode, solver):
    """Every projection mode (and DirectLLT) on the staged solvers of both
    packages, f64, 12 steps: positions within 1e-8 m, the same Newton
    counts, solver codes and projected-Hessian ratios."""
    xj, js = _run_cloth(stark_tpu, _settings(stark_tpu, mode, solver))
    xt, ts = _run_cloth(stark_tpu_torch, _settings(stark_tpu_torch, mode, solver))
    assert np.max(np.abs(xt - xj)) < 1e-8
    for key in ("newton_iterations", "solver_code", "projected_hessians_ratio"):
        assert ts.get_logger().series.get(key) == js.get_logger().series.get(key), key


def test_staged_matches_fused(monkeypatch):
    """Port of tests/test_solver_modes.py::test_staged_matches_fused: the
    port's fused and staged solves within 1e-6 m, and the port's staged
    solve against JAX's staged solve."""
    x_fused, tf = _run_cloth(stark_tpu_torch, _settings(stark_tpu_torch, dtype="float32"))
    assert tf.stark.newton._fused_eligible()
    monkeypatch.setenv("STARK_TPU_TORCH_NO_FUSED", "1")
    x_staged, ts = _run_cloth(stark_tpu_torch, _settings(stark_tpu_torch, dtype="float32"))
    assert not ts.stark.newton._fused_eligible()
    assert np.max(np.abs(x_fused - x_staged)) < 1e-6, "fused and staged solvers diverged"
    monkeypatch.setenv("STARK_TPU_NO_FUSED", "1")
    x_jax, _ = _run_cloth(stark_tpu, _settings(stark_tpu, dtype="float32"))
    assert np.max(np.abs(x_staged - x_jax)) < 1e-6


def test_custom_callbacks_take_the_staged_solver():
    """A custom residual takes a solve off the fused path (stark_tpu
    newton.py:215-226); the step still converges."""
    sim, h = _cloth(stark_tpu_torch, _settings(stark_tpu_torch))
    sim.stark.callbacks.newton.residual = lambda g: float(torch.max(torch.abs(g)))
    assert sim.run_one_time_step()
    assert not sim.stark.newton._fused_eligible()
    assert np.all(np.isfinite(h.point_set.get_positions()))


# ---------------------------------------------------------------------------
# K15: the staged linear algebra on one frozen state
# ---------------------------------------------------------------------------
def _frozen_cloth(n=5):
    """Both packages' 5x5 cloth, the JAX tables carried into the port, and
    the element Hessians of one evaluation at a random state, projected to
    PD by the JAX package (both sides get the same values)."""
    js, _ = _cloth(stark_tpu, _settings(stark_tpu), n)
    ts, _ = _cloth(stark_tpu_torch, _settings(stark_tpu_torch), n)
    js.stark._initialize()
    ts.stark._initialize()
    jdata = js._get_static_data()
    jglob = js._get_glob()
    tdata = tables_from_numpy(
        {k: {"conn": np.asarray(fd["conn"]),
             "rows": {r: np.asarray(v) for r, v in fd["rows"].items()}}
         for k, fd in jdata.items()})
    jnm, tnm = js.stark.newton, ts.stark.newton
    u = np.random.default_rng(3).normal(0.0, 0.3, (tnm.n_blocks, 3))
    _E, _aux, g_j, h_raw = jax.jit(jnm._ev.energy_grad_hess)(jnp.asarray(u), jdata, jglob)
    h_j, _ = jax.jit(jproj.project_all, static_argnums=(1, 2))(h_raw, 1e-10, False)
    h_t = {k: torch.as_tensor(np.asarray(v)) for k, v in h_j.items()}
    return (jnm, tnm, jdata, tdata, g_j, torch.as_tensor(np.asarray(g_j)), h_j, h_t,
            h_raw)


def test_staged_linear_algebra_matches_jax():
    """hvp, diag_blocks and the DirectLLT step on the same projected element
    Hessians, f64: within 1e-10 of JAX's, over four arity groups."""
    jnm, tnm, jdata, tdata, g_j, g_t, h_j, h_t, _ = _frozen_cloth()
    jev, tev = jnm._ev, tnm._ev
    groups = tev.staged_groups(tdata)
    assert sorted(groups) == sorted({f.arity for f in tnm.families if f.name in tdata})
    assert len(groups) >= 3
    p = np.random.default_rng(4).normal(size=(tnm.n_blocks, 3))
    q_j = jax.jit(jev.hvp)(jnp.asarray(p), jdata, h_j)
    q_t = tev.hvp(torch.as_tensor(p), tdata, h_t)
    assert _rel(q_t, q_j) < RTOL
    D_j = jax.jit(jev.diag_blocks)(jdata, h_j)
    D_t = tev.diag_blocks(tdata, h_t)
    assert _rel(D_t, D_j) < RTOL
    du_j, ok_j = jax.jit(jnm._direct_stage)(g_j, jdata, h_j)
    du_t, ok_t = tnm._direct_stage(g_t, tdata, h_t)
    assert bool(ok_j) and bool(ok_t)
    assert _rel(du_t, du_j) < RTOL
    # the Newton direction solves the system it was assembled from
    r = tev.hvp(du_t, tdata, h_t) + g_t
    assert float(torch.max(torch.abs(r))) < 1e-8 * float(torch.max(torch.abs(g_t)))


def test_direct_stage_reports_an_indefinite_system():
    """DirectLLT on an indefinite Hessian (Newton mode, the inertia's element
    Hessians negated) gives ok = False, as JAX's NaN-producing cho_factor
    does, instead of raising: the projection ladder can go on."""
    jnm, tnm, jdata, tdata, g_j, g_t, _h_j, _h_t, h_raw = _frozen_cloth()
    name = "EnergyLumpedInertia"
    h_j = dict(h_raw)
    h_j[name] = -h_j[name]
    h_t = {k: torch.as_tensor(np.asarray(v)) for k, v in h_j.items()}
    _du_j, ok_j = jax.jit(jnm._direct_stage)(g_j, jdata, h_j)
    _du_t, ok_t = tnm._direct_stage(g_t, tdata, h_t)
    assert not bool(ok_j)
    assert not bool(ok_t)


def test_projection_ladder_recovers_from_a_failed_cholesky(staged):
    """ProjectOnDemand with DirectLLT on a cloth squeezed to a third of its
    width: the raw Hessian is indefinite, the Cholesky reports it, and the
    ladder projects and solves again; both packages take the same steps
    (f64)."""
    out = {}
    for pkg in (stark_tpu, stark_tpu_torch):
        sim, h = _cloth(pkg, _settings(pkg, "ProjectOnDemand", "DirectLLT"))
        b, n = h.point_set.get_begin(), h.point_set.size()
        sim._dyn._x0_host[b:b + n, 0] *= 0.3
        for _ in range(3):
            assert sim.run_one_time_step()
        lg = sim.get_logger()
        out[pkg.__name__] = (np.asarray(h.point_set.get_positions()),
                             lg.series["newton_iterations"],
                             lg.series["projected_hessians_ratio"])
    (xj, nj, pj), (xt, nt, pt) = out["stark_tpu"], out["stark_tpu_torch"]
    assert nt == nj
    assert np.allclose(pt, pj, rtol=0.0, atol=1e-12)
    assert max(pj) > 0.0, "no projection happened"
    assert np.max(np.abs(xt - xj)) < 1e-8



def test_jacobi_sweeps_on_clustered_spectra():
    """Why kernel C and its twin can end apart on the flat-bending blocks,
    which the solver never projects (PSD by construction): such a block has
    a triple eigenvalue over nine near-zero ones, and there the parallel
    Jacobi of JAX's `_jacobi_eigh` (theta = atan2(2 a_pq, a_qq - a_pp) / 2,
    rotations up to pi/2) converges slowly, so its 8-sweep projection moves
    with the rounding of its input. On a squeezed 6x6 cloth, one ulp of
    symmetric noise on each entry (4 draws) moves the 8-sweep projection
    of the bending blocks over five times as far as the exact (eigh)
    projection or 32 sweeps move, in the port's twin and in JAX's own
    function alike, while those two and the strain blocks' 8 sweeps move
    by rounding only (under 100 eps). Gaps relative to
    a block's largest entry."""
    from stark_tpu_torch.ops.pd_project import pd_project_plain

    sim, h = _cloth(stark_tpu_torch, _settings(stark_tpu_torch, "Progressive"), n=6)
    b, n = h.point_set.get_begin(), h.point_set.size()
    sim._dyn._x0_host[b:b + n, 0] *= 0.3
    sim.stark._initialize()
    ev = sim.stark.newton._ev
    data, glob = sim._get_data(), sim._get_glob()
    u = torch.zeros((ev.n_blocks, 3), dtype=torch.float64)
    _E, _aux, _g, hess = ev.energy_grad_hess(u, data, glob, None, ev.egh_csr(data))
    assert "EnergyBendingFlat" in sim.stark.newton._psd_names

    jax_project = jax.jit(lambda H: jproj.project_family_to_pd(H, 1e-10, False,
                                                               jacobi_sweeps=8)[0])

    def jax8(H):
        return torch.as_tensor(np.asarray(jax_project(jnp.asarray(H.numpy()))))

    for dtype in (torch.float64, torch.float32):
        eps = torch.finfo(dtype).eps
        rounding = 100.0 * eps
        for name in ("EnergyBendingFlat", "EnergyTriangleStrain"):
            H = hess[name].to(dtype)
            scale = H.abs().amax(dim=(1, 2)).double()
            base = {sw: pd_project_plain(H, 1e-10, False, jacobi_sweeps=sw)[0]
                    for sw in (0, 8, 32)}
            base["jax"] = jax8(H)
            move = dict.fromkeys(base, 0.0)
            for seed in range(4):
                noise = torch.as_tensor(np.random.default_rng(seed).integers(
                    -1, 2, size=H.shape), dtype=dtype)
                noise = torch.triu(noise) + torch.triu(noise, 1).transpose(1, 2)
                Hn = H + noise * H.abs() * eps
                for key in move:
                    out = jax8(Hn) if key == "jax" else \
                        pd_project_plain(Hn, 1e-10, False, jacobi_sweeps=key)[0]
                    gap = (out - base[key]).double().abs().amax(dim=(1, 2)) / scale
                    move[key] = max(move[key], float(gap.max()))
            print(f"{name} {dtype}: one ulp moves the projection by "
                  + ", ".join(f"{k} {v:.2e}" for k, v in move.items())
                  + " (sweeps; 0 = exact eigh, jax = JAX's 8 sweeps)")
            assert move[0] < rounding and move[32] < rounding, name
            if name == "EnergyTriangleStrain":
                assert move[8] < rounding and move["jax"] < rounding
            else:
                floor = 5.0 * max(move[0], move[32])
                assert move[8] > floor and move["jax"] > floor

# ---------------------------------------------------------------------------
# the line-search failure dump
# ---------------------------------------------------------------------------
def test_print_line_search_upon_failure_writes_profile(staged, tmp_path):
    """With no Armijo iteration allowed the staged line search fails at once
    (f64 keeps the failure); print_line_search_upon_failure writes the
    energy along the failed direction, the same numbers as JAX's."""
    profiles = {}
    for pkg in (stark_tpu, stark_tpu_torch):
        s = _settings(pkg)
        s.output.output_directory = str(tmp_path / pkg.__name__)
        os.makedirs(s.output.output_directory)
        s.newton.max_backtracking_armijo_iterations = 0
        s.newton.print_line_search_upon_failure = True
        sim, _h = _cloth(pkg, s)
        sim.run_one_time_step()
        assert sim.get_logger().get_int("failed_steps") >= 1
        path = os.path.join(s.output.output_directory, "line_search_failure_0.txt")
        assert os.path.exists(path)
        profiles[pkg.__name__] = np.loadtxt(path)
    pj, pt = profiles["stark_tpu"], profiles["stark_tpu_torch"]
    assert pt.shape == pj.shape == (1000, 2)
    assert _rel(pt, pj) < 1e-12


# ---------------------------------------------------------------------------
# distance regions at their boundaries (ROADMAP Queue 3 item 1)
# ---------------------------------------------------------------------------
def _ulps(x, k):
    out = np.float64(x)
    for _ in range(abs(k)):
        out = np.nextafter(out, np.inf if k > 0 else -np.inf)
    return out


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q


def _perturbed(points, ks=(0, 1, -1, 2, -2, 3, -3)):
    """Every point, and every point with one coordinate moved 1-3 ulps."""
    out = []
    for p in points:
        for k in ks:
            for axis in range(3):
                q = np.array(p, dtype=np.float64)
                q[axis] = _ulps(q[axis], k)
                out.append(q)
    return out


def _pt_boundary_rows(rng, n_tri=24):
    """(p, t0, t1, t2) rows: points on each edge line at s = 0, 1/2, 1, in
    the plane and 1 mm above, on the edges' outward normals at 0 and +-0.3,
    at the vertices, plus 1-3 ulps either side; the first triangle has
    exactly representable vertices, the rest are rotated and scaled."""
    rows = []
    for k in range(n_tri):
        if k == 0:
            t0, t1, t2 = np.array([0., 0, 0]), np.array([2., 0, 0]), np.array([0., 2, 0])
        else:
            R, sc, off = _rotation(rng), 10.0 ** rng.uniform(-2, 0), rng.normal(0, 0.3, 3)
            t0, t1, t2 = (off + sc * (R @ (rng.normal(0, 1, 3) * [1, 1, 0]))
                          for _ in range(3))
        n = np.cross(t1 - t0, t2 - t0)
        nh = n / np.linalg.norm(n)
        pts = [t0, t1, t2]
        for a, b in ((t0, t1), (t1, t2), (t2, t0)):
            perp = np.cross(b - a, nh)
            pts += [a + s * (b - a) + o * perp + h * nh
                    for s in (0.0, 0.5, 1.0) for o in (0.0, 0.3, -0.3) for h in (0.0, 1e-3)]
        rows += [np.concatenate([p, t0, t1, t2]) for p in _perturbed(pts)]
    return np.asarray(rows)


def _ee_boundary_rows(rng, n_pairs=24, tol=1e-20):
    """(ea0, ea1, eb0, eb1) rows: eb perpendicular to ea, through ea's
    parameter s in {0, 1/2, 1} at its own parameter t in {0, 1/2, 1}, and
    nearly parallel pairs at the parallel cutoff sin^2 = tol (and a relative
    1e-9 either side); an endpoint of eb moved 1-3 ulps in each coordinate."""
    rows = []
    for k in range(n_pairs):
        R = np.eye(3) if k == 0 else _rotation(rng)
        sc = 1.0 if k == 0 else 10.0 ** rng.uniform(-2, 0)
        off = np.zeros(3) if k == 0 else rng.normal(0, 0.3, 3)
        f = lambda v: off + sc * (R @ np.asarray(v, dtype=np.float64))
        ea0, ea1 = f((0, 0, 0)), f((1, 0, 0))
        side, up = f((0, 1, 0)) - off, f((0, 0, 1)) - off
        pairs = []
        for s in (0.0, 0.5, 1.0):
            for t in (0.0, 0.5, 1.0):
                p = ea0 + s * (ea1 - ea0) + 1e-3 * side
                pairs.append((p - t * up, p + (1 - t) * up))
        for th2 in (tol, tol * (1 + 1e-9), tol * (1 - 1e-9)):
            pairs.append((f((0.2, 1e-3, 0)),
                          f((0.2 + math.sqrt(1 - th2), 1e-3 + math.sqrt(th2), 0))))
        for eb0, eb1 in pairs:
            for q in _perturbed([eb0]):
                rows.append(np.concatenate([ea0, ea1, q, eb1]))
            for q in _perturbed([eb1])[1:]:
                rows.append(np.concatenate([ea0, ea1, eb0, q]))
    return np.asarray(rows)


def _split(rows):
    return [rows[:, 3 * i:3 * i + 3] for i in range(rows.shape[1] // 3)]


def _pt_inputs_j(p, t0, t1, t2):
    n = jnp.cross(t1 - t0, t2 - t0)
    return jnp.stack([x for a, b in ((t0, t1), (t1, t2), (t2, t0))
                      for x in jnph._edge_param(p, a, b, n)])


def _pt_inputs_t(p, t0, t1, t2):
    n = tnph._cross(t1 - t0, t2 - t0)
    return torch.stack([x for a, b in ((t0, t1), (t1, t2), (t2, t0))
                        for x in tnph._edge_param(p, a, b, n)], -1)


def _ee_inputs(dot, cross, stack, ea0, ea1, eb0, eb1):
    """The quantities edge_edge_region compares, in its own expressions."""
    u, v, w = ea1 - ea0, eb1 - eb0, ea0 - eb0
    a, b, c, d, e = dot(u, u), dot(u, v), dot(v, v), dot(u, w), dot(v, w)
    cuv = cross(u, v)
    return stack([a, b, c, d, e, a * c - b * b, dot(cuv, cuv), b * e - c * d,
                  a * e - b * d, dot(eb0 - ea0, u), dot(eb1 - ea0, u)])


_EE_NAMES = ("a", "b", "c", "d", "e", "D", "cross_sq", "sN", "tN", "alpha", "beta")
_EE_FUSED = {"sN": (1, 4, 2, 3), "tN": (0, 4, 1, 3)}   # x*y - z*w operands


def _fused(x, y, z, w):
    """x*y - z*w with either product fused into one rounding (an FMA)."""
    return {float(Fraction(x) * Fraction(y) - Fraction(z * w)),
            float(Fraction(x * y) - Fraction(z) * Fraction(w))}


def _subnormal(*rows):
    """Rows with a nonzero value below the smallest normal: the values
    XLA:CPU flushes to zero."""
    tiny = np.finfo(np.float64).tiny
    x = np.concatenate([np.abs(r) for r in rows], axis=1)
    return np.any((x > 0.0) & (x < tiny), axis=1)


def test_region_boundaries_tie_break_matches_stark_tpu():
    """f64 rows exactly on the PT face/edge/vertex and EE region boundaries
    (and at the EE parallel cutoff), and 1-3 ulps either side, through both
    packages' classifiers. Wherever the values the classifiers compare are
    bit-equal, the regions are equal: the tie-break is the same. Every row
    whose region differs traces to JAX:CPU's own rounding of a compared
    value, which the port does not copy: a subnormal input or intermediate
    (XLA flushes them to zero), or XLA's FMA contraction of a*e - b*d or
    b*e - c*d (its value is the once-rounded fused result, the port's the
    twice-rounded one)."""
    rng = np.random.default_rng(0)
    P = _pt_boundary_rows(rng)
    E = _ee_boundary_rows(rng)
    Pj, Pt = [jnp.asarray(x) for x in _split(P)], [torch.as_tensor(x) for x in _split(P)]
    Ej, Et = [jnp.asarray(x) for x in _split(E)], [torch.as_tensor(x) for x in _split(E)]

    r_j = np.asarray(jax.jit(jax.vmap(jnph.point_triangle_region))(*Pj))
    r_t = tnph.point_triangle_region(*Pt).numpy()
    in_j = np.asarray(jax.jit(jax.vmap(_pt_inputs_j))(*Pj))
    in_t = _pt_inputs_t(*Pt).numpy()
    # the rows do sit on boundaries: their ulp moves change regions
    assert len(np.unique(r_t)) == 7
    assert np.any(r_t.reshape(-1, 21) != r_t.reshape(-1, 21)[:, :1])
    same = np.all(in_j == in_t, axis=1)
    assert np.array_equal(r_j[same], r_t[same])
    pt_diff = r_j != r_t
    assert np.all(_subnormal(P, in_t)[pt_diff])

    e_j = np.asarray(jax.jit(jax.vmap(lambda *a: jnph.edge_edge_region(*a)))(*Ej))
    e_t = tnph.edge_edge_region(*Et).numpy()
    in_j = np.asarray(jax.jit(jax.vmap(lambda *a: _ee_inputs(
        jnp.dot, jnp.cross, jnp.stack, *a)))(*Ej))
    in_t = _ee_inputs(tnph._dot, tnph._cross, lambda xs: torch.stack(xs, -1), *Et).numpy()
    assert len(np.unique(e_t)) == 9
    same = np.all(in_j == in_t, axis=1)
    assert np.array_equal(e_j[same], e_t[same])
    ftz = _subnormal(E, in_t)
    n_fma = 0
    for i in np.nonzero((e_j != e_t) & ~ftz)[0]:
        for k, name in enumerate(_EE_NAMES):
            if in_j[i, k] != in_t[i, k]:
                assert name in _EE_FUSED, (i, name)
                x, y, z, w = (in_j[i, m] for m in _EE_FUSED[name])
                assert in_j[i, k] in _fused(x, y, z, w), (i, name)
                assert in_t[i, k] == x * y - z * w, (i, name)
        n_fma += 1
    # the parallel-cutoff rows classify alike
    par = np.arange(len(E)).reshape(24, -1)[:, -3 * 41:].reshape(-1)
    assert np.array_equal(e_j[par], e_t[par])
    assert n_fma > 0 and np.any(pt_diff), "no row exercised JAX:CPU's rounding"
