"""The port's cloth slice against `stark_tpu` and the reference golden.

Both packages build the same scenes from the same settings; per-element
energies, gradients and Hessians are compared on the JAX package's frozen
tables carried across with `utils/from_jax.py`, then a PCG solve, then whole
time steps. All of it runs on the CPU in float64, where the port's kernels
take their plain twins.
"""
import gzip
import os
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, hessian, vmap

import stark_tpu
import stark_tpu_torch
from stark_tpu.solver import assembly as jas
from stark_tpu.solver import pcg as jpcg
from stark_tpu.solver import project as jproj
from stark_tpu_torch.solver import assembly as tas
from stark_tpu_torch.solver import pcg as tpcg
from stark_tpu_torch.solver import project as tproj
from stark_tpu_torch.utils.from_jax import state_from_numpy, tables_from_numpy

RTOL = 1e-10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "hanging_cloth_16.txt.gz")


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _mods(pkg):
    e = import_module(pkg.__name__ + ".models.deformables.energies")
    p = import_module(pkg.__name__ + ".presets.presets")
    return e, p


def _settings(pkg, cpu, dt=1 / 60):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    s.simulation.max_time_step_size = dt
    s.newton.residual_tolerance_abs = 1e-6
    if cpu:
        s.device.device = "cpu"
    return s


def _cloth(pkg, n, variant="flat", cpu=False, size=0.3, dt=1 / 60):
    e, p = _mods(pkg)
    sim = pkg.Simulation(_settings(pkg, cpu, dt))
    params = p.SurfaceParams.Cotton_Fabric()
    if variant == "full":
        # the full discrete-shells family and the elasticity-only strain
        params.bending.flat_rest_angle = False
        params.bending.stiffness = 1e-3
        params.bending.damping = 1e-4
        params.strain.elasticity_only = True
        params.strain.inflation = 0.5
    h = sim.presets.deformables.add_surface_grid("", (size, size), (n, n), params)
    sim.deformables.prescribed_positions.add(h.point_set, [0, n],
                                             e.PrescribedPositionsParams())
    return sim, h


def _carry(jsim):
    """The JAX simulation's frozen tables and glob, as the port's tensors."""
    jdata = jsim._get_static_data()
    jglob = jsim._get_glob()
    tables = tables_from_numpy(
        {k: {"conn": np.asarray(fd["conn"]),
             "rows": {r: np.asarray(v) for r, v in fd["rows"].items()}}
         for k, fd in jdata.items()})
    glob = {"dt": torch.tensor(float(jglob["dt"]), dtype=torch.float64),
            "gravity": torch.as_tensor(np.asarray(jglob["gravity"]))}
    glob.update(state_from_numpy(np.asarray(jglob["x0"]), np.asarray(jglob["v0"]),
                                 np.asarray(jglob["X"])))
    return jdata, jglob, tables, glob


@pytest.mark.parametrize("variant", ["flat", "full"])
def test_family_energy_grad_hess_match_jax(variant):
    """Per-family element E, g and H (torch.func vs jax autodiff) on the
    same tables, at a random deformed state."""
    js, _ = _cloth(stark_tpu, 4, variant)
    ts, _ = _cloth(stark_tpu_torch, 4, variant, cpu=True)
    js.stark._initialize()
    ts.stark._initialize()
    jdata, jglob, tdata, tglob = _carry(js)
    jfam = {f.name: f for f in js.stark.global_potential.families}
    tfam = {f.name: f for f in ts.stark.global_potential.families}
    rng = np.random.default_rng(1)
    n_blocks = ts.stark.newton.n_blocks
    u = rng.normal(0.0, 0.5, (n_blocks, 3))
    names = sorted(jdata)
    assert names == sorted(tdata)
    expected = {"EnergyLumpedInertia", "EnergyPrescribedPositions"} | (
        {"EnergyTriangleStrain", "EnergyBendingFlat"} if variant == "flat"
        else {"EnergyTriangleStrain_ElasticityOnly", "EnergyDiscreteShells"})
    assert set(names) == expected
    for name in names:
        fj, ft = jfam[name].energy_fn, tfam[name].energy_fn
        uj = jnp.asarray(u)[jdata[name]["conn"]]
        ut = torch.as_tensor(u)[tdata[name]["conn"]]
        (e_j, g_j), H_j = jax.jit(lambda u_, r_, g_: (
            jax.vmap(jax.value_and_grad(fj), in_axes=(0, 0, None))(u_, r_, g_),
            jax.vmap(jax.hessian(fj), in_axes=(0, 0, None))(u_, r_, g_)))(
                uj, jdata[name]["rows"], jglob)
        g_t, e_t = vmap(grad_and_value(ft), in_dims=(0, 0, None))(
            ut, tdata[name]["rows"], tglob)
        H_t = vmap(hessian(ft), in_dims=(0, 0, None))(ut, tdata[name]["rows"], tglob)
        act = np.asarray(jdata[name]["rows"]["active"]) > 0.5
        assert _rel(e_t.numpy()[act], np.asarray(e_j)[act]) < RTOL, name
        assert _rel(g_t.numpy()[act], np.asarray(g_j)[act]) < RTOL, name
        assert _rel(H_t.numpy()[act], np.asarray(H_j)[act]) < RTOL, name


def test_solve_pcg_matches_jax():
    """One block-Jacobi PCG solve of a projected cloth Hessian: the same x
    and the same iteration count as the JAX loop."""
    js, _ = _cloth(stark_tpu, 5)
    ts, _ = _cloth(stark_tpu_torch, 5, cpu=True)
    js.stark._initialize()
    ts.stark._initialize()
    jdata, jglob, tdata, tglob = _carry(js)
    jev, tev = js.stark.newton._ev, ts.stark.newton._ev
    topo = tev.topology(tdata, dense=False)
    u = np.random.default_rng(2).normal(0.0, 0.3, (tev.n_blocks, 3))
    _, _, g_j, h_j = jax.jit(jev.energy_grad_hess)(jnp.asarray(u), jdata, jglob)
    _, _, g_t, h_t = tev.energy_grad_hess(torch.as_tensor(u), tdata, tglob, topo)
    stat, _ = jev.split_dyn(h_j.keys())
    hp_j, _ = jax.jit(jproj.project_all, static_argnums=(1, 2))(
        {k: h_j[k] for k in stat}, 1e-10, False)
    cl, Hl, _v, _c = jev.live_select(jev.dyn_conn_cat(jdata), jev.dyn_hess_cat(h_j), 8)
    cj, Hj = jev.cat_with_live(jev.cat_static_conn(jdata), hp_j, cl, Hl)
    hp_t, _ = tproj.project_all({k: h_t[k] for k in stat}, 1e-10, False)
    _ct, Ht = tev.cat_with_live(topo.conn_cat, hp_t)
    Di_j = jas.precondition_inverse(jev.diag_bucket(cj, Hj))
    Di_t = tas.precondition_inverse(tev.diag_bucket(Ht, topo))
    rows = jev.scatter_rows(cj)
    res_j = jpcg.solve_pcg(lambda p: jev.hvp_bucket(p, cj, Hj, rows),
                           lambda r: jas.apply_preconditioner(Di_j, r),
                           -g_j, 1e-14, 1e-6, 10000, True)
    res_t = tpcg.solve_pcg(lambda p: tev.hvp_bucket(p, Ht, topo),
                           lambda r: tas.apply_preconditioner(Di_t, r),
                           -g_t, 1e-14, 1e-6, 10000, True)
    assert int(res_j.n_iterations) == res_t.n_iterations > 3
    assert bool(res_j.converged) and bool(res_t.converged)
    assert _rel(res_t.x, res_j.x) < RTOL


def test_hanging_cloth_8x8_tracks_stark_tpu():
    """Ten f64 time steps of the 8x8 hanging cloth: the same solver codes
    and vertex positions within 1e-6 m of the JAX package."""
    js, jh = _cloth(stark_tpu, 8)
    ts, th = _cloth(stark_tpu_torch, 8, cpu=True)
    worst = 0.0
    for _ in range(10):
        assert js.run_one_time_step()
        assert ts.run_one_time_step()
        xj = np.asarray(jh.point_set.get_positions())
        xt = th.point_set.get_positions()
        worst = max(worst, float(np.max(np.abs(xt - xj))))
    assert worst <= 1e-6, worst
    # same outcome codes, Newton counts and projected-Hessian ratios (the
    # port skips the empty live pool; n_hess/n_proj must not notice)
    for key in ("solver_code", "newton_iterations", "projected_hessians_ratio"):
        assert ts.get_logger().series[key] == js.get_logger().series[key], key
    assert np.mean(xt[:, 2]) < -0.01


def test_hanging_cloth():
    """Port of tests/test_newton_cloth.py::test_hanging_cloth."""
    e, p = _mods(stark_tpu_torch)
    sim = stark_tpu_torch.Simulation(_settings(stark_tpu_torch, cpu=True))
    h = sim.presets.deformables.add_surface_grid("", (0.3, 0.3), (6, 6),
                                                 p.SurfaceParams.Cotton_Fabric())
    pos = h.point_set.get_positions()
    corners = [int(np.argmin(np.linalg.norm(pos - np.array([-0.15, 0.15, 0.0]), axis=1))),
               int(np.argmin(np.linalg.norm(pos - np.array([0.15, 0.15, 0.0]), axis=1)))]
    sim.deformables.prescribed_positions.add(h.point_set, corners,
                                             e.PrescribedPositionsParams())
    ok = sim.run(duration=0.5)
    assert ok
    x = h.point_set.get_positions()
    assert np.all(np.isfinite(x))
    free = np.setdiff1d(np.arange(len(x)), corners)
    assert np.mean(x[free, 2]) < -0.02
    assert np.linalg.norm(x[corners[0]] - pos[corners[0]]) < 2e-3
    assert np.min(x[:, 2]) > -0.5 * 9.81 * 0.5 ** 2


def test_settings_match_outside_the_device_section():
    a = stark_tpu.Settings().as_string()
    b = stark_tpu_torch.Settings().as_string()
    assert a.split("device:")[0] == b.split("device:")[0]
    dev = stark_tpu_torch.Settings().device
    assert (dev.device, dev.dtype, dev.jacobi_sweeps) == ("cuda", "float64", None)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """The default device is cuda; without a card the port raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = stark_tpu_torch.Settings()
    s.simulation.init_frictional_contact = False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stark_tpu_torch.Simulation(s)


def test_unported_paths_raise():
    """Every path of the JAX package's models runs on the port now: the
    rigid bodies (P2), contact (P3), friction (P4), the joints (P6), the
    rods and volumes (P7), the attachments (P8) and the frame output (P10)
    are the ported objects, and no NotImplementedError naming P8 or P10 is
    left in the port."""
    import re

    from stark_tpu_torch.models.deformables.output import DeformablesMeshOutput
    from stark_tpu_torch.models.interactions.attachments import EnergyAttachments
    from stark_tpu_torch.models.rigidbodies.rigidbodies import RigidBodiesMeshOutput

    contact_on = stark_tpu_torch.Settings()
    contact_on.device.device = "cpu"
    assert contact_on.simulation.init_frictional_contact
    sim = stark_tpu_torch.Simulation(contact_on)
    assert sim.interactions.contact is not None
    assert sim.rigidbodies is not None
    assert isinstance(sim.interactions.attachments, EnergyAttachments)
    a = sim.rigidbodies.add(1.0, np.eye(3))
    b = sim.rigidbodies.add(1.0, np.eye(3))
    hinge = sim.rigidbodies.add_constraint_hinge(a, b, [0, 0, 0], [0, 0, 1])
    assert hinge.get_point().get_idx() == 0 and hinge.get_direction_lock().get_idx() == 0
    sim = stark_tpu_torch.Simulation(_settings(stark_tpu_torch, cpu=True))
    assert sim.deformables.tet_strain is not None
    assert sim.deformables.segment_strain is not None
    assert isinstance(sim.deformables.output, DeformablesMeshOutput)
    assert isinstance(sim.rigidbodies.output, RigidBodiesMeshOutput)
    pkg = os.path.dirname(stark_tpu_torch.__file__)
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for m in re.finditer(r"NotImplementedError\(([^)]*)\)", text):
                    assert not re.search(r"\bP(8|10)\b", m.group(1)), (f, m.group(0))


def test_mesh_tables_match_jax():
    """Grid generator and bending stencils (the JAX package builds its
    stencils natively; the port in numpy, in the same row order)."""
    from stark_tpu.utils import mesh_generators as jg, mesh_utils as jm
    from stark_tpu_torch.utils import mesh_generators as tg, mesh_utils as tm

    Vj, Tj = jg.generate_triangle_grid((0.0, 0.0), (1.0, 0.5), (7, 4))
    Vt, Tt = tg.generate_triangle_grid((0.0, 0.0), (1.0, 0.5), (7, 4))
    np.testing.assert_array_equal(Vt, Vj)
    np.testing.assert_array_equal(Tt, Tj)
    np.testing.assert_array_equal(tm.find_internal_angles(Tt, len(Vt)),
                                  jm.find_internal_angles(Tj, len(Vj)))
    np.testing.assert_array_equal(tm.find_edges_from_simplices(Tt, len(Vt)),
                                  jm.find_edges_from_simplices(Tj, len(Vj)))


def _load_golden(path):
    steps = []
    with gzip.open(path, "rt") as f:
        cur = None
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("step"):
                cur = []
                steps.append(cur)
            else:
                cur.append([float(v) for v in line.split()])
    return [np.asarray(s) for s in steps]


@pytest.mark.slow
def test_hanging_cloth_16_matches_reference():
    """tests/test_trajectory_parity.py's golden scene through the port."""
    golden = _load_golden(GOLDEN)
    assert len(golden) == 30
    e, p = _mods(stark_tpu_torch)
    s = _settings(stark_tpu_torch, cpu=True, dt=1.0 / 30.0)
    s.device.dtype = "float64"
    s.simulation.use_adaptive_time_step = False
    s.newton.residual_tolerance_abs = None
    sim = stark_tpu_torch.Simulation(s)
    n, d = 16, 1.0
    hd = d / 2.0
    H = sim.presets.deformables.add_surface_grid(
        "cloth", (d, d), (n, n), p.SurfaceParams.Cotton_Fabric())
    bc = e.PrescribedPositionsParams().set_stiffness(1e6)
    sim.deformables.prescribed_positions.add_inside_aabb(
        H.point_set, (hd, hd, 0.0), (0.001, 0.001, 0.001), bc)
    sim.deformables.prescribed_positions.add_inside_aabb(
        H.point_set, (-hd, hd, 0.0), (0.001, 0.001, 0.001), bc)
    worst = 0.0
    for step in range(30):
        assert sim.run_one_time_step()
        x = H.point_set.get_positions()
        worst = max(worst, float(np.max(np.linalg.norm(x - golden[step], axis=1))))
    assert worst < 2e-3, worst
