"""Volumetric soft bodies through the port against `stark_tpu` on the CPU:
tet strain (kernel S's twin and its g++ build), the volume presets (their
surface registered for contact through `point_set_map`), and soft boxes
with friction on a rigid floor (kernel Q's twins in the fused solve).

The 2x2x2 falling soft box of tests/test_newton_cloth.py::
test_falling_soft_box_quasistatic_off runs in float64 with the same solver
codes and Newton counts on every step, vertices within 1e-8 m of the JAX
package and its free-fall check; the volume scene of tests/
test_derivatives.py::test_fd_volume_energies passes the port's
finite-difference check (tools/fd_check.py) through the twins and through
the kernels' element math; and upstream's deformable_and_rigid_collisions
at n1 = 2, n2 = 1 with mu = 1 lands on the port with live friction rows,
on which kernel Q's element math matches its twins (and, in the slow tier,
tracks the JAX package through first contact, fused and staged).
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu_torch.tools.fd_check import fd_check


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(pkg, dt=1 / 60, contact=False):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = contact
    s.simulation.max_time_step_size = dt
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    return s


def _track(js, ts, jx, tx, steps, tol=1e-8, counts=False,
           keys=("solver_code", "newton_iterations")):
    """Step both simulations: equal logger series `keys` per step (codes and
    Newton counts of the fused solve), and the friction count keys with
    `counts`; returns the worst vertex deviation."""
    worst = 0.0
    for step in range(steps):
        assert js.run_one_time_step() and ts.run_one_time_step(), step
        lj, lt = js.get_logger(), ts.get_logger()
        for key in keys:
            assert lt.series[key][-1] == lj.series[key][-1], (step, key)
        if counts:
            jc, tc = js.stark.newton._last_counts, ts.stark.newton._last_counts
            for k, v in jc.items():
                if k.startswith("f_"):
                    assert int(tc[k]) == int(v), (step, k)
        worst = max(worst, float(np.max(np.abs(np.asarray(jx()) - tx()))))
    assert worst <= tol, worst
    return worst


def _falling_box(pkg):
    P = import_module(pkg.__name__ + ".presets.presets")
    s = _settings(pkg)
    s.newton.residual_tolerance_abs = 1e-6
    sim = pkg.Simulation(s)
    h = sim.presets.deformables.add_volume_grid("", (0.1, 0.1, 0.1), (2, 2, 2),
                                                P.VolumeParams.Soft_Rubber())
    return sim, h


def test_falling_soft_box_tracks_stark_tpu():
    """The 2x2x2 Soft_Rubber box for 0.2 s (12 steps of 1/60 s), f64: equal
    codes and Newton counts, vertices within 1e-8 m, and the JAX test's
    free-fall check (the centre drops 0.5 g t^2 within 25% + 5 mm)."""
    js, jh = _falling_box(stark_tpu)
    ts, th = _falling_box(stark_tpu_torch)
    fams = {f.name for f in ts.stark.global_potential.families}
    assert {"EnergyTetStrain", "EnergyTetStrain_ElasticityOnly"} <= fams
    _track(js, ts, jh.point_set.get_positions, th.point_set.get_positions, 12)
    x = th.point_set.get_positions()
    drop = -np.mean(x[:, 2])
    expect = 0.5 * 9.81 * ts.get_time() ** 2
    assert abs(drop - expect) < 0.25 * expect + 5e-3, (drop, expect)


@pytest.mark.parametrize("host", [False, True])
def test_fd_volume_energies(host):
    """tests/test_derivatives.py::test_fd_volume_energies through the port
    (strain limit 0.02 and damping 1.0, both live at the perturbed
    iterate): gradient and Hessian-vector product against central
    differences, by the twins and by the g++ build of kernel S's element
    math."""
    P = import_module("stark_tpu_torch.presets.presets")
    sim = stark_tpu_torch.Simulation(_settings(stark_tpu_torch, dt=0.01))
    p = P.VolumeParams.Soft_Rubber()
    p.strain.strain_limit = 0.02
    p.strain.damping = 1.0
    sim.presets.deformables.add_volume_grid("", (0.2, 0.2, 0.2), (2, 2, 2), p)
    err = fd_check(sim, host=host)
    assert err["grad"] < 2e-5 and err["hvp"] < 5e-4


def _soft_boxes(pkg, n1=2, n2=1, mu=1.0):
    """Upstream's deformable_and_rigid_collisions (repo-root examples/
    scenes.py:214-246) at n1, n2 in f64; stark_tpu_torch/tools/scenes.py
    builds the same scene for the card."""
    P = import_module(pkg.__name__ + ".presets.presets")
    C = import_module(pkg.__name__ + ".models.interactions.contact")
    sim = pkg.Simulation(_settings(pkg, dt=1 / 30, contact=True))
    sim.interactions.contact.set_global_params(
        C.ContactGlobalParams().set_friction_stick_slide_threshold(0.01)
        .set_min_contact_stiffness(1e8).set_default_contact_thickness(0.001))
    d1, d2, gap = 0.25, 0.1, 0.01
    rubber = P.VolumeParams.Soft_Rubber()
    rubber.contact.contact_thickness = 0.001 * d1
    rubber.inertia.density = 1e3
    h1 = sim.presets.deformables.add_volume_grid("boxes", (d1,) * 3, (n1,) * 3, rubber)
    h1.point_set.add_displacement((0, 0, 0.5 * d1 + gap))
    rubber2 = P.VolumeParams.Soft_Rubber()
    rubber2.contact.contact_thickness = 0.001 * d2
    rubber2.inertia.density = 1e4
    rubber2.strain.youngs_modulus = 1e5
    h2 = sim.presets.deformables.add_volume_grid("boxes", (d2,) * 3, (n2,) * 3, rubber2)
    h2.point_set.add_displacement((0.13 * d2, 0.07 * d2, d1 + 0.5 * d2 + 2 * gap))
    d3 = 2.0
    floor = sim.presets.rigidbodies.add_box(
        "floor", 1.0, (d3, d3, 0.05 * d3), C.ContactParams().set_contact_thickness(0.001 * d3))
    floor.rigidbody.set_translation((0, 0, -0.025 * d3))
    sim.rigidbodies.add_constraint_fix(floor.rigidbody)
    c = sim.interactions.contact
    c.set_friction(floor.contact, h1.contact, mu)
    c.set_friction(floor.contact, h2.contact, mu)
    c.set_friction(h1.contact, h2.contact, mu)

    def x():
        return np.concatenate([np.asarray(h1.point_set.get_positions()),
                               np.asarray(h2.point_set.get_positions())])

    return sim, x


def test_volume_contact_mesh_matches_jax():
    """add_volume registers the surface only, through point_set_map: the
    engines' soft points, edges and triangles equal the JAX package's."""
    js, _ = _soft_boxes(stark_tpu)
    ts, _ = _soft_boxes(stark_tpu_torch)
    js.stark._initialize()
    ts.stark._initialize()
    jeng = js.interactions.contact._engine
    teng = ts.interactions.contact.engine()
    assert teng.n_sv == 26 + 8 and teng.n_ts == 48 + 12
    for key in ("sv_gid", "sv_mesh", "es", "ts", "tr", "er", "rv_body"):
        np.testing.assert_array_equal(getattr(teng, key), getattr(jeng, key), key)


def test_soft_boxes_with_friction_on_the_port():
    """The port alone (JAX's compile of this scene takes ~100 s; the
    comparison with it is the slow test below): four steps of
    deformable_and_rigid_collisions at n1 = 2, n2 = 1, mu = 1, f64, fused
    solver; the lower box lands and stays above the floor, friction rows
    are live on the floor (pt_dr, ee_dr), and at the final step start kernel
    Q's element math (its g++ build) matches the twins on the engine's
    friction tables within 1e-10, C0 and C1."""
    from stark_tpu_torch.ops import egh
    from stark_tpu_torch.tools.egh_cases import f64_err, per_elem_err

    ts, tx = _soft_boxes(stark_tpu_torch)
    for step in range(4):
        assert ts.run_one_time_step(), step
    x = tx()
    assert np.all(np.isfinite(x))
    assert x[:27, 2].min() > -1e-3 and x[:27, 2].min() < 0.01
    counts = ts.stark.newton._last_counts
    assert counts["f_pt_dr"] > 0 and counts["f_ee_dr"] > 0, counts
    model = ts.interactions.contact
    eng = model.engine()
    eglob = eng.glob_entries()
    Vs0, Vr0 = eng.step_start_world(eng.engine_state())
    fric, _cnt = eng.friction_tables(Vs0, Vr0, eng.th_vec(), eglob["mu_mat"],
                                     eglob["contact_k"])
    glob = ts._get_glob()
    u = ts._get_dofs()
    fams = {f.name: f for f in ts.stark.global_potential.families}
    live = 0
    for ftype in ("C0", "C1"):
        model.ipc_friction_type = ftype
        for name, fd in fric.items():
            fam = fams[name]
            twin = egh.plain(fam.energy_fn, u, fd["conn"], fd["rows"], glob)
            kern = fam.kernel(u, fd["conn"], fd["rows"], glob, True, host=True)
            for part, k, t in zip("egH", kern, twin):
                err = f64_err(k, t, "e") if part == "e" else per_elem_err(k, t)
                assert err <= 1e-10, (ftype, name, part, err)
            live += int((fd["rows"]["active"] > 0.5).sum())
    assert live > 0


@pytest.mark.slow
def test_soft_boxes_with_friction_track_stark_tpu():
    """deformable_and_rigid_collisions at n1 = 2, n2 = 1, mu = 1 on all
    three pairs, f64, four steps of 1/30 s through the fused solver: equal
    codes, Newton counts and friction counts (f_) per step, vertices within
    1e-8 m, and live friction rows once the lower box lands."""
    js, jx = _soft_boxes(stark_tpu)
    ts, tx = _soft_boxes(stark_tpu_torch)
    _track(js, ts, jx, tx, 4, counts=True)
    counts = ts.stark.newton._last_counts
    assert sum(int(v) for k, v in counts.items() if k in ("f_pt", "f_ee")) > 0, counts


@pytest.mark.slow
def test_soft_boxes_with_friction_staged_track_stark_tpu(monkeypatch):
    """The same scene and steps through both packages' staged solvers
    (which log no solver code): equal Newton counts and line-search counts
    per step, vertices within 1e-8 m."""
    monkeypatch.setenv("STARK_TPU_NO_FUSED", "1")
    monkeypatch.setenv("STARK_TPU_TORCH_NO_FUSED", "1")
    js, jx = _soft_boxes(stark_tpu)
    ts, tx = _soft_boxes(stark_tpu_torch)
    _track(js, ts, jx, tx, 4, keys=("newton_iterations", "ls_inv", "ls_bt"))
