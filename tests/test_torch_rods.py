"""Rods through the port against `stark_tpu` on the CPU: segment strain
(kernel R's twin and its g++ build), the line presets and edge-only contact
meshes (`contact.add_edges`).

The hanging rod of tests/test_newton_cloth.py::test_hanging_rod runs in
float64 with the same solver codes and Newton counts on every step and
vertices within 1e-8 m of the JAX package; the line scene of
tests/test_derivatives.py::test_fd_line_energies passes the port's
finite-difference check (tools/fd_check.py) through the twins and through
the kernels' element math; and a contact-on rod over a fixed box gives the
JAX engine's pair lists, contact tables and friction tables row for row.
"""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu_torch.tools.fd_check import fd_check
from stark_tpu_torch.utils.from_jax import set_contact_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(pkg):
    return (import_module(pkg.__name__ + ".presets.presets"),
            import_module(pkg.__name__ + ".models.deformables.energies"),
            import_module(pkg.__name__ + ".models.interactions.contact"))


def _settings(pkg, dt=1 / 60, contact=False):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = contact
    s.simulation.max_time_step_size = dt
    s.newton.residual_tolerance_abs = 1e-6
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    return s


def _hanging_rod(pkg):
    P, E, _C = _mods(pkg)
    sim = pkg.Simulation(_settings(pkg))
    h = sim.presets.deformables.add_line_as_segments(
        "", (0, 0, 0), (0, 0, -0.3), 10, P.LineParams.Elastic_Rubberband())
    sim.deformables.prescribed_positions.add(h.point_set, [0], E.PrescribedPositionsParams())
    return sim, h


def test_hanging_rod_tracks_stark_tpu():
    """tests/test_newton_cloth.py's hanging rod for 0.2 s (12 steps of 1/60
    s), f64: equal solver codes and Newton counts per step, vertices within
    1e-8 m, and the JAX test's length bound."""
    js, jh = _hanging_rod(stark_tpu)
    ts, th = _hanging_rod(stark_tpu_torch)
    fams = {f.name for f in ts.stark.global_potential.families}
    assert {"EnergySegmentStrain", "EnergySegmentStrain_ElasticityOnly"} <= fams
    worst = 0.0
    for step in range(12):
        assert js.run_one_time_step() and ts.run_one_time_step(), step
        lj, lt = js.get_logger(), ts.get_logger()
        for key in ("solver_code", "newton_iterations"):
            assert lt.series[key][-1] == lj.series[key][-1], (step, key)
        worst = max(worst, float(np.max(np.abs(np.asarray(jh.point_set.get_positions())
                                               - th.point_set.get_positions()))))
    assert worst <= 1e-8, worst
    x = th.point_set.get_positions()
    assert np.all(np.isfinite(x))
    length = np.sum(np.linalg.norm(np.diff(x, axis=0), axis=1))
    assert 0.3 <= length < 0.45, length
    assert x[-1, 2] < -0.3


@pytest.mark.parametrize("host", [False, True])
def test_fd_line_energies(host):
    """tests/test_derivatives.py::test_fd_line_energies through the port
    (strain limit 0.01, live at the perturbed iterate; damping 1e-4):
    gradient and Hessian-vector product against central differences, by
    the twins and by the g++ build of kernel R's element math."""
    P, _E, _C = _mods(stark_tpu_torch)
    s = _settings(stark_tpu_torch, dt=0.01)
    sim = stark_tpu_torch.Simulation(s)
    p = P.LineParams.Elastic_Rubberband()
    p.strain.strain_limit = 0.01
    sim.presets.deformables.add_line_as_segments("", (0, 0, 0), (0, 0, 1), 8, p)
    err = fd_check(sim, host=host)
    assert err["grad"] < 2e-5 and err["hvp"] < 5e-4


def _rod_over_box(pkg, mu=0.5):
    """A 6-segment rod (contact on, add_edges) lying 3 mm over the top of
    a fixed box turned 30 degrees, mu between rod and box: the rod's points
    over the box's faces (pt_dr) and its edges over the box's edges
    (ee_dr)."""
    P, _E, C = _mods(pkg)
    sim = pkg.Simulation(_settings(pkg, dt=1 / 30, contact=True))
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    rod = sim.presets.deformables.add_line_as_segments(
        "", (-0.06, -0.01, 0.0), (0.06, 0.012, 0.0), 6, P.LineParams.Elastic_Rubberband())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_rotation(30.0, [0.0, 0.0, 1.0])
    box.rigidbody.add_translation([0.01, -0.005, -0.043])
    sim.rigidbodies.add_constraint_fix(box.rigidbody)
    rod.contact.set_friction(box.contact, mu)
    sim.stark._initialize()
    return sim, rod


def _eq(t, j, what):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j), err_msg=what)


def _same_tables(tab_t, tab_j, what, rtol=0.0):
    assert sorted(tab_t) == sorted(tab_j), what
    for name, fd_j in tab_j.items():
        fd_t = tab_t[name]
        act = np.asarray(fd_j["rows"]["active"]) > 0.5
        _eq(fd_t["rows"]["active"], fd_j["rows"]["active"], f"{what} {name} active")
        _eq(fd_t["conn"][act], np.asarray(fd_j["conn"])[act], f"{what} {name} conn")
        assert sorted(fd_t["rows"]) == sorted(fd_j["rows"]), name
        for r, v in fd_j["rows"].items():
            v = np.asarray(v)[act]
            w = fd_t["rows"][r].numpy()[act]
            if np.issubdtype(v.dtype, np.integer) or rtol == 0.0:
                _eq(w, v, f"{what} {name} {r}")
            elif v.size:
                err = np.max(np.abs(w - v)) / max(np.max(np.abs(v)), 1e-300)
                assert err < rtol, f"{what} {name} {r}: {err:.3e}"


def test_rod_contact_state_matches_jax():
    """The edge-only contact mesh on one frozen state: the engine's static
    tables (no soft triangles), the broad shell's counts and mid lists, the
    pair shell's contact tables and the step's friction tables equal the
    JAX engine's row for row (the geometry of the friction rows within
    1e-12)."""
    js, _jr = _rod_over_box(stark_tpu)
    ts, _tr = _rod_over_box(stark_tpu_torch)
    jeng = js.interactions.contact._engine
    teng = ts.interactions.contact.engine()
    assert teng.n_ts == 0 and teng.n_es == 6 and teng.n_sv == 7
    for key in ("es", "er", "ts", "tr", "sv_gid", "rv_body"):
        _eq(getattr(teng, key), getattr(jeng, key), key)
    jc = js.interactions.contact
    set_contact_state(ts.interactions.contact, jc.contact_thicknesses,
                      jc.contact_stiffness, caps=dict(jeng._caps), pair_mu=jc.pair_mu)
    u = np.random.default_rng(7).normal(0.0, 0.02, (js.stark.newton.n_blocks, 3))
    dt = 1.0 / 30.0
    jVs, jVr = jeng.world_from_u(jnp.asarray(u), jeng.engine_state(), jnp.asarray(dt))
    tVs, tVr = teng.world_from_u(torch.as_tensor(u), teng.engine_state(),
                                 torch.as_tensor(dt, dtype=torch.float64))
    np.testing.assert_allclose(tVs.numpy(), np.asarray(jVs), rtol=0, atol=1e-15)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)
    slack_b, slack_p = 0.02, 0.002
    jth, tth = jeng._th_vec(), teng.th_vec()
    mc_j, _ic_j, cnt_j = jeng.broad_fn(jVs, jVr, jth, slack_b, slack_p)
    mc_t, _ic_t, cnt_t = teng.broad_fn(tVs, tVr, tth, f64(slack_b), f64(slack_p))
    assert sorted(cnt_t) == sorted(cnt_j)
    for k in cnt_j:
        assert int(cnt_t[k]) == int(cnt_j[k]), k
    for kind in ("pt", "ee"):
        for x, y, what in zip(mc_t[kind], mc_j[kind], ("q", "t", "act")):
            _eq(x, y, f"mid {kind} {what}")
    tab_j, pcnt_j = jeng.pairs_fn(jVs, jVr, jth, mc_j, slack_p)
    tab_t, pcnt_t = teng.pairs_fn(tVs, tVr, tth, mc_t, f64(slack_p))
    for k in pcnt_j:
        assert int(pcnt_t[k]) == int(pcnt_j[k]), k
    assert int(pcnt_j["pt_dr"]) > 0 and int(pcnt_j["ee_dr"]) > 0
    _same_tables(tab_t, tab_j, "contact")
    k = float(jc.contact_stiffness)
    fr_j, fc_j = jeng.friction_tables(jVs, jVr, jth, jeng._mu_mat(), jnp.asarray(k))
    fr_t, fc_t = teng.friction_tables(tVs, tVr, tth, teng._mu_mat(), f64(k))
    for key, c in fc_j.items():
        assert int(fc_t[key]) == int(c), key
    assert int(fc_j["f_pt_dr"]) > 0 and int(fc_j["f_ee_dr"]) > 0
    _same_tables(fr_t, fr_j, "friction", rtol=1e-12)
