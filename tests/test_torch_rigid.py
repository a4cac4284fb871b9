"""The port's rigid bodies: quaternion kinematics, inertia and the fix
joint's constraints against `stark_tpu`, and the constraint force balances
of tests/test_rb_constraints.py run through the port.

The JAX suite solves those scenes with the staged DirectLLT solver, 1500
steps of 2 ms. The default tier runs them through the port's fused BDPCG
solve at 10 ms steps for 0.5 s, past the settling of the penalty spring
(implicit Euler damps its ~140 rad/s mode within a few steps), and holds the
same force balance to the same 1e-3; the slow tier runs them as JAX does,
on the port's staged DirectLLT solver at 2 ms for 3 s.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, hessian, vmap

import stark_tpu
import stark_tpu_torch
from stark_tpu import maths as jm
from stark_tpu_torch import maths as tm
from stark_tpu_torch.tools import rb_scenes
from stark_tpu_torch.utils import mesh_utils
from stark_tpu_torch.utils.from_jax import tables_from_numpy

RTOL = 1e-10
MASS, PERTURBATION = rb_scenes.MASS, rb_scenes.PERTURBATION


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_quaternion_kinematics_match_jax(rng):
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.normal(size=(20, 3))
    for qi, wi in zip(q, w):
        Rj = np.asarray(jm.quat_integration_rotation(jnp.asarray(qi), jnp.asarray(wi), 0.03))
        Rt = tm.quat_integration_rotation(torch.as_tensor(qi), torch.as_tensor(wi), 0.03)
        assert _rel(Rt, Rj) < 1e-14
        np.testing.assert_allclose(tm.np_quat_time_integration(qi, wi, 0.03),
                                   jm.np_quat_time_integration(qi, wi, 0.03), rtol=1e-15)
        R = jm.np_quat_to_rotation(qi)
        np.testing.assert_allclose(tm.rotation_to_quat(R), jm.rotation_to_quat(R),
                                   rtol=1e-13, atol=1e-14)


def test_rcm_order_matches_the_native_ordering():
    """The port's numpy RCM gives the JAX package's box vertex order."""
    from stark_tpu import native
    from stark_tpu_torch.utils import mesh_generators as tg

    V, T = tg.make_box(0.08)
    edges = mesh_utils.find_edges_from_simplices(T, len(V))
    ref = native.rcm_order(edges, len(V))
    if ref is None:
        pytest.skip("the JAX package's native library is not available")
    np.testing.assert_array_equal(mesh_utils.rcm_order(edges, len(V)), ref)


def _box_scene(pkg, cpu):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    if cpu:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    h = sim.presets.rigidbodies.add_box("box", 2.0, (0.1, 0.2, 0.3)).rigidbody
    h.add_rotation(30.0, [1.0, 1.0, 0.0])
    h.set_translation([0.1, -0.2, 0.3])
    h.set_velocity([0.3, 0.1, -0.2])
    h.set_angular_velocity([1.0, -2.0, 0.5])
    fix = sim.rigidbodies.add_constraint_fix(h)
    fix.set_transformation([0.1, -0.15, 0.3], angle_deg=20.0, axis=[0.0, 1.0, 1.0])
    sim.stark._initialize()
    sim.stark.callbacks.run_before_time_step()
    return sim


def test_rigid_families_match_jax():
    """Inertia (linear, angular) and the fix joint's global point and
    global direction families: E, g and H per element (torch.func vs JAX
    autodiff) on the JAX package's frozen tables and rigid state."""
    js = _box_scene(stark_tpu, False)
    ts = _box_scene(stark_tpu_torch, True)
    jdata = js._get_static_data()
    jglob = js._get_glob()
    tdata = tables_from_numpy({k: {"conn": np.asarray(fd["conn"]),
                                   "rows": {r: np.asarray(v) for r, v in fd["rows"].items()}}
                               for k, fd in jdata.items()})
    tglob = ts._get_glob()
    for k in ("rb_t0", "rb_q0", "rb_v0", "rb_w0", "rb_J0glob"):
        assert _rel(tglob[k], np.asarray(jglob[k])) < 1e-15, k
    names = {"EnergyRigidBodyInertia_Linear", "EnergyRigidBodyInertia_Angular",
             "rb_constraint_global_points", "rb_constraint_global_directions"}
    assert names == set(jdata) == set(ts._get_static_data())
    jfam = {f.name: f for f in js.stark.global_potential.families}
    tfam = {f.name: f for f in ts.stark.global_potential.families}
    u = np.random.default_rng(2).normal(0.0, 0.7, (2, 3))
    for name in sorted(names):
        fj, ft = jfam[name].energy_fn, tfam[name].energy_fn
        uj = jnp.asarray(u)[jdata[name]["conn"]]
        ut = torch.as_tensor(u)[tdata[name]["conn"]]
        e_j, g_j = jax.vmap(jax.value_and_grad(fj), in_axes=(0, 0, None))(
            uj, jdata[name]["rows"], jglob)
        H_j = jax.vmap(jax.hessian(fj), in_axes=(0, 0, None))(uj, jdata[name]["rows"], jglob)
        g_t, e_t = vmap(grad_and_value(ft), in_dims=(0, 0, None))(ut, tdata[name]["rows"], tglob)
        H_t = vmap(hessian(ft), in_dims=(0, 0, None))(ut, tdata[name]["rows"], tglob)
        act = np.asarray(jdata[name]["rows"]["active"]) > 0.5
        assert _rel(e_t.numpy()[act], np.asarray(e_j)[act]) < RTOL, name
        assert _rel(g_t.numpy()[act], np.asarray(g_j)[act]) < RTOL, name
        assert _rel(H_t.numpy()[act], np.asarray(H_j)[act]) < RTOL, name


def test_rigid_step_tracks_stark_tpu():
    """Eight f64 steps of a fixed box whose target moves and turns: the same
    solver codes and Newton counts, and the same rigid state."""
    def run(pkg, cpu):
        s = pkg.Settings()
        s.output.enable_output = False
        s.output.enable_frame_writes = False
        s.simulation.init_frictional_contact = False
        s.newton.residual_tolerance_abs = 1e-8
        if cpu:
            s.device.device = "cpu"
        sim = pkg.Simulation(s)
        h = sim.presets.rigidbodies.add_box("box", 1.0, 0.08).rigidbody
        h.add_translation([0.0, 0.0, -0.08])
        fix = sim.rigidbodies.add_constraint_fix(h)
        out = []
        for _ in range(8):
            t = sim.get_time()
            fix.set_transformation([0.0, 0.0, -0.08 - 0.1 * math.sin(t)],
                                   angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0])
            assert sim.run_one_time_step()
            out.append(np.concatenate([h.get_translation(), h.get_quaternion()]))
        lg = sim.get_logger()
        return np.asarray(out), lg.series["solver_code"], lg.series["newton_iterations"]

    xj, cj, nj = run(stark_tpu, False)
    xt, ct, nt = run(stark_tpu_torch, True)
    assert cj == ct and nj == nt
    assert np.max(np.abs(xt - xj)) < 1e-9


def _inertia(direct):
    s = rb_scenes.settings("inertia", device="cpu", direct=direct)
    s.simulation.gravity = (PERTURBATION, 0.0, 0.0)
    sim = stark_tpu_torch.Simulation(s)
    box0 = rb_scenes.box(sim)
    constraint = sim.rigidbodies.add_constraint_global_point(box0, box0.get_translation())
    assert sim.run()
    C, f = constraint.get_violation_in_m_and_force()
    assert abs(C) < constraint.get_tolerance_in_m()
    assert abs(f - PERTURBATION * MASS) / (PERTURBATION * MASS) < 1e-3
    return sim


def _global_point(direct):
    sim = stark_tpu_torch.Simulation(rb_scenes.settings("global_point", device="cpu", direct=direct))
    box0 = rb_scenes.box(sim)
    constraint = sim.rigidbodies.add_constraint_global_point(box0, box0.get_translation())
    box0.set_force([PERTURBATION, 0, 0])
    assert sim.run()
    C, f = constraint.get_violation_in_m_and_force()
    assert abs(C) < constraint.get_tolerance_in_m()
    assert abs(f - PERTURBATION) / PERTURBATION < 1e-3
    return sim


def _global_direction(direct):
    sim = stark_tpu_torch.Simulation(rb_scenes.settings("global_direction", device="cpu",
                                                                direct=direct))
    box0 = rb_scenes.box(sim)
    constraint = sim.rigidbodies.add_constraint_global_direction(box0, [0.0, 0.0, 1.0])
    box0.set_torque([PERTURBATION, 0, 0])
    assert sim.run()
    C, t = constraint.get_violation_in_deg_and_torque()
    assert abs(C) < constraint.get_tolerance_in_deg()
    assert abs(t - PERTURBATION) / PERTURBATION < 1e-3
    return sim


def test_inertia():
    """Port of tests/test_rb_constraints.py::test_inertia."""
    _inertia(direct=False)


def test_global_point():
    """Port of tests/test_rb_constraints.py::test_global_point."""
    _global_point(direct=False)


def test_global_direction():
    """Port of tests/test_rb_constraints.py::test_global_direction."""
    _global_direction(direct=False)


@pytest.mark.slow
@pytest.mark.parametrize("scene", [_inertia, _global_point, _global_direction],
                         ids=["inertia", "global_point", "global_direction"])
def test_rb_constraints_on_direct_llt(scene):
    """The three scenes as tests/test_rb_constraints.py runs them: DirectLLT
    (the staged solver), 1500 steps of 2 ms, the same force balances."""
    sim = scene(direct=True)
    assert not sim.stark.newton._fused_eligible()
    assert abs(sim.get_time() - 3.0) < 0.01


def test_unported_rigid_paths_raise():
    """The joints (P6) are ported: a hinge returns its handler; so are the
    attachments (P8), whose rb-d form glues a point to the box, and the
    rigid mesh output (P10)."""
    from stark_tpu_torch.models.interactions.attachments import (RBD, AttachmentHandler,
                                                                  EnergyAttachments)
    from stark_tpu_torch.models.rigidbodies.rigidbodies import RigidBodiesMeshOutput

    sim = stark_tpu_torch.Simulation(rb_scenes.settings("unported", device="cpu"))
    a, b = rb_scenes.box(sim), rb_scenes.box(sim)
    hinge = sim.rigidbodies.add_constraint_hinge(a, b, [0, 0, 0], [0, 0, 1])
    assert hinge.get_point().is_enabled() and hinge.get_direction_lock().is_enabled()
    assert isinstance(sim.interactions.attachments, EnergyAttachments)
    assert isinstance(sim.rigidbodies.output, RigidBodiesMeshOutput)
    p = sim.deformables.point_sets.add(np.array([[0.0, 0.0, 0.1]]))
    h = sim.interactions.attachments.add_rb_point(a, p, [0])
    assert isinstance(h, AttachmentHandler) and h.kind == RBD
