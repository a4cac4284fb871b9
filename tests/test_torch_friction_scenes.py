"""Friction scenes of the JAX package's tests, through the port on the CPU:
tests/test_contact.py::test_friction_stick_on_incline (rigid-rigid friction,
the pt_rr and ee_rr families) and tests/test_solver_modes.py::
test_log_barrier_and_c1_friction (the Log barrier's normal force and the C1
stick-slide transition), both at longer time steps than the JAX package's
(the port's CPU path is slower per step) with their checks; and the
rebuild of the solve when set_friction turns friction on or off between
steps."""
import numpy as np
import pytest
import torch

import stark_tpu_torch
from stark_tpu_torch import maths
from stark_tpu_torch.models.interactions.contact import IPCBarrierType, IPCFrictionType
from stark_tpu_torch.presets.presets import SurfaceParams


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(name, dt):
    s = stark_tpu_torch.Settings()
    s.output.simulation_name = name
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = "cpu"
    s.simulation.max_time_step_size = dt
    s.newton.residual_tolerance_abs = 1e-5
    return s


def test_friction_stick_on_incline():
    """A box with mu = 0.8 on a 15 degree incline sticks (C0 friction lets
    it creep below the stick-slide velocity); without friction it slides
    down. Time steps of 1/20 s for 0.3 s (the JAX test: 1/100 s for
    0.4 s)."""
    def run(mu):
        sim = stark_tpu_torch.Simulation(_settings("incline", 1 / 20))
        contact = sim.interactions.contact
        contact.global_params.default_contact_thickness = 0.002
        contact.global_params.min_contact_stiffness = 1e5
        contact.global_params.friction_stick_slide_threshold = 0.01
        contact.contact_stiffness = 1e5
        ramp = sim.presets.rigidbodies.add_box("", 10.0, (0.6, 0.6, 0.05))
        ramp.rigidbody.add_rotation(15.0, [0, 1, 0])
        sim.rigidbodies.add_constraint_fix(ramp.rigidbody)
        box = sim.presets.rigidbodies.add_box("", 1.0, (0.08, 0.08, 0.08))
        R = maths.axis_angle_rotation(np.deg2rad(15.0), [0, 1, 0])
        box.rigidbody.set_rotation(R=R)
        box.rigidbody.set_translation(R @ np.array([0.0, 0.0, 0.025 + 0.04 + 0.003]))
        if mu > 0:
            box.contact.set_friction(ramp.contact, mu)
        assert sim.run(duration=0.3)
        if mu > 0:
            counts = sim.stark.newton._last_counts
            assert counts["f_pt_rr"] > 0 and counts["f_ee_rr"] > 0
        return box.rigidbody.get_translation()

    t_stick = run(0.8)
    t_slide = run(0.0)
    assert t_slide[0] - t_stick[0] > 0.05, (t_stick, t_slide)
    assert abs(t_stick[0]) < 0.05, t_stick


def test_set_friction_between_steps_rebuilds_the_solve():
    """A cloth resting within dhat of a fixed box: a frictionless step, then
    set_friction (mu 1.0), then mu back to 0. Each flip rebuilds the fused
    solve with the friction count keys added or taken away, the step with
    friction counts live friction rows, and the steps around it none."""
    sim = stark_tpu_torch.Simulation(_settings("friction_flip", 1 / 30))
    contact = sim.interactions.contact
    contact.global_params.default_contact_thickness = 0.002
    box = sim.presets.rigidbodies.add_box("", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.0425])
    sim.rigidbodies.add_constraint_fix(box.rigidbody)
    cloth = sim.presets.deformables.add_surface_grid(
        "", (0.05, 0.05), (3, 3), SurfaceParams.Cotton_Fabric())
    out = []
    for mu in (0.0, 1.0, 0.0):
        cloth.contact.set_friction(box.contact, mu)
        assert sim.run_one_time_step()
        nm = sim.stark.newton
        f_keys = [k for k in nm._fused_count_keys if k.startswith("f_")]
        out.append((nm._fused, f_keys, nm.friction_rows()))
    (s0, k0, n0), (s1, k1, n1), (s2, k2, n2) = out
    assert s1 is not s0 and s2 is not s1
    assert not k0 and not k2 and {"f_pt", "f_pt_dr"} <= set(k1)
    assert n0 == 0 and n1 > 0 and n2 == 0
    assert np.all(np.isfinite(cloth.point_set.get_positions()))


def test_log_barrier_and_c1_friction():
    """A cloth with mu = 0.3 on a fixed box under the Log barrier and C1
    friction lands and rests on the box top, finite. Time steps of 1/30 s
    (the JAX test: 1/60 s)."""
    s = _settings("log_barrier", 1 / 30)
    sim = stark_tpu_torch.Simulation(s)
    contact = sim.interactions.contact
    contact.ipc_barrier_type = IPCBarrierType.Log
    contact.ipc_friction_type = IPCFrictionType.C1
    contact.global_params.default_contact_thickness = 0.002
    contact.global_params.min_contact_stiffness = 1e4
    contact.contact_stiffness = 1e4
    box = sim.presets.rigidbodies.add_box("", 1.0, (0.2, 0.2, 0.1))
    sim.rigidbodies.add_constraint_fix(box.rigidbody)
    cloth = sim.presets.deformables.add_surface_grid("", (0.12, 0.12), (3, 3),
                                                     SurfaceParams.Cotton_Fabric())
    cloth.contact.set_friction(box.contact, 0.3)
    pts = cloth.point_set
    x = pts.get_positions()
    x[:, 2] += 0.08
    sim._dyn._x0_host[pts.get_begin():pts.get_begin() + pts.size()] = x
    assert sim.run(duration=0.3)
    xf = pts.get_positions()
    assert np.all(np.isfinite(xf))
    assert np.min(xf[:, 2]) > 0.05 - 0.002
    assert sim.stark.newton._last_counts["f_pt_dr"] > 0
