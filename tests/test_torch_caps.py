"""Capacity overflow in the fused contact solve: a step whose lists (contact
or friction) outgrow their capacities is solved again from the same state
with the bumped capacities, and its result equals that of a run that
started the step with them (stark_tpu/solver/newton.py:340-388)."""
import math

import numpy as np
import pytest
import torch

import stark_tpu_torch as stt
from stark_tpu_torch.models.interactions.contact import ContactGlobalParams
from stark_tpu_torch.presets.presets import SurfaceParams


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = {"w_pt": 16, "m_pt": 16, "w_ee": 16, "m_ee": 16, "pt_dd": 4,
         "pt_dr": 4, "ee_dd": 4, "ee_dr": 4}


def _scene(broad_phase="auto"):
    s = stt.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = "cpu"
    s.simulation.max_time_step_size = 1 / 30
    s.simulation.use_adaptive_time_step = False
    sim = stt.Simulation(s)
    gp = ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    sim.interactions.contact.broad_phase = broad_phase
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (6, 6), SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    sim.add_time_event(0.0, 10.0, lambda t: fix.set_transformation(
        [0.0, 0.0, -0.08 - 0.1 * math.sin(t)], angle_deg=90.0 * t,
        axis=[0.0, 0.0, 1.0]))
    return sim, cloth


def _step(sim, cloth):
    assert sim.run_one_time_step()
    lg = sim.get_logger()
    return (cloth.point_set.get_positions().copy(), lg.series["solver_code"][-1],
            lg.series["newton_iterations"][-1])


def test_overflow_resolve_equals_run_with_bumped_caps():
    """The first contact step (step 2) starts with tiny list and pool
    capacities, overflows, is bumped and solved again; a second run starts
    that step with the capacities the first one ended with. Both give the
    same positions, solver code and Newton count, bit for bit, and so does
    the next step."""
    a, ca = _scene()
    b, cb = _scene()
    for _ in range(2):
        assert np.array_equal(_step(a, ca)[0], _step(b, cb)[0])
    eng_a = a.interactions.contact.engine()
    eng_a.set_caps(SMALL)
    a.stark.newton._pool_cap = 8
    out_a = [_step(a, ca)]
    retraces = a.get_logger().get_int("fused_retraces")
    assert retraces >= 1
    assert a.stark.newton.live_contact_pairs() > 0

    b.interactions.contact.engine().set_caps(dict(eng_a._caps))
    b.stark.newton._pool_cap = a.stark.newton._pool_cap
    out_b = [_step(b, cb)]
    assert b.get_logger().get_int("fused_retraces") == 0
    out_a.append(_step(a, ca))
    out_b.append(_step(b, cb))
    for (xa, code_a, it_a), (xb, code_b, it_b) in zip(out_a, out_b):
        assert code_a == code_b and it_a == it_b
        assert np.array_equal(xa, xb)


SMALL_G = {"c_pt_dd": 2, "c_pt_dr": 2, "c_ee_dd": 2, "c_ee_dr": 2,
           "g_pt_dd_occ": 2, "g_ee_dd_occ": 2, "g_ee_dr_occ": 2, "g_pt_dd_ins": 2,
           "g_ee_dd_ins": 2, "m_pt_dr": 4, "m_ee_dr": 4, "i_ss": 2,
           "g_i_ss_occ": 2}


def test_grid_overflow_resolve_equals_run_with_bumped_caps():
    """The same on the hash-grid path (broad_phase "grid"): candidate row
    slots (c_), bucket-scan lengths and insertion slots (g_..._occ,
    g_..._ins), mid segments and oracle rows start tiny at the first
    contact step, overflow, are bumped and the step is solved again; a run
    that starts the step with the bumped capacities gives the same
    positions, code and Newton count, bit for bit."""
    a, ca = _scene("grid")
    b, cb = _scene("grid")
    for _ in range(2):
        assert np.array_equal(_step(a, ca)[0], _step(b, cb)[0])
    eng_a = a.interactions.contact.engine()
    eng_a.set_caps(SMALL_G)
    xa, code_a, it_a = _step(a, ca)
    assert a.get_logger().get_int("fused_retraces") >= 1
    bumped = {k for k, v in SMALL_G.items() if eng_a._caps[k] > v}
    assert {"c_pt_dr", "g_ee_dd_occ", "g_pt_dd_ins"} <= bumped, bumped
    assert a.stark.newton.live_contact_pairs() > 0
    b.interactions.contact.engine().set_caps(dict(eng_a._caps))
    b.stark.newton._pool_cap = a.stark.newton._pool_cap
    xb, code_b, it_b = _step(b, cb)
    assert b.get_logger().get_int("fused_retraces") == 0
    assert code_a == code_b and it_a == it_b
    assert np.array_equal(xa, xb)


SMALL_F = {"f_pt": 4, "f_ee": 4, "f_pt_dd": 4, "f_pt_dr": 4, "f_pt_rd": 4,
           "f_ee_dd": 4, "f_ee_dr": 4}


def _friction_scene():
    """A 4x4 cloth 2.5 mm above the top of a fixed box, mu = 1 between them
    and of the cloth with itself: friction rows from the first step on."""
    s = stt.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = "cpu"
    s.simulation.max_time_step_size = 1 / 30
    s.simulation.use_adaptive_time_step = False
    sim = stt.Simulation(s)
    gp = ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.06, 0.06), (4, 4), SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.0425])
    sim.rigidbodies.add_constraint_fix(box.rigidbody)
    cloth.contact.set_friction(box.contact, 1.0)
    cloth.contact.set_friction(cloth.contact, 1.0)
    sim.stark._initialize()
    return sim, cloth


def test_friction_overflow_resolve_equals_run_with_bumped_caps():
    """The friction tables of the first step start with capacity 4, overflow,
    are bumped and the step is solved again; a second run starts the step
    with the capacities the first one ended with. Both give the same
    positions, solver code, Newton count and friction counts, bit for
    bit."""
    a, ca = _friction_scene()
    eng_a = a.interactions.contact.engine()
    eng_a.set_caps(SMALL_F)
    xa, code_a, it_a = _step(a, ca)
    assert a.get_logger().get_int("fused_retraces") >= 1
    assert eng_a._caps["f_pt_dr"] > 4 and a.stark.newton._last_counts["f_pt_dr"] > 4
    b, cb = _friction_scene()
    b.interactions.contact.engine().set_caps(dict(eng_a._caps))
    b.stark.newton._pool_cap = a.stark.newton._pool_cap
    xb, code_b, it_b = _step(b, cb)
    assert b.get_logger().get_int("fused_retraces") == 0
    assert code_a == code_b and it_a == it_b
    assert np.array_equal(xa, xb)
    assert a.stark.newton._last_counts == b.stark.newton._last_counts
