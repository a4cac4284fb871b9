"""The joint scenes of the reference's rb_constraints suite (tests/
test_rb_constraints.py in the repository; rb_constraints.cpp:16-277) on the
port, with their force balances, for the CPU tests and `chip_smoke.py`.

Each scene holds a 0.1 m box of mass MASS, fixed, and a second one joined
to it by one constraint kind, under a perturbation force or torque, gravity
off; it runs to steady state and reads the constraint's analytic force
balance from its handler: the violation within its tolerance and the
constraint's force within 1e-3 of the perturbation. `run(name, ...)`
returns the simulation and its checks, (label, value, limit) triples, each
holding where value < limit.

The reference runs them on DirectLLT at 2 ms for 3 s (`direct=True`); the
fused default takes 10 ms steps for 0.5 s, past the settling of the penalty
springs (implicit Euler damps their ~100 rad/s modes within a few steps).
The distance limits' box falls 1 cm onto its one-sided limit and bounces,
which at 10 ms takes ~0.8 s to settle, so those scenes run for 1 s.
"""
from __future__ import annotations

import numpy as np

_rng = np.random.default_rng(1234)
MASS = float(_rng.uniform(0.0, 100.0))
PERTURBATION = float(_rng.uniform(0.0, 100.0)) + 10.0


def settings(name: str, dtype: str = "float64", device: str = "cuda",
             direct: bool = False, seconds: float = 0.5):
    """The fused default (10 ms for `seconds`) or, with direct, the
    reference's DirectLLT at 2 ms for 3 s."""
    from stark_tpu_torch import Settings
    from stark_tpu_torch.core.settings import LinearSolver

    s = Settings()
    s.output.simulation_name = name
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = device
    s.device.dtype = dtype
    s.execution.end_simulation_time = 3.0 if direct else seconds
    s.simulation.gravity = (0.0, 0.0, 0.0)
    s.simulation.init_frictional_contact = False
    s.simulation.max_time_step_size = 0.002 if direct else 0.01
    if direct:
        s.newton.linear_solver = LinearSolver.DirectLLT
    s.newton.residual_tolerance_abs = 1e-6
    s.newton.step_tolerance = 0.0
    return s


def box(sim):
    from stark_tpu_torch.models.rigidbodies.inertia_tensors import inertia_tensor_box

    return sim.rigidbodies.add(MASS, inertia_tensor_box(MASS, (0.1, 0.1, 0.1)))


def two_boxes(name, at, dtype="float64", device="cuda", direct=False, seconds=0.5):
    """A fixed box at the origin and a free one at `at`."""
    from stark_tpu_torch import Simulation

    sim = Simulation(settings(name, dtype, device, direct, seconds))
    box0 = box(sim)
    sim.rigidbodies.add_constraint_fix(box0)
    return sim, box0, box(sim).set_translation(at)


def _rel(value, ref):
    return abs(value - ref) / abs(ref)


def _point(**kw):
    sim, box0, box1 = two_boxes("point", [0.1, 0.0, 0.0], **kw)
    c = sim.rigidbodies.add_constraint_point(box0, box1, [0.05, 0.0, 0.0])
    box1.add_force_at_centroid([PERTURBATION, 0, 0])
    ok = sim.run()
    C, f = c.get_violation_in_m_and_force()
    return sim, ok, [("|C| m", abs(C), c.get_tolerance_in_m()),
                     ("force rel", _rel(f, PERTURBATION), 1e-3)]


def _point_on_axis(**kw):
    sim, box0, box1 = two_boxes("point_on_axis", [0.1, 0.0, 0.0], **kw)
    c = sim.rigidbodies.add_constraint_point_on_axis(box0, box1, [0.0, 0.0, 0.0],
                                                     [0.0, 0.0, 1.0])
    box1.add_force_at_centroid([PERTURBATION, 0, 0])
    ok = sim.run()
    C, f = c.get_violation_in_m_and_force()
    return sim, ok, [("|C| m", abs(C), c.get_tolerance_in_m()),
                     ("force rel", _rel(f, PERTURBATION), 1e-3)]


def _distance(**kw):
    sim, box0, box1 = two_boxes("distance", [1.0, 0.0, 0.0], **kw)
    c = sim.rigidbodies.add_constraint_distance(box0, box1, box0.get_translation(),
                                                box1.get_translation())
    box1.add_force_at_centroid([PERTURBATION, 0, 0])
    ok = sim.run()
    C, f = c.get_signed_violation_in_m_and_force()
    return sim, ok, [("|C| m", abs(C), c.get_tolerance_in_m()),
                     ("force rel", _rel(f, -PERTURBATION), 1e-3)]


def _distance_limits(sign, **kw):
    if not kw.get("direct"):
        kw["seconds"] = 1.0
    sim, box0, box1 = two_boxes("distance_limits", [1.0, 0.0, 0.0], **kw)
    c = sim.rigidbodies.add_constraint_distance_limits(
        box0, box1, box0.get_translation(), box1.get_translation(), 0.99, 1.01)
    box1.add_force_at_centroid([sign * PERTURBATION, 0, 0])
    ok = sim.run()
    C, f = c.get_signed_violation_in_m_and_force()
    return sim, ok, [("|C| m", abs(C), c.get_tolerance_in_m()),
                     ("force rel", _rel(f, -sign * PERTURBATION), 1e-3)]


def _direction(**kw):
    sim, box0, box1 = two_boxes("direction", [0.0, 0.0, 0.1], **kw)
    c = sim.rigidbodies.add_constraint_direction(box0, box1, [0.0, 0.0, 1.0])
    box1.add_torque([PERTURBATION, 0, 0])
    ok = sim.run()
    C, t = c.get_violation_in_deg_and_torque()
    return sim, ok, [("|C| deg", abs(C), c.get_tolerance_in_deg()),
                     ("torque rel", _rel(t, PERTURBATION), 1e-3)]


def _angle_limit(**kw):
    sim, box0, box1 = two_boxes("angle_limit", [0.0, 0.0, 0.1], **kw)
    c = sim.rigidbodies.add_constraint_angle_limit(box0, box1, [0.0, 0.0, 1.0], 25.0)
    box1.add_torque([PERTURBATION, 0, 0])
    ok = sim.run()
    C, t = c.get_violation_in_deg_and_torque()
    return sim, ok, [("|C| deg", abs(C), c.get_tolerance_in_deg()),
                     ("torque rel", _rel(t, PERTURBATION), 1e-3)]


def _spring(**kw):
    stiffness, perturbation, damping = 1000.0, 1.0, 1.0
    sim, box0, box1 = two_boxes("spring", [0.2, 0.0, 0.0], **kw)
    c = sim.rigidbodies.add_constraint_spring(box0, box1, box0.get_translation(),
                                              box1.get_translation(), stiffness, damping)
    box1.add_force_at_centroid([perturbation, 0, 0])
    ok = sim.run()
    dC, df = c.get_signed_damper_velocity_and_force()
    C, f = c.get_signed_spring_displacement_in_m_and_force()
    return sim, ok, [("damper |-dC c - f|", abs(-dC * damping - df), 1e-3),
                     ("spring rel", abs(-C * stiffness - f) / max(abs(f), 1e-12), 1e-3)]


def _linear_velocity(**kw):
    max_force, target_v, delay = 50.0, 3.7, 0.01
    sim, box0, box1 = two_boxes("linear_velocity", [0.1, 0.0, 0.0], **kw)
    ball_joint = sim.rigidbodies.add_constraint_point(box0, box1, [0.05, 0.0, 0.0])
    c = sim.rigidbodies.add_constraint_linear_velocity(box0, box1, [1.0, 0.0, 0.0], target_v,
                                                       max_force, delay)
    ok = sim.run()
    _bC, bf = ball_joint.get_violation_in_m_and_force()
    _C, f = c.get_signed_velocity_violation_and_force()
    return sim, ok, [("balance rel", abs(f - (-bf)) / max(abs(bf), 1e-12), 1e-3),
                     ("cap rel", _rel(bf, max_force), 1e-3)]


def _angular_velocity(**kw):
    max_torque, perturbation, delay = 10.0, 1.7, 0.01
    sim, box0, box1 = two_boxes("angular_velocity", [0.1, 0.0, 0.0], **kw)
    attachment = sim.rigidbodies.add_constraint_attachment(box0, box1)
    c = sim.rigidbodies.add_constraint_angular_velocity(box0, box1, [1.0, 0.0, 0.0],
                                                        perturbation, max_torque, delay)
    ok = sim.run()
    _bC, bf = attachment.get_z_lock().get_violation_in_deg_and_torque()
    _C, f = c.get_signed_angular_velocity_violation_in_deg_per_s_and_torque()
    return sim, ok, [("balance rel", abs(f - (-bf)) / max(abs(bf), 1e-12), 1e-3),
                     ("cap rel", _rel(bf, max_torque), 1e-3)]


SCENES = {
    "point": _point, "point_on_axis": _point_on_axis, "distance": _distance,
    "distance_limits_max": lambda **kw: _distance_limits(1.0, **kw),
    "distance_limits_min": lambda **kw: _distance_limits(-1.0, **kw),
    "direction": _direction, "angle_limit": _angle_limit, "spring": _spring,
    "linear_velocity": _linear_velocity, "angular_velocity": _angular_velocity,
}


def run(name: str, dtype: str = "float64", device: str = "cuda", direct: bool = False):
    """Build and run scene `name`: (sim, ok, checks), ok the run's result,
    checks (label, value, limit) triples that hold where value < limit."""
    return SCENES[name](dtype=dtype, device=device, direct=direct)


def hinge(dtype: str = "float64", device: str = "cuda", direct: bool = True):
    """A hinge (a point and a direction, kernels T and U) holding the free
    box at (0.05, 0, 0) about z, under the perturbation force along x and a
    torque about x: the point carries the force and the direction lock the
    torque. Not run to the end: the caller steps it. Returns (sim, hinge)."""
    sim, box0, box1 = two_boxes("hinge", [0.1, 0.0, 0.0], dtype, device, direct)
    h = sim.rigidbodies.add_constraint_hinge(box0, box1, [0.05, 0.0, 0.0], [0.0, 0.0, 1.0])
    box1.add_force_at_centroid([PERTURBATION, 0, 0])
    box1.add_torque([PERTURBATION, 0, 0])
    return sim, h
