"""The slice as a whole: bench.py's spinning_box_cloth (a cloth falling on a
fixed, sinking and turning rigid box, frictionless IPC contact) through the
port against `stark_tpu` on the CPU, and against the reference C++
trajectory."""
import gzip
import math
import os
from importlib import import_module

import numpy as np
import pytest

import stark_tpu
import stark_tpu_torch

GOLDEN_SBC = os.path.join(os.path.dirname(__file__), "golden",
                          "spinning_box_cloth_16.txt.gz")


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _settings(pkg, cpu, dtype="float64", dt=1 / 30):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = dtype
    s.simulation.max_time_step_size = dt
    if cpu:
        s.device.device = "cpu"
    return s


def _spinning_box(pkg, n, cpu, dtype="float64", adaptive=True):
    P = import_module(pkg.__name__ + ".presets.presets")
    C = import_module(pkg.__name__ + ".models.interactions.contact")
    s = _settings(pkg, cpu, dtype)
    s.simulation.use_adaptive_time_step = adaptive
    sim = pkg.Simulation(s)
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (n, n), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)

    def spin(t):
        fix.set_transformation([0.0, 0.0, -0.08 - 0.1 * math.sin(t)],
                               angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0])

    return sim, cloth, box, spin


def test_spinning_box_cloth_8_tracks_stark_tpu():
    """bench.py's scene at 8x8, f64, six steps of 1/30 s through first
    contact (step 2): the same solver codes and Newton counts on every step,
    cloth vertices within 1e-6 m, the same rigid state and the same barrier
    stiffness."""
    js, jc, jb, jspin = _spinning_box(stark_tpu, 8, False)
    ts, tc, tb, tspin = _spinning_box(stark_tpu_torch, 8, True)
    js.add_time_event(0.0, 10.0, jspin)
    ts.add_time_event(0.0, 10.0, tspin)
    live = []
    for step in range(6):
        assert js.run_one_time_step()
        assert ts.run_one_time_step()
        lj, lt = js.get_logger(), ts.get_logger()
        assert lt.series["solver_code"][-1] == lj.series["solver_code"][-1], step
        assert lt.series["newton_iterations"][-1] == lj.series["newton_iterations"][-1], step
        dev = np.max(np.abs(np.asarray(jc.point_set.get_positions())
                            - tc.point_set.get_positions()))
        assert dev < 1e-6, f"step {step}: deviation {dev:.3e}"
        assert _rel(tb.rigidbody.get_translation(), jb.rigidbody.get_translation()) < 1e-12
        assert abs(ts.interactions.contact.contact_stiffness
                   - js.interactions.contact.contact_stiffness) < 1e-9
        live.append(ts.stark.newton.live_contact_pairs())
    assert live[0] == 0 and max(live) > 0


def _load_golden(path):
    steps, cur = [], None
    with gzip.open(path, "rt") as f:
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
def test_spinning_box_cloth_16_matches_reference():
    """Port of tests/test_trajectory_parity.py::
    test_spinning_box_cloth_16_matches_reference: the reference C++
    trajectory, f64, fixed 1/30 s steps, with its bounds (5e-4 for steps
    0-1, 2e-3 for step 2, 1e-1 after)."""
    golden = _load_golden(GOLDEN_SBC)
    assert len(golden) == 25
    sim, cloth, _box, spin = _spinning_box(stark_tpu_torch, 16, True, adaptive=False)
    for step in range(len(golden)):
        spin(sim.get_time())
        assert sim.run_one_time_step()
        dev = float(np.max(np.linalg.norm(cloth.point_set.get_positions()
                                          - golden[step], axis=1)))
        bound = 5e-4 if step < 2 else 2e-3 if step < 3 else 1e-1
        assert dev < bound, f"step {step}: max vertex deviation {dev:.3e}"
