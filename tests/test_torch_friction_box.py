"""The slice as a whole: bench.py's spinning_box_cloth with Coulomb friction
mu = 1.0 between the cloth and the box and of the cloth with itself, through
the port against `stark_tpu` on the CPU (the friction tables built inside
the fused solve: kernels I, E and J by their twins)."""
import math
from importlib import import_module

import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _friction_box(pkg, n, cpu, mu=1.0):
    P = import_module(pkg.__name__ + ".presets.presets")
    C = import_module(pkg.__name__ + ".models.interactions.contact")
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = "float64"
    if cpu:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (n, n), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    cloth.contact.set_friction(box.contact, mu)
    cloth.contact.set_friction(cloth.contact, mu)
    sim.add_time_event(0.0, 10.0, lambda t: fix.set_transformation(
        [0.0, 0.0, -0.08 - 0.1 * math.sin(t)], angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0]))
    return sim, cloth


def test_spinning_box_cloth_friction_8_tracks_stark_tpu():
    """The scene at 8x8, f64, seven steps of 1/30 s through first contact:
    the same solver codes and Newton counts on every step, cloth vertices
    within 1e-6 m, the same barrier stiffness, and live friction rows from
    first contact on."""
    js, jc = _friction_box(stark_tpu, 8, False)
    ts, tc = _friction_box(stark_tpu_torch, 8, True)
    fric = []
    for step in range(7):
        assert js.run_one_time_step()
        assert ts.run_one_time_step()
        lj, lt = js.get_logger(), ts.get_logger()
        assert lt.series["solver_code"][-1] == lj.series["solver_code"][-1], step
        assert lt.series["newton_iterations"][-1] == lj.series["newton_iterations"][-1], step
        dev = np.max(np.abs(np.asarray(jc.point_set.get_positions())
                            - tc.point_set.get_positions()))
        assert dev < 1e-6, f"step {step}: deviation {dev:.3e}"
        assert abs(ts.interactions.contact.contact_stiffness
                   - js.interactions.contact.contact_stiffness) < 1e-9
        counts = ts.stark.newton._last_counts
        fric.append(sum(v for k, v in counts.items() if k in ("f_pt", "f_ee")))
        jcounts = js.stark.newton._last_counts
        for k, v in jcounts.items():
            if k.startswith("f_"):
                assert counts[k] == v, (step, k)
    assert fric[0] == 0 and fric[-1] > 0
