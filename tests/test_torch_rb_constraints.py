"""The joint scenes of tests/test_rb_constraints.py on the port (P6: kernels
T and U's families): the ten scenes other than inertia, global point and
global direction (those are in tests/test_torch_rigid.py), each with the
JAX suite's force balance, built by stark_tpu_torch/tools/rb_scenes.py
(which chip_smoke.py's phase 22 runs on the card).

The JAX suite solves them with the staged DirectLLT solver, 1500 steps of
2 ms. The default tier runs them through the port's fused BDPCG solve at
10 ms steps for 0.5 s (the distance limits for 1 s: their box bounces on
its one-sided limit for ~0.8 s at 10 ms); the slow tier runs them as JAX
does, on the port's staged DirectLLT solver at 2 ms for 3 s.
"""
import numpy as np
import pytest
import torch

import stark_tpu_torch
from stark_tpu.models.rigidbodies import inertia_tensors as jit_tensors
from stark_tpu_torch.tools import rb_scenes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scenes_are_the_jax_suites():
    """The module's mass, perturbation and box inertia are the JAX suite's
    (tests/test_rb_constraints.py:16-18, :36-37)."""
    rng = np.random.default_rng(1234)
    assert rb_scenes.MASS == float(rng.uniform(0.0, 100.0))
    assert rb_scenes.PERTURBATION == float(rng.uniform(0.0, 100.0)) + 10.0
    sim = stark_tpu_torch.Simulation(rb_scenes.settings("box", device="cpu"))
    b = rb_scenes.box(sim)
    np.testing.assert_array_equal(
        b.get_local_inertia_tensor(),
        jit_tensors.inertia_tensor_box(rb_scenes.MASS, (0.1, 0.1, 0.1)))
    assert b.get_mass() == rb_scenes.MASS


def _hold(scene, direct):
    sim, ok, checks = rb_scenes.run(scene, device="cpu", direct=direct)
    assert ok, scene
    for label, value, limit in checks:
        assert value < limit, (scene, label, value, limit)
    return sim


@pytest.mark.parametrize("scene", sorted(rb_scenes.SCENES))
def test_rb_constraints(scene):
    """The scene of tests/test_rb_constraints.py::test_<scene> on the
    port's fused solver at 10 ms for 0.5 s (distance limits: 1 s), with its
    force balance."""
    sim = _hold(scene, direct=False)
    assert sim.stark.newton._fused_eligible()


@pytest.mark.slow
@pytest.mark.parametrize("scene", sorted(rb_scenes.SCENES))
def test_rb_constraints_on_direct_llt(scene):
    """The scenes as tests/test_rb_constraints.py runs them: DirectLLT (the
    staged solver), 1500 steps of 2 ms, the same force balances."""
    sim = _hold(scene, direct=True)
    assert not sim.stark.newton._fused_eligible()
    assert abs(sim.get_time() - 3.0) < 0.01
