"""The rigid joints (P6: kernels T and U's families) through the port against
`stark_tpu` on the CPU.

Every constraint factory of stark_tpu/models/rigidbodies/joints.py builds
the same containers on the port (the frozen tables row for row, derived
joints included); at the joint chain's frozen state each family's twin and
the g++ build of kernels T and U agree with jax.hessian within 1e-10 in
float64; `tools.scenes.rigid_joint_chain` (three bodies on a fix, a point,
a hinge, a distance and its limits, an angle limit, a spring, both velocity
controllers and a point on an axis) tracks the JAX package for 8 fused
steps; tests/test_derivatives.py::test_fd_rigid_constraints' scene passes
the port's finite-difference check; and a compact simple_grasp (the f32
gate's n = 3 scene) closes its fingers on the cube with live friction rows
(the slow tier tracks the JAX package there). The force balances of
tests/test_rb_constraints.py's joint scenes are in
tests/test_torch_rb_constraints.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu.models.rigidbodies.inertia_tensors import inertia_tensor_box
from stark_tpu_torch.ops import egh
from stark_tpu_torch.tools.egh_cases import per_elem_err
from stark_tpu_torch.tools.fd_check import fd_check
from stark_tpu_torch.utils.from_jax import tables_from_numpy

TOL = 1e-10
JOINT_FAMILIES = {"rb_constraint_points", "rb_constraint_point_on_axis",
                  "rb_constraint_distances", "rb_constraint_distance_limits",
                  "rb_constraint_directions", "rb_constraint_angle_limits",
                  "rb_constraint_damped_spring", "rb_constraint_linear_velocity",
                  "rb_constraint_angular_velocity"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_settings(pkg, dt=0.01):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    s.simulation.max_time_step_size = dt
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    return s


def _chain(pkg):
    """tests/test_derivatives.py::test_fd_rigid_constraints' three bodies;
    stark_tpu_torch/tools/scenes.py `rigid_joint_chain` builds the same."""
    sim = pkg.Simulation(_plain_settings(pkg))
    rbs = sim.rigidbodies
    b0 = rbs.add(1.0, inertia_tensor_box(1.0, 0.1))
    b1 = rbs.add(2.0, inertia_tensor_box(2.0, 0.1))
    b1.set_translation([0.3, 0, 0])
    b2 = rbs.add(1.5, inertia_tensor_box(1.5, 0.1))
    b2.set_translation([0.6, 0, 0])
    rbs.add_constraint_fix(b0)
    rbs.add_constraint_point(b0, b1, [0.15, 0, 0])
    rbs.add_constraint_hinge(b1, b2, [0.45, 0, 0], [0, 0, 1])
    rbs.add_constraint_distance(b0, b2, [0, 0, 0], [0.6, 0, 0])
    rbs.add_constraint_distance_limits(b0, b2, [0, 0, 0], [0.6, 0, 0], 0.5, 0.7)
    rbs.add_constraint_angle_limit(b1, b2, [0, 0, 1], 10.0)
    rbs.add_constraint_spring(b0, b2, [0, 0, 0], [0.6, 0, 0], 100.0, 1.0)
    rbs.add_constraint_linear_velocity(b0, b1, [1, 0, 0], 0.5, 10.0)
    rbs.add_constraint_angular_velocity(b1, b2, [0, 0, 1], 0.5, 10.0)
    rbs.add_constraint_point_on_axis(b0, b1, [0.0, 0, 0], [0, 0, 1])
    return sim, (b0, b1, b2)


def _every_factory(pkg):
    """Five bodies, each primitive factory and each derived joint once."""
    sim = pkg.Simulation(_plain_settings(pkg))
    rbs = sim.rigidbodies
    b = [rbs.add(1.0 + k, inertia_tensor_box(1.0 + k, 0.1)) for k in range(5)]
    for k, body in enumerate(b):
        body.set_translation([0.2 * k, 0.05 * k, -0.1 * k])
        body.add_rotation(17.0 * k, [1.0, k, 0.5])
    p, d = [0.1, 0.02, -0.05], [0.3, 1.0, 0.2]
    rbs.add_constraint_global_point(b[0], p)
    rbs.add_constraint_global_direction(b[0], d)
    rbs.add_constraint_point(b[0], b[1], p)
    rbs.add_constraint_point_on_axis(b[0], b[1], p, d)
    rbs.add_constraint_distance(b[1], b[2], p, [0.3, 0.1, 0.0])
    rbs.add_constraint_distance_limits(b[1], b[2], p, [0.3, 0.1, 0.0], 0.1, 0.4)
    rbs.add_constraint_direction(b[2], b[3], d)
    rbs.add_constraint_angle_limit(b[2], b[3], d, 30.0)
    rbs.add_constraint_spring(b[3], b[4], p, [0.5, 0.2, -0.3], 100.0, 2.0)
    rbs.add_constraint_linear_velocity(b[0], b[4], d, 0.3, 20.0, 0.02)
    rbs.add_constraint_angular_velocity(b[1], b[3], d, -0.4, 5.0)
    rbs.add_constraint_fix(b[4])
    rbs.add_constraint_attachment(b[0], b[2])
    rbs.add_constraint_point_with_angle_limit(b[1], b[4], p, d, 25.0)
    rbs.add_constraint_hinge(b[2], b[4], p, d)
    rbs.add_constraint_hinge_with_angle_limit(b[3], b[0], p, [1.0, 0.1, 0.0], 40.0)
    rbs.add_constraint_slider(b[1], b[2], p, d)
    rbs.add_constraint_prismatic_slider(b[2], b[3], p, [1.0, 0.0, 0.0])
    rbs.add_constraint_spring_with_limits(b[0], b[3], p, [0.4, 0.0, 0.1], 50.0, 0.1, 0.6,
                                          1.0)
    rbs.add_constraint_prismatic_press(b[4], b[1], p, d, 1.0, 5.0)
    rbs.add_constraint_motor(b[0], b[1], p, d, 2.0, 3.0)
    sim.stark._initialize()
    return sim


def test_every_factory_matches_stark_tpu_rows():
    """The frozen tables of every container (conn from the providers,
    base_rows' columns) equal the JAX package's, row for row."""
    jd = _every_factory(stark_tpu)._get_static_data()
    td = _every_factory(stark_tpu_torch)._get_static_data()
    names = {n for n in jd if n.startswith("rb_constraint_")}
    assert names == {n for n in td if n.startswith("rb_constraint_")}
    assert JOINT_FAMILIES | {"rb_constraint_global_points",
                             "rb_constraint_global_directions"} == names
    for name in names:
        np.testing.assert_array_equal(td[name]["conn"].numpy(), np.asarray(jd[name]["conn"]))
        assert set(td[name]["rows"]) == set(jd[name]["rows"]), name
        for k, v in jd[name]["rows"].items():
            np.testing.assert_array_equal(td[name]["rows"][k].numpy(), np.asarray(v),
                                          err_msg=f"{name}[{k}]")


def test_scene_builds_the_test_chain():
    """tools/scenes.rigid_joint_chain is this file's chain."""
    from stark_tpu_torch.tools.scenes import rigid_joint_chain

    a, _ = rigid_joint_chain("float64", "cpu")
    b, _ = _chain(stark_tpu_torch)
    a.stark._initialize()
    b.stark._initialize()
    da, db = a._get_static_data(), b._get_static_data()
    assert set(da) == set(db)
    for name in da:
        assert torch.equal(da[name]["conn"], db[name]["conn"])
        for k in db[name]["rows"]:
            assert torch.equal(da[name]["rows"][k], db[name]["rows"][k]), (name, k)


def test_chain_families_match_jax():
    """At the chain's frozen tables and a random iterate: each joint
    family's twin, and kernels T and U's g++ build, against jax.hessian of
    the JAX family, e, g and H within 1e-10 of each element's largest
    entry; the value-only e bit for bit the egh e."""
    js, _ = _chain(stark_tpu)
    ts, _ = _chain(stark_tpu_torch)
    for sim in (js, ts):
        sim.stark._initialize()
        sim.stark.callbacks.run_before_time_step()
    jdata, jglob = js._get_static_data(), js._get_glob()
    tglob = ts._get_glob()
    jfam = {f.name: f for f in js.stark.global_potential.families}
    tfam = {f.name: f for f in ts.stark.global_potential.families}
    u = np.random.default_rng(3).normal(0.0, 0.7, (ts.stark.newton.n_blocks, 3))
    assert JOINT_FAMILIES <= set(jdata)
    for name in sorted(JOINT_FAMILIES):
        conn = np.asarray(jdata[name]["conn"])
        rows = {k: np.asarray(v) for k, v in jdata[name]["rows"].items()}
        t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
        f = jfam[name].energy_fn
        e_j, g_j, H_j = jax.jit(jax.vmap(
            lambda u_e, r, gl: (f(u_e, r, gl), jax.grad(f)(u_e, r, gl),
                                jax.hessian(f)(u_e, r, gl)), in_axes=(0, 0, None)))(
            jnp.asarray(u)[conn], jdata[name]["rows"], jglob)
        ut = torch.as_tensor(u)
        twin = egh.plain(tfam[name].energy_fn, ut, t["conn"], t["rows"], tglob)
        kern = tfam[name].kernel(ut, t["conn"], t["rows"], tglob, True, host=True)
        e_v = tfam[name].kernel(ut, t["conn"], t["rows"], tglob, False, host=True)
        d = 3 * conn.shape[1]
        m = rows["active"] > 0.5       # the JAX assembly's mask (capacity padding)
        ref = (np.where(m, np.asarray(e_j), 0.0),
               np.where(m[:, None, None], np.asarray(g_j), 0.0),
               np.where(m[:, None, None], np.asarray(H_j).reshape(-1, d, d), 0.0))
        for part, a, b, r in zip("egH", twin, kern, ref):
            assert per_elem_err(a.numpy(), r) <= TOL, (name, part, "twin")
            assert per_elem_err(b.numpy(), r) <= TOL, (name, part, "kernel")
        assert torch.equal(e_v, kern[0]), name


def test_rigid_joint_chain_tracks_stark_tpu():
    """Eight fused f64 steps of 10 ms at the default residual tolerance:
    the same solver codes and Newton counts, the bodies' translations and
    quaternions within 1e-9."""
    def run(pkg):
        sim, bodies = _chain(pkg)
        out = []
        for _ in range(8):
            assert sim.run_one_time_step()
            out.append(np.concatenate([np.concatenate([b.get_translation(),
                                                       b.get_quaternion()])
                                       for b in bodies]))
        lg = sim.get_logger()
        return np.asarray(out), lg.series["solver_code"], lg.series["newton_iterations"]

    xj, cj, nj = run(stark_tpu)
    xt, ct, nt = run(stark_tpu_torch)
    assert cj == ct and nj == nt
    assert np.max(np.abs(xt - xj)) < 1e-9
    assert np.max(np.abs(xt[-1] - xt[0])) > 1e-3     # the chain moves


@pytest.mark.parametrize("host", [False, True])
def test_fd_rigid_constraints(host):
    """tests/test_derivatives.py::test_fd_rigid_constraints through the
    port (its h and tolerance): the twins and the g++ build of kernels P, T
    and U."""
    sim, _ = _chain(stark_tpu_torch)
    err = fd_check(sim, h=1e-6, tol=5e-5, host=host)
    assert err["grad"] < 5e-5 and err["hvp"] < 5e-4


# ---------------------------------------------------------------------------
# simple_grasp, compact (tests/test_f32_quality.py's _make_grasp, n = 3)
# ---------------------------------------------------------------------------
def _grasp(pkg, dtype="float64"):
    """tests/test_f32_quality.py:46-98's compact simple_grasp: a fixed hand,
    two prismatic presses (+-1 m/s, 5 N) on 27 nodes and 135 tets of
    Soft_Rubber, mu 1.05, gravity -10, steps of 1/60 s."""
    P = __import__(pkg.__name__ + ".presets.presets", fromlist=["VolumeParams"])
    C = __import__(pkg.__name__ + ".models.interactions.contact",
                   fromlist=["ContactGlobalParams"])
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = dtype
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    s.simulation.max_time_step_size = 1 / 60
    s.simulation.use_adaptive_time_step = False
    s.simulation.gravity = (0.0, 0.0, -10.0)
    sim = pkg.Simulation(s)
    n, d = 3, 0.2
    hd, gap = d / 2, 0.02
    sim.interactions.contact.set_global_params(
        C.ContactGlobalParams().set_default_contact_thickness(0.001)
        .set_friction_stick_slide_threshold(0.001).set_min_contact_stiffness(1e7))
    obj_params = P.VolumeParams.Soft_Rubber()
    obj_params.inertia.density = 1.0 / d ** 3
    obj_params.strain.elasticity_only = True
    obj_params.strain.youngs_modulus = 2e3
    obj = sim.presets.deformables.add_volume_grid("deformable", (d,) * 3, (n,) * 3, obj_params)
    hand = sim.presets.rigidbodies.add_box("hand", 1.0, (3 * d,) * 3)
    hand.rigidbody.set_translation((0.0, -(3 * hd + hd + gap), 0.0))
    fingers_size = (0.5 * d, 2 * d, 2 * d)
    left = sim.presets.rigidbodies.add_box("finger", 1.0, fingers_size)
    left.rigidbody.set_translation((-(hd + 0.5 * hd + gap), -gap, 0.0))
    right = sim.presets.rigidbodies.add_box("finger", 1.0, fingers_size)
    right.rigidbody.set_translation((hd + 0.5 * hd + gap, -gap, 0.0))
    c = sim.interactions.contact
    c.disable_collision(hand.contact, left.contact)
    c.disable_collision(hand.contact, right.contact)
    sim.rigidbodies.add_constraint_fix(hand.rigidbody)
    presses = [sim.rigidbodies.add_constraint_prismatic_press(
        hand.rigidbody, f.rigidbody, (0, 0, 0), (1, 0, 0), v, 5.0)
        for f, v in ((left, 1.0), (right, -1.0))]
    c.set_friction(left.contact, obj.contact, 1.05)
    c.set_friction(right.contact, obj.contact, 1.05)
    return sim, obj, (left, right), presses


GRASP_STEPS = 10


def test_compact_grasp_on_the_port():
    """Ten steps of 1/60 s in f64: the fingers (2 cm from the cube) close
    under their 5 N caps and catch the falling cube: live contact pairs and
    friction rows, the cube squeezed, its fall well short of free fall, the
    presses' violations and forces from their handlers."""
    sim, obj, (left, right), presses = _grasp(stark_tpu_torch)
    x_rest = obj.point_set.get_positions().copy()
    for _ in range(GRASP_STEPS):
        assert sim.run_one_time_step()
    nm = sim.stark.newton
    assert nm.live_contact_pairs() > 0 and nm.friction_rows() > 0
    gap = right.rigidbody.get_translation()[0] - left.rigidbody.get_translation()[0]
    assert gap < 0.34, gap             # from 0.36: the fingers moved in
    x = obj.point_set.get_positions()
    assert np.all(np.isfinite(x))
    width = x[:, 0].max() - x[:, 0].min()
    assert width < 0.2 - 0.01, width   # the cube is squeezed
    free_fall = 0.5 * 10.0 * sim.get_time() ** 2
    assert -np.mean(x[:, 2] - x_rest[:, 2]) < 0.75 * free_fall
    # both fingers are held back from their +-1 m/s by the cube: past the
    # controller's delay, at its force cap (the left one's target +1, dv < 0)
    for p, sign in zip(presses, (-1.0, 1.0)):
        dv, f = p.get_linear_velocity().get_signed_velocity_violation_and_force()
        assert sign * dv > 0.01 and f == sign * 5.0, (dv, f)


@pytest.mark.slow
def test_compact_grasp_tracks_stark_tpu():
    """The same four steps against the JAX package: equal codes and Newton
    counts, friction rows, positions within 1e-6 m."""
    js, jobj, jf, _ = _grasp(stark_tpu)
    ts, tobj, tf, _ = _grasp(stark_tpu_torch)
    worst = 0.0
    for step in range(GRASP_STEPS):
        assert js.run_one_time_step() and ts.run_one_time_step(), step
        for key in ("solver_code", "newton_iterations"):
            assert js.get_logger().series[key] == ts.get_logger().series[key], (step, key)
        worst = max(worst, float(np.max(np.abs(jobj.point_set.get_positions()
                                                - tobj.point_set.get_positions()))))
        for a, b in zip(jf, tf):
            worst = max(worst, float(np.max(np.abs(a.rigidbody.get_translation()
                                                    - b.rigidbody.get_translation()))))
    assert worst < 1e-6, worst
