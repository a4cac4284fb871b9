"""The attachments (P8: kernel W's five families) through the port against
`stark_tpu` on the CPU.

The port's copy of collision/mesh_distance.py answers the JAX package's
queries exactly (distances, triangles, barycentrics, classify_bary) on
seeded meshes and on upstream's `attachments` example; that example built
through `stark_tpu_torch.examples` freezes the five families' tables of
repo-root examples/scenes.py row for row; tests/test_derivatives.py::
test_fd_attachments' scene and a d-d add_by_distance scene pass the port's
finite-difference check (the twins and the g++ build of kernel W); a
compact copy of the example (n = 6, f64) tracks the JAX package step for
step, and so does a copy whose tolerance makes the converged-state check
harden the stiffness. The families' twins and W's host build against
jax.hessian are in tests/test_torch_egh.py.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu.collision import mesh_distance as jmd
from stark_tpu_torch import examples
from stark_tpu_torch.collision import mesh_distance as tmd
from stark_tpu_torch.models.interactions import attachments as tatt
from stark_tpu_torch.tools.fd_check import fd_check
from stark_tpu_torch.utils.from_jax import tables_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = tatt.KINDS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_examples(tmp_path, monkeypatch):
    """Repo-root examples/scenes.py, writing under tmp_path, its scenes built
    without running (Simulation.run patched out)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_scenes", os.path.join(ROOT, "examples", "scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "OUTPUT_PATH", str(tmp_path / "jax"))
    monkeypatch.setattr(stark_tpu.Simulation, "run", lambda self, *a, **k: True)
    return mod


def _settings(pkg, dtype="float64", dt=None):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = dtype
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    if dt is not None:
        s.simulation.max_time_step_size = dt
    return s


def _attachments_scene(pkg, n, settings, params=None):
    """Upstream's attachments example (examples/main.cpp:268-313) at grid
    size n through either package's API: cloth B (turned 45 deg, 1 mm up)
    glued to cloth A by distance, B's nodes near a 0.25 m box glued to it,
    A pinned at two corners, no contact."""
    A = __import__(pkg.__name__ + ".models.interactions.attachments",
                   fromlist=["AttachmentParams"])
    E = __import__(pkg.__name__ + ".models.deformables.energies",
                   fromlist=["PrescribedPositionsParams"])
    P = __import__(pkg.__name__ + ".presets.presets", fromlist=["SurfaceParams"])
    G = __import__(pkg.__name__ + ".utils.mesh_generators", fromlist=["make_box"])
    settings.simulation.init_frictional_contact = False
    sim = pkg.Simulation(settings)
    d, gap = 1.0, 0.001
    hd = d / 2
    params = params or A.AttachmentParams().set_tolerance(0.01)
    a = sim.presets.deformables.add_surface_grid("A", (d, d), (n, n),
                                                 P.SurfaceParams.Cotton_Fabric())
    b = sim.presets.deformables.add_surface_grid("B", (d, d), (n, n),
                                                 P.SurfaceParams.Cotton_Fabric())
    b.point_set.add_rotation(45.0, (0, 0, 1))
    b.point_set.add_displacement((d, 0.0, gap))
    box_V, box_T = G.make_box(0.25)
    box = sim.presets.rigidbodies.add_box("box", 0.1, 0.25)
    box.rigidbody.add_translation((1.7, 0.0, 0.125 + 2.0 * gap))
    att = sim.interactions.attachments
    att.add_by_distance(b.point_set, a.point_set, list(range(b.point_set.size())),
                        a.connectivity, 2.0 * gap, params)
    att.add_by_distance(box.rigidbody, b.point_set, box_V, box_T,
                        list(range(b.point_set.size())), 4.0 * gap, params)
    bc = E.PrescribedPositionsParams()
    sim.deformables.prescribed_positions.add_inside_aabb(
        a.point_set, (-hd, -hd, 0.0), (0.001,) * 3, bc)
    sim.deformables.prescribed_positions.add_inside_aabb(
        a.point_set, (-hd, hd, 0.0), (0.001,) * 3, bc)
    return sim, (a, b, box)


def _frozen_tables(sim, names):
    """The frozen tables of `names` as numpy (conn and rows), after the
    first step's freeze."""
    sim.stark._initialize()
    out = {}
    for name in names:
        fd = sim._device_data.get(name)
        if fd is None:
            continue
        conv = (lambda v: v.cpu().numpy()) if isinstance(fd["conn"], torch.Tensor) \
            else np.asarray
        out[name] = {"conn": conv(fd["conn"]),
                     "rows": {k: conv(v) for k, v in fd["rows"].items()}}
    return out


# ---------------------------------------------------------------------------
# the point -> mesh query
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_distance_matches_stark_tpu(seed):
    """Seeded meshes (a grid, jittered, and its corners, edges and faces
    approached from both sides): equal distances, triangles, barycentrics
    and classify_bary, both pruning paths (k-NN and dense)."""
    from stark_tpu_torch.utils.mesh_generators import generate_triangle_grid

    rng = np.random.default_rng(seed)
    V, T = generate_triangle_grid((0.0, 0.0), (1.0, 1.0), (6 + seed, 5))
    V = V + rng.normal(0.0, 0.01, V.shape)
    P = np.concatenate([rng.uniform(-0.7, 0.7, (200, 3)) * [1, 1, 0.05],
                        V[rng.choice(len(V), 20)] + [0, 0, 1e-3],
                        0.5 * (V[T[:8, 0]] + V[T[:8, 1]])])
    for kd in (tmd._KDTree, None):
        saved = (tmd._KDTree, jmd._KDTree)
        tmd._KDTree = jmd._KDTree = kd
        try:
            out_t = tmd.closest_point_on_triangles(P, V, T)
            out_j = jmd.closest_point_on_triangles(P, V, T)
        finally:
            tmd._KDTree, jmd._KDTree = saved
        for a, b in zip(out_t, out_j):
            assert np.array_equal(a, b)
    assert [tmd.classify_bary(b) for b in out_t[2]] == \
        [jmd.classify_bary(b) for b in out_j[2]]
    kinds = {tmd.classify_bary(b)[0] for b in out_t[2]}
    assert kinds == {"vertex", "edge", "face"}


def test_example_queries_match_stark_tpu():
    """Upstream's attachments example's two queries (B's nodes against A's
    triangles, B's nodes against the box's world mesh) at its sizes."""
    sim, (a, b, box) = _attachments_scene(stark_tpu_torch, 20, _settings(stark_tpu_torch))
    from stark_tpu_torch.utils.mesh_generators import make_box

    x = sim._dyn.host_x_all()
    P = x[b.point_set.all_global_indices()]
    Va = x[a.point_set.all_global_indices()]
    box_V, box_T = make_box(0.25)
    W = box_V @ box.rigidbody.get_rotation_matrix().T + box.rigidbody.get_translation()
    for V, T in ((Va, a.connectivity), (W, box_T)):
        out_t = tmd.closest_point_on_triangles(P, V, T)
        out_j = jmd.closest_point_on_triangles(P, V, T)
        for u, v in zip(out_t, out_j):
            assert np.array_equal(u, v)
        assert [tmd.classify_bary(c) for c in out_t[2]] == \
            [jmd.classify_bary(c) for c in out_j[2]]


# ---------------------------------------------------------------------------
# the example's tables
# ---------------------------------------------------------------------------
def test_example_tables_match_stark_tpu(tmp_path, monkeypatch):
    """stark_tpu_torch.examples' attachments at upstream's sizes (built, not
    run) freezes the tables of repo-root examples/scenes.py's, row for row:
    conn, barycentrics, stiffness, body-local points and bodies."""
    jsim = _jax_examples(tmp_path, monkeypatch).attachments()
    s = examples.base_settings("attachments")
    s.output.output_directory = str(tmp_path / "torch")
    s.device.device = "cpu"
    tsim, h = examples.build_attachments(s)
    jt, tt = _frozen_tables(jsim, FAMILIES), _frozen_tables(tsim, FAMILIES)
    assert set(jt) == set(tt) == {tatt.PE, tatt.PT, tatt.RBD}
    for name in jt:
        assert np.array_equal(jt[name]["conn"], tt[name]["conn"]), name
        assert jt[name]["rows"].keys() == tt[name]["rows"].keys()
        for k, v in jt[name]["rows"].items():
            assert np.array_equal(np.asarray(v, dtype=tt[name]["rows"][k].dtype),
                                  tt[name]["rows"][k]), (name, k)
    live = {n: int((tt[n]["rows"]["active"] > 0.5).sum()) for n in tt}
    assert live == {tatt.PE: 3, tatt.PT: 18, tatt.RBD: 10}
    # utils/from_jax carries JAX's tables across unchanged: RBD's integer
    # `body` and float `loc` leaves included
    carried = tables_from_numpy(jt)
    for name, fd in carried.items():
        mine = tsim._device_data[name]
        assert torch.equal(fd["conn"], mine["conn"])
        for k, v in fd["rows"].items():
            assert v.dtype == mine["rows"][k].dtype and torch.equal(v, mine["rows"][k]), (name, k)


# ---------------------------------------------------------------------------
# derivatives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("host", [False, True])
def test_fd_attachments(host):
    """tests/test_derivatives.py::test_fd_attachments' scene (a 2x2 cloth's
    nodes 0 and 1 glued to a free box) through the port."""
    from stark_tpu_torch.models.rigidbodies.inertia_tensors import inertia_tensor_box
    from stark_tpu_torch.presets.presets import SurfaceParams

    s = _settings(stark_tpu_torch)
    s.simulation.init_frictional_contact = False
    sim = stark_tpu_torch.Simulation(s)
    h = sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (2, 2),
                                                 SurfaceParams.Cotton_Fabric())
    rb = sim.rigidbodies.add(1.0, inertia_tensor_box(1.0, 0.1))
    sim.interactions.attachments.add_rb_point(rb, h.point_set, [0, 1])
    err = fd_check(sim, host=host)
    assert err["grad"] < 2e-5 and err["hvp"] < 5e-4


@pytest.mark.parametrize("host", [False, True])
def test_fd_attachments_by_distance(host):
    """A d-d add_by_distance scene: the compact example (n = 6: point-edge
    and point-triangle rows, and points on the box)."""
    sim, _ = _attachments_scene(stark_tpu_torch, 6, _settings(stark_tpu_torch))
    err = fd_check(sim, host=host)
    data = sim._get_static_data()
    assert {tatt.PE, tatt.PT, tatt.RBD} <= set(data)
    assert err["grad"] < 2e-5 and err["hvp"] < 5e-4


# ---------------------------------------------------------------------------
# scenes against the JAX package
# ---------------------------------------------------------------------------
def _track(params_fn, steps):
    """The compact example (n = 6, f64, 10 ms steps, fused) in both
    packages for `steps` calls of run_one_time_step: positions after each,
    the solves' codes and the time after each call (a rejected converged
    state retries the step: the time stays), Newton counts and each
    family's group stiffness at the end."""
    out = {}
    for pkg in (stark_tpu, stark_tpu_torch):
        A = __import__(pkg.__name__ + ".models.interactions.attachments",
                       fromlist=["AttachmentParams"])
        sim, (a, b, box) = _attachments_scene(pkg, 6, _settings(pkg, dt=0.01),
                                              params_fn(A.AttachmentParams))
        xs, times = [], []
        for _ in range(steps):
            assert sim.run_one_time_step()
            xs.append(np.concatenate([a.point_set.get_positions(),
                                      b.point_set.get_positions(),
                                      box.rigidbody.get_translation()[None]]))
            times.append(sim.get_time())
        lg = sim.get_logger()
        att = sim.interactions.attachments
        out[pkg.__name__] = (np.asarray(xs), (lg.series["solver_code"], times),
                             lg.series["newton_iterations"],
                             {k: [g["stiffness"] for g in v] for k, v in att.groups.items()})
    return out["stark_tpu"], out["stark_tpu_torch"]


def test_compact_example_tracks_stark_tpu():
    """Six fused f64 steps of the compact example: equal codes and Newton
    counts, positions within 1e-8 m; cloth B and the box move."""
    (xj, cj, nj, kj), (xt, ct, nt, kt) = _track(lambda P: P().set_tolerance(0.01), 6)
    assert cj == ct and nj == nt
    assert np.max(np.abs(xt - xj)) < 1e-8
    assert kj == kt
    assert np.max(np.abs(xt[-1] - xt[0])) > 1e-3


def test_hardening_tracks_stark_tpu():
    """A stiffness of 100 and a tolerance of 1e-4 m: the converged-state
    check rejects the first solves and doubles the stiffness of each group
    per element past its tolerance (InvalidConvergedState, the same step
    again). The same hardened stiffness per group, the same step outcomes
    and Newton counts, positions within 1e-8 m."""
    (xj, cj, nj, kj), (xt, ct, nt, kt) = _track(
        lambda P: P().set_stiffness(100.0).set_tolerance(1e-4), 3)
    assert kj == kt
    assert any(k > 100.0 for ks in kt.values() for k in ks)
    assert cj == ct and nj == nt
    times = ct[1]
    assert times[0] == 0.0 and times[-1] > 0.0   # rejected, then accepted
    assert np.max(np.abs(xt - xj)) < 1e-8
