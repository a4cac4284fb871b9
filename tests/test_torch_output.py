"""Frame output, OBJ and checkpoints (P10) and the examples entry point
through the port against `stark_tpu` on the CPU.

The port's VTK writer gives the bytes of the JAX package's native binary
writer (repo-root native/stark_native.cc) for points, segments, triangles
and tets, and its reader reads both of the JAX package's layouts; a short
labelled run (a cloth, a prescribed plate, a spinning box) writes the JAX
package's frame files (names, connectivity, vertices within 1e-8 m in
f64); `save_obj` writes JAX's bytes and round-trips; a checkpoint resumes
the port within 1e-8 m, and a `stark_tpu` checkpoint loaded into the port
continues within 1e-8 m of the JAX package's own continuation; every scene
of `stark_tpu_torch.examples` builds on the CPU under repo-root
examples/scenes.py's name.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu.utils import checkpoint as jckpt
from stark_tpu.utils import obj as jobj
from stark_tpu.utils import vtk as jvtk
from stark_tpu_torch import examples
from stark_tpu_torch.utils import checkpoint as tckpt
from stark_tpu_torch.utils import obj as tobj
from stark_tpu_torch.utils import vtk as tvtk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(seed=0):
    """(kind, vertices, conn) of each cell family, seeded."""
    from stark_tpu_torch.utils.mesh_generators import (generate_tet_grid,
                                                       generate_triangle_grid)

    rng = np.random.default_rng(seed)
    V2, T2 = generate_triangle_grid((0.0, 0.0), (1.0, 1.0), (3, 4))
    V3, T3 = generate_tet_grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (2, 2, 2))
    jitter = lambda V: V + rng.normal(0.0, 1e-3, V.shape)
    return [("points", jitter(V2), np.arange(len(V2)).reshape(-1, 1)),
            ("points", jitter(V2), np.arange(len(V2))),
            ("segments", jitter(V2), T2[:, :2]),
            ("triangles", jitter(V2), T2),
            ("tets", jitter(V3), T3)]


@pytest.mark.parametrize("case", range(5))
def test_vtk_bytes_match_stark_tpu(tmp_path, case):
    """The same arrays give the native writer's bytes; both readers read
    them back exactly."""
    from stark_tpu import native

    assert native.get_lib() is not None, "the JAX package's native writer did not load"
    kind, V, C = _meshes()[case]
    pj, pt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    jvtk.write_vtk(pj, V, C, kind)
    tvtk.write_vtk(pt, V, C, kind)
    raw = open(pt, "rb").read()
    assert raw == open(pj, "rb").read()
    assert b"\nBINARY\n" in raw[:64]
    for read in (tvtk.read_vtk, jvtk.read_vtk):
        Vr, Cr = read(pt)
        assert np.array_equal(Vr, V) and np.array_equal(Cr, C.reshape(len(C), -1))


def test_read_vtk_reads_the_ascii_layout(tmp_path, monkeypatch):
    """The JAX package's ASCII fallback (its native library absent): the
    port reads it as the JAX reader does, to the 9 digits it keeps."""
    from stark_tpu import native

    monkeypatch.setattr(native, "write_vtk_binary", lambda *a: False)
    for i, (kind, V, C) in enumerate(_meshes(1)):
        p = str(tmp_path / f"a{i}.vtk")
        jvtk.write_vtk(p, V, C, kind)
        assert b"\nASCII\n" in open(p, "rb").read()[:64]
        Vt, Ct = tvtk.read_vtk(p)
        Vj, Cj = jvtk.read_vtk(p)
        assert np.array_equal(Vt, Vj) and np.array_equal(Ct, Cj)
        assert np.array_equal(Ct, C.reshape(len(C), -1))
        assert np.max(np.abs(Vt - V)) < 1e-8


def test_obj_bytes_and_roundtrip_match_stark_tpu(tmp_path):
    """save_obj writes JAX's bytes; load_obj reads back the mesh."""
    from stark_tpu_torch.utils.mesh_generators import make_box, make_sphere

    for i, (V, T) in enumerate((make_box((0.1, 0.2, 0.3)), make_sphere(0.3, 1))):
        pj, pt = str(tmp_path / f"j{i}.obj"), str(tmp_path / f"t{i}.obj")
        jobj.save_obj(pj, V, T)
        tobj.save_obj(pt, V, T)
        assert open(pt, "rb").read() == open(pj, "rb").read()
        (Vt, Tt), = tobj.load_obj(pt)
        (Vj, Tj), = jobj.load_obj(pj)
        assert np.array_equal(Vt, Vj) and np.array_equal(Tt, Tj)
        assert Vt.shape == V.shape and np.array_equal(Tt, T)
        assert np.max(np.abs(Vt - V)) < 1e-9


def _labelled_run(pkg, out_dir, seconds):
    """A 6x6 Cotton_Fabric cloth ("cloth", two corners pinned), a
    prescribed triangle ("plate") and a spinning free box ("box") under
    gravity, contact off, f64, frames at 60 fps under out_dir. Returns the
    simulation and the cloth's handlers."""
    E = __import__(pkg.__name__ + ".models.deformables.energies",
                   fromlist=["PrescribedPositionsParams"])
    P = __import__(pkg.__name__ + ".presets.presets", fromlist=["SurfaceParams"])
    s = pkg.Settings()
    s.output.simulation_name = "labelled"
    s.output.output_directory = str(out_dir)
    s.output.fps = 60
    s.output.enable_output = False
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    s.simulation.init_frictional_contact = False
    s.simulation.max_time_step_size = 1 / 60
    sim = pkg.Simulation(s)
    h = sim.presets.deformables.add_surface_grid("cloth", (0.3, 0.3), (6, 6),
                                                 P.SurfaceParams.Cotton_Fabric())
    sim.deformables.prescribed_positions.add(h.point_set, [0, 6],
                                             E.PrescribedPositionsParams())
    sim.presets.deformables.add_prescribed_surface(
        "plate", np.array([[0.0, 0.0, -0.3], [0.2, 0.0, -0.3], [0.0, 0.2, -0.3]]),
        np.array([[0, 1, 2]]), P.PrescribedSurfaceParams())
    box = sim.presets.rigidbodies.add_box("box", 0.5, (0.1, 0.2, 0.05))
    box.rigidbody.add_translation((0.5, 0.0, 0.0))
    box.rigidbody.set_angular_velocity((1.0, 2.0, 3.0))
    assert sim.run(seconds)
    return sim, h


def test_labelled_frames_match_stark_tpu(tmp_path):
    """The same frame files as the JAX package (deformable and rigid
    output, the first frame included), connectivity exact, vertices within
    1e-8 m; the last frames hold the simulations' positions."""
    jsim, _ = _labelled_run(stark_tpu, tmp_path / "jax", 0.1)
    tsim, cloth = _labelled_run(stark_tpu_torch, tmp_path / "torch", 0.1)
    names = sorted(f for f in os.listdir(tmp_path / "jax") if f.endswith(".vtk"))
    assert names == sorted(f for f in os.listdir(tmp_path / "torch") if f.endswith(".vtk"))
    frames = tsim.get_frame()
    assert frames == jsim.get_frame() and frames >= 6
    assert names == sorted(f"labelled_{k}_{i}.vtk" for k in ("cloth", "plate", "box")
                           for i in range(frames))
    for f in names:
        Vj, Cj = jvtk.read_vtk(str(tmp_path / "jax" / f))
        Vt, Ct = tvtk.read_vtk(str(tmp_path / "torch" / f))
        assert np.array_equal(Cj, Ct), f
        assert np.max(np.abs(Vt - Vj)) < 1e-8, f
    last = frames - 1
    Vt, _ = tvtk.read_vtk(str(tmp_path / "torch" / f"labelled_cloth_{last}.vtk"))
    assert np.array_equal(Vt, cloth.point_set.get_positions())


def _cloth_sim(pkg):
    """tests/test_aux.py's _cloth_sim: a 4x4 cloth, two pinned nodes, 1/60 s."""
    E = __import__(pkg.__name__ + ".models.deformables.energies",
                   fromlist=["PrescribedPositionsParams"])
    P = __import__(pkg.__name__ + ".presets.presets", fromlist=["SurfaceParams"])
    s = pkg.Settings()
    s.output.simulation_name = "aux"
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.simulation.init_frictional_contact = False
    s.simulation.max_time_step_size = 1 / 60
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    h = sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (4, 4),
                                                 P.SurfaceParams.Cotton_Fabric())
    sim.deformables.prescribed_positions.add(h.point_set, [0, 4],
                                             E.PrescribedPositionsParams())
    return sim, h


def test_checkpoint_resume(tmp_path):
    """tests/test_aux.py::test_checkpoint_resume through the port (0.1 s
    before and after the checkpoint): resumed in a fresh simulation,
    within 1e-8 m and 1e-9 s."""
    sim, h = _cloth_sim(stark_tpu_torch)
    sim.run(duration=0.1)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(sim, path)
    sim.run(duration=0.1)
    x_ref, t_ref = h.point_set.get_positions(), sim.get_time()
    sim2, h2 = _cloth_sim(stark_tpu_torch)
    sim2.stark._initialize()
    tckpt.load_state(sim2, path)
    sim2.run(duration=0.1)
    assert abs(sim2.get_time() - t_ref) < 1e-9
    assert np.max(np.abs(h2.point_set.get_positions() - x_ref)) < 1e-8


def test_stark_tpu_checkpoint_continues_on_the_port(tmp_path):
    """A checkpoint of the JAX package (its npz keys and meta) loads into
    the port, which continues within 1e-8 m of JAX's own continuation."""
    jsim, jh = _cloth_sim(stark_tpu)
    jsim.run(duration=0.1)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(jsim, path)
    jsim.run(duration=0.1)
    sim, h = _cloth_sim(stark_tpu_torch)
    sim.stark._initialize()
    tckpt.load_state(sim, path)
    assert sim.get_time() == pytest.approx(0.1, abs=0.02)
    sim.run(duration=0.1)
    assert abs(sim.get_time() - jsim.get_time()) < 1e-9
    assert np.max(np.abs(h.point_set.get_positions() - jh.point_set.get_positions())) < 1e-8


def test_examples_build_under_upstream_names(tmp_path):
    """Every scene of stark_tpu_torch.examples builds (not run) on the CPU,
    under the names of repo-root examples/scenes.py's SCENES."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_scenes", os.path.join(ROOT, "examples", "scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert list(examples.SCENES) == list(mod.SCENES) == list(examples.BUILD)
    for name in examples.SCENES:
        s = examples.base_settings(name)
        s.output.output_directory = str(tmp_path / name)
        s.output.enable_output = False
        s.device.device = "cpu"
        sim, handles = examples.build(name, s)
        assert isinstance(sim, stark_tpu_torch.Simulation) and sim.stark.settings is s
        assert sim._dyn.n_points > 0, name
