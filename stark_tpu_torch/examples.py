"""Upstream's example scenes (examples/main.cpp) through the port's public API.

The port's counterpart of repo-root `examples/scenes.py`, with the same
eleven scene names. Run:

    python -m stark_tpu_torch.examples <scene_name> [duration]

Frames and logs go under `$STARK_TPU_TORCH_OUTPUT` (default
/tmp/stark_tpu_torch_examples), one directory per scene. The device and
dtype are the settings' defaults (the card, float64); a caller that builds
a scene passes its own settings (`build(name, settings)`). Each scene has
one build function, `BUILD[name](settings) -> (sim, handles)`, split from
its run, `SCENES[name](duration)`; where `tools/scenes.py` builds a scene
for the on-card scripts, both use its function. A duration of 0 or None runs
until the settings' end time.
"""
from __future__ import annotations

import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from . import Settings, Simulation
from .models.deformables.energies import PrescribedPositionsParams
from .models.interactions.attachments import AttachmentParams
from .models.interactions.contact import ContactGlobalParams
from .presets.presets import SurfaceParams, VolumeParams
from .solver.potential import FamilyData, PotentialFamily
from .tools import scenes as shared
from .utils import mesh_generators as gen

OUTPUT_PATH = os.environ.get("STARK_TPU_TORCH_OUTPUT", "/tmp/stark_tpu_torch_examples")


def base_settings(name, end_time=5.0):
    s = Settings()
    s.output.simulation_name = name
    s.output.output_directory = os.path.join(OUTPUT_PATH, name)
    s.execution.end_simulation_time = end_time
    return s


def build_hanging_net(settings=None):
    # examples/main.cpp:12-39
    sim, h = shared.hanging_net(settings=settings or base_settings("hanging_net"))
    return sim, SimpleNamespace(net=h)


def build_hanging_cloth(settings=None):
    # examples/main.cpp:41-74
    s = settings or base_settings("hanging_cloth")
    s.simulation.init_frictional_contact = False
    sim = Simulation(s)
    n, d = 32, 1.0
    hd = d / 2
    h = sim.presets.deformables.add_surface_grid("cloth", (d, d), (n, n),
                                                 SurfaceParams.Cotton_Fabric())
    bc = PrescribedPositionsParams().set_stiffness(1e6)
    sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (hd, hd, 0.0), (0.001, 0.001, 0.001), bc)
    sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (-hd, hd, 0.0), (0.001, 0.001, 0.001), bc)
    return sim, SimpleNamespace(cloth=h)


def build_hanging_deformable_box(settings=None):
    # examples/main.cpp:76-107
    s = settings or base_settings("hanging_deformable_box")
    s.simulation.init_frictional_contact = False
    sim = Simulation(s)
    n, d = 10, 0.5
    hd = d / 2
    mat = VolumeParams.Soft_Rubber()
    mat.strain.youngs_modulus = 1e4
    h = sim.presets.deformables.add_volume_grid("box", (d, d, d), (n, n, n), mat)
    bc = PrescribedPositionsParams().set_stiffness(1e7)
    sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (hd, hd, hd), (0.001, 0.001, 0.001), bc)
    sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (-hd, hd, hd), (0.001, 0.001, 0.001), bc)
    return sim, SimpleNamespace(box=h)


def build_hanging_box_with_composite_material(settings=None):
    # examples/main.cpp:109-190: individual energies instead of presets
    sim, nodes = shared.hanging_box_with_composite_material(
        settings=settings or base_settings("hanging_box_with_composite_material", 8.0))
    return sim, SimpleNamespace(nodes=nodes)


def build_quasistatic_column_extrusion(settings=None, refinement=8):
    # examples/main.cpp:191-266
    dur = 1.0
    extrusion_factor = 5.0
    dt = dur * 0.99999
    size = (1.0, 1.0, 0.5)
    s = settings or base_settings("quasistatic_column_extrusion", dur)
    s.output.fps = int(1.0 / dt)
    s.simulation.gravity = (0.0, 0.0, 0.0)
    s.simulation.max_time_step_size = dt
    s.newton.project_to_pd_use_mirroring = True
    s.newton.step_tolerance = 0.001 / dt
    s.newton.step_cap = 0.5 / dt
    s.simulation.init_frictional_contact = False
    sim = Simulation(s)
    n = refinement
    V, T = gen.generate_tet_grid((0, 0, 0), size, (n, n, int(round(extrusion_factor * n / 5))))
    mat = VolumeParams.Soft_Rubber()
    mat.strain.elasticity_only = True
    mat.inertia.quasistatic = True
    mat.strain.poissons_ratio = 0.49
    mat.strain.youngs_modulus = 1e8
    h = sim.presets.deformables.add_volume("block", V, T, mat)
    bc = PrescribedPositionsParams().set_stiffness(1e10)
    sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (0, 0, -size[2] / 2), (10, 10, 0.001), bc)
    top = sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (0, 0, size[2] / 2), (10, 10, 0.001), bc)

    def extrude(t):
        max_disp = (extrusion_factor - 1) * size[2]
        top.set_transformation((0.0, 0.0, max_disp / dur * t), R=np.eye(3))

    sim.add_time_event(0, dur, extrude)
    return sim, SimpleNamespace(block=h, top=top)


def build_attachments(settings=None, n=20):
    # examples/main.cpp:268-313: cloth B glued to cloth A by distance, and B's
    # nodes near the box glued to it; upstream's n = 20 (441 nodes a cloth),
    # a smaller n for a compact copy
    s = settings or base_settings("attachments")
    s.simulation.init_frictional_contact = False
    sim = Simulation(s)
    d = 1.0
    hd, gap = d / 2, 0.001
    params = SurfaceParams.Cotton_Fabric()
    a = sim.presets.deformables.add_surface_grid("A", (d, d), (n, n), params)
    b = sim.presets.deformables.add_surface_grid("B", (d, d), (n, n), params)
    b.point_set.add_rotation(45.0, (0, 0, 1))
    b.point_set.add_displacement((d, 0.0, gap))

    bs = 0.25
    box_V, box_T = gen.make_box(bs)
    box = sim.presets.rigidbodies.add_box("box", 0.1, bs)
    box.rigidbody.add_translation((1.7, 0.0, 0.5 * bs + 2.0 * gap))

    att = sim.interactions.attachments
    glue = att.add_by_distance(b.point_set, a.point_set, list(range(b.point_set.size())),
                               a.connectivity, 2.0 * gap,
                               AttachmentParams().set_tolerance(0.01))
    on_box = att.add_by_distance(box.rigidbody, b.point_set, box_V, box_T,
                                 list(range(b.point_set.size())), 4.0 * gap,
                                 AttachmentParams().set_tolerance(0.01))

    bc = PrescribedPositionsParams()
    sim.deformables.prescribed_positions.add_inside_aabb(
        a.point_set, (-hd, -hd, 0.0), (0.001,) * 3, bc)
    sim.deformables.prescribed_positions.add_inside_aabb(
        a.point_set, (-hd, hd, 0.0), (0.001,) * 3, bc)
    return sim, SimpleNamespace(a=a, b=b, box=box, glue=glue, on_box=on_box)


def build_deformable_and_rigid_collisions(settings=None):
    # examples/main.cpp:314-369
    sim, (h1, h2, floor) = shared.deformable_and_rigid_collisions(
        settings=settings or base_settings("deformable_and_rigid_collisions"))
    return sim, SimpleNamespace(box1=h1, box2=h2, floor=floor)


def build_spinning_box_cloth(settings=None):
    # examples/main.cpp:371-414 (also bench.py's scene); the run registers
    # spin(t) for its duration
    sim, cloth, spin = shared.spinning_box_cloth(
        32, settings=settings or base_settings("spinning_box_cloth", 10.0))
    return sim, SimpleNamespace(cloth=cloth, spin=spin)


def build_simple_grasp(settings=None):
    # examples/main.cpp:416-523: rigid gripper pinching a deformable cube
    sim, (obj, hand, left, right, pl, pr) = shared.simple_grasp(
        settings=settings or base_settings("simple_grasp", 7.0))
    return sim, SimpleNamespace(obj=obj, hand=hand, left=left, right=right,
                                press_left=pl, press_right=pr)


def build_twisting_cloth(settings=None):
    # examples/main.cpp:525-573; the run registers the two twists for its
    # duration
    s = settings or base_settings("twisting_cloth", 5.0)
    s.simulation.gravity = (0.0, 0.0, 0.0)
    s.newton.step_tolerance = 0.001
    sim = Simulation(s)
    sim.interactions.contact.set_global_params(
        ContactGlobalParams().set_default_contact_thickness(0.001)
        .set_min_contact_stiffness(1e6))
    sdim, n = 0.5, 32
    material = SurfaceParams.Cotton_Fabric()
    material.strain.elasticity_only = True
    h = sim.presets.deformables.add_surface_grid("cloth", (sdim, sdim), (n, n), material)
    h.point_set.add_rotation(90.0, (1, 0, 0))
    h.contact.set_friction(h.contact, 1.0)
    bc = PrescribedPositionsParams()
    left = sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (-sdim / 2, 0, 0), (0.001, sdim, sdim), bc)
    right = sim.deformables.prescribed_positions.add_inside_aabb(
        h.point_set, (sdim / 2, 0, 0), (0.001, sdim, sdim), bc)
    w = 90.0
    twists = (lambda t: left.set_transformation((0, 0, 0), angle_deg=w * t, axis=(1, 0, 0)),
              lambda t: right.set_transformation((0, 0, 0), angle_deg=-w * t,
                                                 axis=(1, 0, 0)))
    return sim, SimpleNamespace(cloth=h, twists=twists)


def build_magnetic_deformables_implicit(settings=None):
    # examples/main.cpp:575-722: extending the framework with a custom
    # potential, two soft boxes with embedded dipoles that attract
    # implicitly. The energy is user code in torch: torch.func takes its
    # derivatives on any device (counted on the card in
    # ops/build.func_on_card), as the JAX package runs it through jax.hessian.
    s = settings or base_settings("magnetic_deformables", 4.0)
    s.simulation.gravity = (0.0, 0.0, 0.0)
    s.simulation.init_frictional_contact = True
    sim = Simulation(s)
    sim.interactions.contact.set_global_params(
        ContactGlobalParams().set_default_contact_thickness(0.002))
    n, d, gap = 3, 0.1, 0.06
    mat = VolumeParams.Soft_Rubber()
    h1 = sim.presets.deformables.add_volume_grid("m1", (d,) * 3, (n,) * 3, mat)
    h1.point_set.add_displacement((-(d + gap) / 2, 0, 0))
    h2 = sim.presets.deformables.add_volume_grid("m2", (d,) * 3, (n,) * 3, mat)
    h2.point_set.add_displacement(((d + gap) / 2, 0, 0))

    # custom magnetic point-pair energy: E = -c / (||xa - xb|| + eps)
    center1 = int(np.argmin(np.linalg.norm(
        h1.point_set.get_positions() - h1.point_set.get_positions().mean(0), axis=1)))
    center2 = int(np.argmin(np.linalg.norm(
        h2.point_set.get_positions() - h2.point_set.get_positions().mean(0), axis=1)))
    ga = int(h1.point_set.get_global_index(center1))
    gb = int(h2.point_set.get_global_index(center2))

    def magnet_energy(u_e, row, glob):
        dt = glob["dt"]
        xa = glob["x0"][row["na"][None]][0] + dt * u_e[0]
        xb = glob["x0"][row["nb"][None]][0] + dt * u_e[1]
        r = torch.sqrt(torch.sum((xa - xb) ** 2) + 1e-6)
        return -row["strength"] / r

    def provider():
        conn = np.asarray([[ga, gb]], dtype=np.int32)
        return FamilyData(conn, {"na": conn[:, 0], "nb": conn[:, 1],
                                 "strength": np.asarray([2e-3])})

    sim.stark.global_potential.add_potential(
        PotentialFamily("CustomMagneticDipole", 2, magnet_energy), provider)
    return sim, SimpleNamespace(m1=h1, m2=h2)


def _runner(name, build, default_duration=None, events=None):
    """The run of scene `name`: build it, register its time events over
    [0, duration), run for the duration (None or 0: until the end time)."""
    def run(duration=None, settings=None):
        sim, handles = build(settings)
        dur = duration or default_duration
        if events is not None:
            for f in events(handles):
                sim.add_time_event(0.0, dur, f)
        sim.run(dur or math.inf)
        return sim

    run.__name__ = name
    return run


BUILD = {
    "hanging_net": build_hanging_net,
    "hanging_cloth": build_hanging_cloth,
    "hanging_deformable_box": build_hanging_deformable_box,
    "hanging_box_with_composite_material": build_hanging_box_with_composite_material,
    "quasistatic_column_extrusion": build_quasistatic_column_extrusion,
    "attachments": build_attachments,
    "deformable_and_rigid_collisions": build_deformable_and_rigid_collisions,
    "spinning_box_cloth": build_spinning_box_cloth,
    "simple_grasp": build_simple_grasp,
    "twisting_cloth": build_twisting_cloth,
    "magnetic_deformables_implicit": build_magnetic_deformables_implicit,
}
# upstream runs these two for a fixed time, their events over it
_TIMED = {"spinning_box_cloth": (10.0, lambda h: (h.spin,)),
          "twisting_cloth": (5.0, lambda h: h.twists)}
SCENES = {name: _runner(name, b, *_TIMED.get(name, ())) for name, b in BUILD.items()}


def build(name, settings=None):
    """Build scene `name` without running it: (sim, handles)."""
    return BUILD[name](settings)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "hanging_cloth"
    dur = float(argv[1]) if len(argv) > 1 else None
    if name not in SCENES:
        print("scenes:", ", ".join(SCENES))
        return 1
    SCENES[name](dur)
    return 0


if __name__ == "__main__":
    sys.exit(main())
