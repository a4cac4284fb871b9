"""Scenes the on-card scripts drive (`chip_smoke.py`, `tools/profile_stages.py`)."""
from __future__ import annotations

import math


def spinning_box_cloth(n: int, dtype: str, device: str = "cuda",
                       adaptive: bool = True, name: str = "spinning_box_cloth",
                       mu: float = 0.0, broad_phase: str = "auto"):
    """bench.py's spinning_box_cloth: an n x n Cotton_Fabric cloth (0.4 m)
    falling on a fixed 8 cm box that sinks and turns (90 deg/s), IPC contact
    at 2 mm thickness. With mu > 0, Coulomb friction mu between the cloth
    and the box and of the cloth with itself (the upstream examples' cloth
    friction is 1.0). `broad_phase` ("auto", "dense", "grid") picks the
    candidate search; "auto" takes the hash grid for the edge-edge block
    from 62x62 on. Returns (sim, cloth handler, spin(t)); the caller either
    registers spin as a time event or calls it before each step."""
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.interactions.contact import ContactGlobalParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    s = Settings()
    s.output.simulation_name = f"{name}_{n}"
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = device
    s.device.dtype = dtype
    s.simulation.use_adaptive_time_step = adaptive
    sim = Simulation(s)
    gp = ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    sim.interactions.contact.broad_phase = broad_phase
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (n, n), SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    if mu > 0.0:
        cloth.contact.set_friction(box.contact, mu)
        cloth.contact.set_friction(cloth.contact, mu)

    def spin(t):
        fix.set_transformation([0.0, 0.0, -0.08 - 0.1 * math.sin(t)],
                               angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0])

    return sim, cloth, spin


def _settings(name: str, dtype: str, device: str, contact: bool):
    from stark_tpu_torch import Settings

    s = Settings()
    s.output.simulation_name = name
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = device
    s.device.dtype = dtype
    s.simulation.init_frictional_contact = contact
    return s


def hanging_net(dtype: str, device: str = "cuda", n: int = 20, d: float = 1.0):
    """Upstream's hanging_net (examples/main.cpp:12-39; repo-root
    examples/scenes.py:44): the edges of an n x n grid of side d as
    Elastic_Rubberband rods, every node outside the grid's inner AABB
    pinned, no contact. At n = 20: 441 nodes, 1,240 segments. Returns
    (sim, line handler)."""
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import LineParams
    from stark_tpu_torch.utils import mesh_generators as gen
    from stark_tpu_torch.utils.mesh_utils import find_edges_from_simplices

    sim = Simulation(_settings(f"hanging_net_{n}", dtype, device, False))
    V, T = gen.generate_triangle_grid((0.0, 0.0), (d, d), (n, n))
    E = find_edges_from_simplices(T, len(V))
    h = sim.presets.deformables.add_line("segments", V, E, LineParams.Elastic_Rubberband())
    sim.deformables.prescribed_positions.add_outside_aabb(
        h.point_set, (0, 0, 0), (d - 0.001, d - 0.001, d - 0.001),
        PrescribedPositionsParams())
    return sim, h


def hanging_box_with_composite_material(dtype: str, device: str = "cuda", n: int = 10,
                                        d: float = 0.2):
    """Upstream's hanging_box_with_composite_material (examples/main.cpp:
    109-190; repo-root examples/scenes.py:96-136), its output calls
    dropped: an n^3 tet grid of side d (Stable Neo-Hookean, E = 1e3) with
    rods on the surface's sharp edges (E = 5e5, r = 5 mm), a membrane and
    flat-rest shells on its surface, turned -90 deg about x and hung by
    the two nodes at (+-d/2, d/2, d/2). At n = 10: 1,331 nodes, 5,000 tets,
    1,200 surface triangles, 120 segments, 1,800 shell stencils. Returns
    (sim, point set handler)."""
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.models.deformables.energies import (
        DiscreteShellsParams, LumpedInertiaParams, PrescribedPositionsParams,
        SegmentStrainParams, TetStrainParams, TriangleStrainParams)
    from stark_tpu_torch.utils import mesh_generators as gen
    from stark_tpu_torch.utils import mesh_utils as mu

    sim = Simulation(_settings(f"hanging_box_with_composite_material_{n}", dtype,
                               device, False))
    hd = d / 2
    vertices, tets = gen.generate_tet_grid((0, 0, 0), (d, d, d), (n, n, n))
    triangles, tri_tet_map = mu.find_surface(vertices, tets)
    tri_vertices = mu.gather(vertices, tri_tet_map)
    tris_in_tet = mu.apply_map(triangles, tri_tet_map)
    sharp_edges, edge_tri_map = mu.find_sharp_edges(tri_vertices, triangles, 30.0)
    edges_in_tet = mu.apply_map(sharp_edges, mu.gather(tri_tet_map, edge_tri_map))
    nodeset = sim.deformables.point_sets.add(vertices)
    nodeset.add_rotation(-90.0, (1, 0, 0))
    defo = sim.deformables
    defo.lumped_inertia.add(nodeset, tets,
                            LumpedInertiaParams().set_density(1000.0).set_damping(0.5))
    defo.tet_strain.add(nodeset, tets, TetStrainParams().set_youngs_modulus(1e3))
    defo.segment_strain.add(nodeset, edges_in_tet, SegmentStrainParams()
                            .set_section_radius(5e-3).set_youngs_modulus(5e5))
    defo.triangle_strain.add(nodeset, tris_in_tet, TriangleStrainParams()
                             .set_youngs_modulus(1e4).set_strain_limit(0.2)
                             .set_strain_limit_stiffness(100.0))
    defo.discrete_shells.add(nodeset, tris_in_tet, DiscreteShellsParams()
                             .set_stiffness(2e-3).set_flat_rest_angle(True))
    bc = PrescribedPositionsParams().set_stiffness(1e7).set_tolerance(1e-3)
    defo.prescribed_positions.add_inside_aabb(nodeset, (hd, hd, hd), (0.001,) * 3, bc)
    defo.prescribed_positions.add_inside_aabb(nodeset, (-hd, hd, hd), (0.001,) * 3, bc)
    return sim, nodeset


def deformable_and_rigid_collisions(dtype: str, device: str = "cuda", n1: int = 5,
                                    n2: int = 2, mu: float = 1.0):
    """Upstream's deformable_and_rigid_collisions (examples/main.cpp:314-369;
    repo-root examples/scenes.py:214-246): a Soft_Rubber box of side 0.25
    (n1^3 x 5 tets) 1 cm above a fixed rigid floor (2 x 2 x 0.1 m) and a
    stiffer, denser one of side 0.1 (n2^3 x 5 tets) 1 cm above it, IPC
    contact on their surfaces, Coulomb mu on all three pairs. At n1 = 5, n2
    = 2: 625 and 40 tets. Returns (sim, (box 1, box 2, floor) handlers)."""
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.models.interactions.contact import (ContactGlobalParams,
                                                             ContactParams)
    from stark_tpu_torch.presets.presets import VolumeParams

    sim = Simulation(_settings(f"deformable_and_rigid_collisions_{n1}_{n2}", dtype,
                               device, True))
    sim.interactions.contact.set_global_params(
        ContactGlobalParams().set_friction_stick_slide_threshold(0.01)
        .set_min_contact_stiffness(1e8).set_default_contact_thickness(0.001))
    d1, d2, gap = 0.25, 0.1, 0.01
    rubber = VolumeParams.Soft_Rubber()
    rubber.contact.contact_thickness = 0.001 * d1
    rubber.inertia.density = 1e3
    h1 = sim.presets.deformables.add_volume_grid("boxes", (d1,) * 3, (n1,) * 3, rubber)
    h1.point_set.add_displacement((0, 0, 0.5 * d1 + gap))
    rubber2 = VolumeParams.Soft_Rubber()
    rubber2.contact.contact_thickness = 0.001 * d2
    rubber2.inertia.density = 1e4
    rubber2.strain.youngs_modulus = 1e5
    h2 = sim.presets.deformables.add_volume_grid("boxes", (d2,) * 3, (n2,) * 3, rubber2)
    h2.point_set.add_displacement((0.13 * d2, 0.07 * d2, d1 + 0.5 * d2 + 2 * gap))
    d3 = 2.0
    floor = sim.presets.rigidbodies.add_box(
        "floor", 1.0, (d3, d3, 0.05 * d3), ContactParams().set_contact_thickness(0.001 * d3))
    floor.rigidbody.set_translation((0, 0, -0.025 * d3))
    sim.rigidbodies.add_constraint_fix(floor.rigidbody)
    c = sim.interactions.contact
    c.set_friction(floor.contact, h1.contact, mu)
    c.set_friction(floor.contact, h2.contact, mu)
    c.set_friction(h1.contact, h2.contact, mu)
    return sim, (h1, h2, floor)


def simple_grasp(dtype: str, device: str = "cuda", duration: float = 7.0):
    """Upstream's simple_grasp (examples/main.cpp:416-523; repo-root
    examples/scenes.py:272-319), its output calls dropped: a fixed 0.6 m
    hand drives two 0.1 x 0.4 x 0.4 m fingers through prismatic presses
    (+-1 m/s, at most 5 N each) onto a Soft_Rubber cube of side 0.2 (n = 5:
    216 nodes, 625 elasticity-only tets, E = 2e3, 1 kg), sticking friction
    mu = 1.05, contact thickness 1 mm, min contact stiffness 1e7, gravity
    off; gravity blends in to -10 m/s^2 over 2-3 s and mu drops to 0.95
    from 5 s. `duration` is the settings' end time (upstream's 7 s).
    Returns (sim, (cube, hand, left, right, left press, right press))."""
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.maths import blend
    from stark_tpu_torch.models.interactions.contact import ContactGlobalParams
    from stark_tpu_torch.presets.presets import VolumeParams

    s = _settings("simple_grasp", dtype, device, True)
    s.execution.end_simulation_time = duration
    s.simulation.gravity = (0.0, 0.0, 0.0)
    sim = Simulation(s)
    n, d = 5, 0.2
    hd, gap = d / 2, 0.02
    mass, gravity, pressure = 1.0, -10.0, 10.0
    mu_sticking, mu_sliding = 1.05, 0.95
    sim.interactions.contact.set_global_params(
        ContactGlobalParams().set_default_contact_thickness(0.001)
        .set_friction_stick_slide_threshold(0.001).set_min_contact_stiffness(1e7))
    obj_params = VolumeParams.Soft_Rubber()
    obj_params.inertia.density = mass / d ** 3
    obj_params.strain.elasticity_only = True
    obj_params.strain.youngs_modulus = 2e3
    obj = sim.presets.deformables.add_volume_grid("deformable", (d,) * 3, (n,) * 3, obj_params)
    hand = sim.presets.rigidbodies.add_box("hand", mass, (3 * d,) * 3)
    hand.rigidbody.set_translation((0.0, -(3 * hd + hd + gap), 0.0))
    fingers_size = (0.5 * d, 2 * d, 2 * d)
    left = sim.presets.rigidbodies.add_box("finger", mass, fingers_size)
    left.rigidbody.set_translation((-(hd + 0.5 * hd + gap), -gap, 0.0))
    right = sim.presets.rigidbodies.add_box("finger", mass, fingers_size)
    right.rigidbody.set_translation((hd + 0.5 * hd + gap, -gap, 0.0))
    c = sim.interactions.contact
    c.disable_collision(hand.contact, left.contact)
    c.disable_collision(hand.contact, right.contact)
    sim.rigidbodies.add_constraint_fix(hand.rigidbody)
    press_l = sim.rigidbodies.add_constraint_prismatic_press(
        hand.rigidbody, left.rigidbody, (0, 0, 0), (1, 0, 0), 1.0, 0.5 * pressure)
    press_r = sim.rigidbodies.add_constraint_prismatic_press(
        hand.rigidbody, right.rigidbody, (0, 0, 0), (1, 0, 0), -1.0, 0.5 * pressure)
    c.set_friction(left.contact, obj.contact, mu_sticking)
    c.set_friction(right.contact, obj.contact, mu_sticking)
    sim.add_time_event(2.0, 3.0, lambda t: sim.set_gravity(
        (0.0, 0.0, blend(0.0, gravity, 2.0, 3.0, t))))

    def reduce_friction(t):
        c.set_friction(left.contact, obj.contact, mu_sliding)
        c.set_friction(right.contact, obj.contact, mu_sliding)

    sim.add_time_event(5.0, 7.0, reduce_friction)
    return sim, (obj, hand, left, right, press_l, press_r)


def rigid_joint_chain(dtype: str, device: str = "cuda", dt: float = 0.01):
    """Three boxes on one chain of every rigid joint family (the scene of
    tests/test_derivatives.py::test_fd_rigid_constraints): box 0 fixed, a
    point to box 1, a hinge from box 1 to box 2, a distance and distance
    limits, an angle limit, a damped spring, linear and angular velocity
    controllers and a point on an axis; gravity on, no contact. Returns
    (sim, (box 0, box 1, box 2))."""
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.models.rigidbodies.inertia_tensors import inertia_tensor_box

    s = _settings("rigid_joint_chain", dtype, device, False)
    s.simulation.max_time_step_size = dt
    sim = Simulation(s)
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
