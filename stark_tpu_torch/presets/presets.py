"""Scene-building presets: lines, surfaces, volumes and rigid primitives.

Port of `stark_tpu/presets/presets.py`: the material bundles `LineParams`
(Elastic_Rubberband), `SurfaceParams` (Cotton_Fabric) and `VolumeParams`
(Soft_Rubber); `add_line` / `add_line_as_segments`, `add_surface` /
`add_surface_grid` and `add_volume` / `add_volume_grid`, each registering
its mesh for contact when `settings.simulation.init_frictional_contact` is
on (a volume registers its surface only); and the rigid primitives with
analytic inertia (`add_box`, `add_sphere`, `add_cylinder`, `add_torus`,
`add`), and `add_prescribed_surface` (a surface pinned to its targets). A
non-empty output label registers the mesh with the frame output, as the
JAX package does: a line's segments, a surface's triangles, a volume's
surface triangles and a rigid body's world-space mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..models.deformables.energies import (DiscreteShellsParams,
                                           LumpedInertiaParams,
                                           PrescribedPositionsParams,
                                           SegmentStrainParams, TetStrainParams,
                                           TriangleStrainParams)
from ..models.interactions.contact import ContactParams
from ..models.rigidbodies import inertia_tensors as it
from ..utils import mesh_generators as gen
from ..utils.mesh_utils import (apply_map, find_edges_from_simplices, find_surface,
                                rcm_order)


@dataclass
class LineParams:
    inertia: LumpedInertiaParams = field(default_factory=LumpedInertiaParams)
    strain: SegmentStrainParams = field(default_factory=SegmentStrainParams)
    contact: ContactParams = field(default_factory=ContactParams)

    @staticmethod
    def Elastic_Rubberband() -> "LineParams":
        p = LineParams()
        p.inertia.density = 0.05
        p.inertia.damping = 0.1
        p.strain.elasticity_only = False
        p.strain.section_radius = 0.002
        p.strain.youngs_modulus = 1e4
        p.strain.strain_limit = 0.1
        p.strain.strain_limit_stiffness = 1e5
        p.strain.damping = 1e-4
        return p


@dataclass
class SurfaceParams:
    inertia: LumpedInertiaParams = field(default_factory=LumpedInertiaParams)
    strain: TriangleStrainParams = field(default_factory=TriangleStrainParams)
    bending: DiscreteShellsParams = field(default_factory=DiscreteShellsParams)
    contact: ContactParams = field(default_factory=ContactParams)

    @staticmethod
    def Cotton_Fabric() -> "SurfaceParams":
        p = SurfaceParams()
        p.inertia.density = 0.2
        p.inertia.damping = 0.1
        p.strain.elasticity_only = False
        p.strain.thickness = 0.001
        p.strain.youngs_modulus = 5e3
        p.strain.poissons_ratio = 0.3
        p.strain.strain_limit = 0.1
        p.strain.strain_limit_stiffness = 1e6
        p.strain.damping = 0.1 * p.strain.thickness * p.strain.youngs_modulus
        p.bending.flat_rest_angle = True
        p.bending.stiffness = 1e-6
        p.bending.damping = 0.1 * p.bending.stiffness
        return p


@dataclass
class PrescribedSurfaceParams:
    prescribed: PrescribedPositionsParams = field(default_factory=PrescribedPositionsParams)
    contact: ContactParams = field(default_factory=ContactParams)


@dataclass
class VolumeParams:
    inertia: LumpedInertiaParams = field(default_factory=LumpedInertiaParams)
    strain: TetStrainParams = field(default_factory=TetStrainParams)
    contact: ContactParams = field(default_factory=ContactParams)

    @staticmethod
    def Soft_Rubber() -> "VolumeParams":
        p = VolumeParams()
        p.inertia.density = 1000.0
        p.inertia.damping = 0.1
        p.strain.elasticity_only = False
        p.strain.youngs_modulus = 1e4
        p.strain.poissons_ratio = 0.3
        p.strain.strain_limit = 1.0
        p.strain.strain_limit_stiffness = 1e2
        p.strain.damping = 0.0
        return p


@dataclass
class Handlers:
    """Returned handler bundle (Line/Surface/Volume::Handler)."""
    point_set: object = None
    inertia: object = None
    strain: object = None
    bending: object = None
    prescribed: object = None
    contact: object = None
    vertices: Optional[np.ndarray] = None
    connectivity: Optional[np.ndarray] = None


class DeformablesPresets:
    def __init__(self, stark, deformables, interactions):
        self.stark = stark
        self.deformables = deformables
        self.interactions = interactions

    def _contact_on(self) -> bool:
        return self.stark.settings.simulation.init_frictional_contact

    def add_line(self, output_label, vertices, segments, params: LineParams):
        d = self.deformables
        point_set = d.point_sets.add(vertices)
        inertia = d.lumped_inertia.add(point_set, segments, params.inertia)
        strain = d.segment_strain.add(point_set, segments, params.strain)
        contact = self.interactions.contact.add_edges(
            point_set, segments, params.contact) if self._contact_on() else None
        if output_label:
            d.output.add_segment_mesh(output_label, point_set, segments)
        return Handlers(point_set=point_set, inertia=inertia, strain=strain,
                        contact=contact, vertices=np.asarray(vertices),
                        connectivity=np.asarray(segments))

    def add_line_as_segments(self, output_label, begin, end, n_segments,
                             params: LineParams):
        V, E = gen.generate_segment_line(begin, end, n_segments)
        return self.add_line(output_label, V, E, params)

    def add_surface(self, output_label, vertices, triangles, params: SurfaceParams):
        d = self.deformables
        point_set = d.point_sets.add(vertices)
        inertia = d.lumped_inertia.add(point_set, triangles, params.inertia)
        strain = d.triangle_strain.add(point_set, triangles, params.strain)
        bending = d.discrete_shells.add(point_set, triangles, params.bending)
        contact = self.interactions.contact.add_triangles(
            point_set, triangles, params.contact) if self._contact_on() else None
        if output_label:
            d.output.add_triangle_mesh(output_label, point_set, triangles)
        return Handlers(point_set=point_set, inertia=inertia, strain=strain,
                        bending=bending, contact=contact,
                        vertices=np.asarray(vertices),
                        connectivity=np.asarray(triangles))

    def add_surface_grid(self, output_label, dim, subdivisions, params: SurfaceParams):
        V, T = gen.generate_triangle_grid((0.0, 0.0), dim, subdivisions)
        return self.add_surface(output_label, V, T, params)

    def add_prescribed_surface(self, output_label, vertices, triangles,
                               params: PrescribedSurfaceParams):
        """A surface whose every node is held at its target (no inertia, no
        self-collision)."""
        d = self.deformables
        point_set = d.point_sets.add(vertices)
        prescribed = d.prescribed_positions.add(
            point_set, list(range(point_set.size())), params.prescribed)
        contact = None
        if self._contact_on():
            contact = self.interactions.contact.add_triangles(point_set, triangles,
                                                              params.contact)
            contact.disable_collision(contact)  # no self-collisions
        if output_label:
            d.output.add_triangle_mesh(output_label, point_set, triangles)
        return Handlers(point_set=point_set, prescribed=prescribed, contact=contact,
                        vertices=np.asarray(vertices), connectivity=np.asarray(triangles))

    def add_volume(self, output_label, vertices, tets, params: VolumeParams):
        d = self.deformables
        surface_triangles, tri_to_tet_map = find_surface(vertices, tets)
        point_set = d.point_sets.add(vertices)
        inertia = d.lumped_inertia.add(point_set, tets, params.inertia)
        strain = d.tet_strain.add(point_set, tets, params.strain)
        # a tet mesh registers only its surface for contact
        # (DeformablesPresets.cpp:70-73)
        contact = self.interactions.contact.add_triangles(
            point_set, surface_triangles, params.contact,
            point_set_map=tri_to_tet_map) if self._contact_on() else None
        if output_label:
            d.output.add_triangle_mesh(output_label, point_set,
                                       apply_map(surface_triangles, tri_to_tet_map))
        return Handlers(point_set=point_set, inertia=inertia, strain=strain,
                        contact=contact, vertices=np.asarray(vertices),
                        connectivity=np.asarray(tets))

    def add_volume_grid(self, output_label, dim, subdivisions, params: VolumeParams):
        V, T = gen.generate_tet_grid((0.0, 0.0, 0.0), dim, subdivisions)
        return self.add_volume(output_label, V, T, params)


@dataclass
class RigidBodyPresetHandler:
    rigidbody: object = None
    contact: object = None
    vertices: Optional[np.ndarray] = None
    triangles: Optional[np.ndarray] = None


def _rcm_reorder_mesh(V, T):
    """Reverse-Cuthill-McKee order of a rigid body's LOCAL vertex list (the
    JAX package applies the same ordering; rigid DOFs are per body, so the
    local order is free and a banded one gathers better)."""
    V = np.asarray(V, dtype=np.float64)
    T = np.asarray(T, dtype=np.int64)
    if len(V) == 0 or len(T) == 0:
        return V, T
    perm = rcm_order(find_edges_from_simplices(T, len(V)), len(V))  # new -> old
    inv = np.empty(len(V), dtype=np.int64)
    inv[perm] = np.arange(len(V))
    return V[perm], inv[T]


class RigidBodyPresets:
    """Primitives with analytic inertia tensors (RigidBodyPresets.h:27-50)."""

    def __init__(self, stark, rigidbodies, interactions):
        self.stark = stark
        self.rigidbodies = rigidbodies
        self.interactions = interactions

    def _contact_on(self) -> bool:
        return self.stark.settings.simulation.init_frictional_contact

    def _finish(self, output_label, handler, V, T, contact_params):
        V, T = _rcm_reorder_mesh(V, T)
        contact = None
        if self._contact_on():
            contact = self.interactions.contact.add_triangles(
                handler, T, contact_params, vertices=V)
        if output_label:
            self.rigidbodies.output.add_triangle_mesh(output_label, handler, V, T)
        return RigidBodyPresetHandler(rigidbody=handler, contact=contact,
                                      vertices=V, triangles=T)

    def add(self, output_label, mass, vertices, triangles,
            contact_params: ContactParams = None):
        V = np.asarray(vertices, dtype=np.float64)
        T = np.asarray(triangles, dtype=np.int64)
        I, com, _vol = it.inertia_tensor_from_triangle_mesh(V, T, mass)
        h = self.rigidbodies.add(mass, I)
        h.set_translation(com)
        return self._finish(output_label, h, V - com, T,
                            contact_params or ContactParams())

    def add_box(self, output_label, mass, size, contact_params: ContactParams = None):
        V, T = gen.make_box(size)
        h = self.rigidbodies.add(mass, it.inertia_tensor_box(
            mass, size if not np.isscalar(size) else (size, size, size)))
        return self._finish(output_label, h, V, T, contact_params or ContactParams())

    def add_sphere(self, output_label, mass, radius, subdivisions: int = 2,
                   contact_params: ContactParams = None):
        V, T = gen.make_sphere(radius, subdivisions)
        h = self.rigidbodies.add(mass, it.inertia_tensor_sphere(mass, radius))
        return self._finish(output_label, h, V, T, contact_params or ContactParams())

    def add_cylinder(self, output_label, mass, radius, full_height,
                     slices: int = 16, contact_params: ContactParams = None):
        V, T = gen.make_cylinder(radius, full_height, slices)
        h = self.rigidbodies.add(mass, it.inertia_tensor_cylinder(mass, radius, full_height))
        return self._finish(output_label, h, V, T, contact_params or ContactParams())

    def add_torus(self, output_label, mass, outer_radius, inner_radius,
                  slices: int = 32, stacks: int = 8,
                  contact_params: ContactParams = None):
        V, T = gen.make_torus(outer_radius, inner_radius, slices, stacks)
        h = self.rigidbodies.add(mass, it.inertia_tensor_torus(mass, outer_radius, inner_radius))
        return self._finish(output_label, h, V, T, contact_params or ContactParams())


class Presets:
    def __init__(self, stark, deformables, rigidbodies, interactions):
        self.deformables = DeformablesPresets(stark, deformables, interactions)
        self.rigidbodies = RigidBodyPresets(stark, rigidbodies, interactions)
