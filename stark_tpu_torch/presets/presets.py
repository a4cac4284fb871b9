"""Scene-building presets: surfaces and rigid primitives.

Port of the surface and rigid-body parts of `stark_tpu/presets/presets.py`:
`SurfaceParams` (with the Cotton_Fabric material), `add_surface_grid` /
`add_surface` (registering the surface for contact when
`settings.simulation.init_frictional_contact` is on), and the rigid
primitives with analytic inertia (`add_box`, `add_sphere`, `add_cylinder`,
`add_torus`, `add`). Line and volume presets are ROADMAP Queue 1 P7. Output
labels are accepted for API parity; mesh output (VTK frames) is P10.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..models.deformables.energies import (DiscreteShellsParams,
                                           LumpedInertiaParams,
                                           TriangleStrainParams)
from ..models.interactions.contact import ContactParams
from ..models.rigidbodies import inertia_tensors as it
from ..utils import mesh_generators as gen
from ..utils.mesh_utils import find_edges_from_simplices, rcm_order


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
class Handlers:
    """Returned handler bundle (Surface::Handler)."""
    point_set: object = None
    inertia: object = None
    strain: object = None
    bending: object = None
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

    def add_surface(self, output_label, vertices, triangles, params: SurfaceParams):
        d = self.deformables
        point_set = d.point_sets.add(vertices)
        inertia = d.lumped_inertia.add(point_set, triangles, params.inertia)
        strain = d.triangle_strain.add(point_set, triangles, params.strain)
        bending = d.discrete_shells.add(point_set, triangles, params.bending)
        contact = self.interactions.contact.add_triangles(
            point_set, triangles, params.contact) if self._contact_on() else None
        return Handlers(point_set=point_set, inertia=inertia, strain=strain,
                        bending=bending, contact=contact,
                        vertices=np.asarray(vertices),
                        connectivity=np.asarray(triangles))

    def add_surface_grid(self, output_label, dim, subdivisions, params: SurfaceParams):
        V, T = gen.generate_triangle_grid((0.0, 0.0), dim, subdivisions)
        return self.add_surface(output_label, V, T, params)


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
