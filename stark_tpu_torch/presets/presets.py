"""Scene-building presets for surfaces.

Port of the surface part of `stark_tpu/presets/presets.py`: `SurfaceParams`
(with the Cotton_Fabric material) and `add_surface_grid` / `add_surface`.
Line and volume presets are ROADMAP Queue 1 P7, rigid-body presets P2, and
contact registration P3. The output label is accepted for API parity; mesh
output (VTK frames) is P10, so no frame files are written.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..models.deformables.energies import (DiscreteShellsParams,
                                           LumpedInertiaParams,
                                           TriangleStrainParams)
from ..utils import mesh_generators as gen


@dataclass
class SurfaceParams:
    inertia: LumpedInertiaParams = field(default_factory=LumpedInertiaParams)
    strain: TriangleStrainParams = field(default_factory=TriangleStrainParams)
    bending: DiscreteShellsParams = field(default_factory=DiscreteShellsParams)

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
    vertices: Optional[np.ndarray] = None
    connectivity: Optional[np.ndarray] = None


class DeformablesPresets:
    def __init__(self, stark, deformables):
        self.stark = stark
        self.deformables = deformables

    def add_surface(self, output_label, vertices, triangles, params: SurfaceParams):
        d = self.deformables
        point_set = d.point_sets.add(vertices)
        inertia = d.lumped_inertia.add(point_set, triangles, params.inertia)
        strain = d.triangle_strain.add(point_set, triangles, params.strain)
        bending = d.discrete_shells.add(point_set, triangles, params.bending)
        return Handlers(point_set=point_set, inertia=inertia, strain=strain,
                        bending=bending, vertices=np.asarray(vertices),
                        connectivity=np.asarray(triangles))

    def add_surface_grid(self, output_label, dim, subdivisions, params: SurfaceParams):
        V, T = gen.generate_triangle_grid((0.0, 0.0), dim, subdivisions)
        return self.add_surface(output_label, V, T, params)


class Presets:
    def __init__(self, stark, deformables):
        self.deformables = DeformablesPresets(stark, deformables)

    @property
    def rigidbodies(self):
        raise NotImplementedError(
            "rigid-body presets are not ported yet (ROADMAP Queue 1 P2)")
