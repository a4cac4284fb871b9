"""Deformables aggregate: one object owning the deformable energy models.

Port of `stark_tpu/models/deformables/deformables.py`: point sets + lumped
inertia + prescribed positions + segment strain + triangle strain +
discrete shells + tet strain, registered in the JAX package's order. Mesh
output is ROADMAP Queue 1 P10; that attribute raises NotImplementedError.
"""
from __future__ import annotations

from ..point_dynamics import PointDynamics
from .energies import (EnergyDiscreteShells, EnergyLumpedInertia,
                       EnergyPrescribedPositions, EnergySegmentStrain,
                       EnergyTetStrain, EnergyTriangleStrain)

_LATER = {"output": "P10"}


class Deformables:
    def __init__(self, stark, dyn: PointDynamics):
        self.point_sets = dyn
        self.lumped_inertia = EnergyLumpedInertia(stark, dyn)
        self.prescribed_positions = EnergyPrescribedPositions(stark, dyn)
        self.segment_strain = EnergySegmentStrain(stark, dyn)
        self.triangle_strain = EnergyTriangleStrain(stark, dyn)
        self.discrete_shells = EnergyDiscreteShells(stark, dyn)
        self.tet_strain = EnergyTetStrain(stark, dyn)

    def __getattr__(self, name):
        if name in _LATER:
            raise NotImplementedError(
                f"deformables.{name} is not ported yet (ROADMAP Queue 1 {_LATER[name]})")
        raise AttributeError(name)
