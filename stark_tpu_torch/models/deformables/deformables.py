"""Deformables aggregate: one object owning the deformable energy models.

Port of `stark_tpu/models/deformables/deformables.py` for the cloth path:
point sets + lumped inertia + prescribed positions + triangle strain +
discrete shells. Segment strain and tet strain are ROADMAP Queue 1 P7, and
mesh output is P10; those attributes raise NotImplementedError.
"""
from __future__ import annotations

from ..point_dynamics import PointDynamics
from .energies import (EnergyDiscreteShells, EnergyLumpedInertia,
                       EnergyPrescribedPositions, EnergyTriangleStrain)

_LATER = {"segment_strain": "P7", "tet_strain": "P7", "output": "P10"}


class Deformables:
    def __init__(self, stark, dyn: PointDynamics):
        self.point_sets = dyn
        self.lumped_inertia = EnergyLumpedInertia(stark, dyn)
        self.prescribed_positions = EnergyPrescribedPositions(stark, dyn)
        self.triangle_strain = EnergyTriangleStrain(stark, dyn)
        self.discrete_shells = EnergyDiscreteShells(stark, dyn)

    def __getattr__(self, name):
        if name in _LATER:
            raise NotImplementedError(
                f"deformables.{name} is not ported yet (ROADMAP Queue 1 {_LATER[name]})")
        raise AttributeError(name)
