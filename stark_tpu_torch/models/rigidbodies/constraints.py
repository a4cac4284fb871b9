"""Rigid body constraints: the global-point and global-direction penalties
and their hardening ladder.

Port of the part of `stark_tpu/models/rigidbodies/constraints.py` that the
fix joint uses (RigidBodyConstraints.h, EnergyRigidBodyConstraints.cpp:
16-398): the two containers, their energies, their violation measures, the
converged-state check with stiffness hardening x2 and the soft
pre-hardening x1.05 at 75% of the tolerance on accepted steps. The other
nine containers (points, hinges, sliders, distances, limits, springs,
motors) are ROADMAP Queue 1 P6.

Direction constraints are written as the displacement between unit
direction vectors; body kinematics x1/d1 come from (v1, w1) by quaternion
time integration inside the energies.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import maths
from ...solver.potential import FamilyData, PotentialFamily

_EPS = 100.0 * np.finfo(np.float64).eps


def _at(arr, idx):
    """arr[idx] for a 0-d index that stays a tensor under vmap."""
    return arr[idx[None]][0]


def rad2deg(x):
    return x * 180.0 / math.pi


class _Container:
    """Storage of one constraint kind (one PotentialFamily)."""

    def __init__(self, model, name):
        self.model = model
        self.name = name
        self.bodies_a: list[int] = []
        self.bodies_b: list[int] = []
        self.stiffness: list[float] = []
        self.tolerance: list[float] = []
        self.is_active: list[float] = []
        self.labels: list[str] = []
        self.vec: dict[str, list[np.ndarray]] = {}
        self.scal: dict[str, list[float]] = {}

    def size(self) -> int:
        return len(self.is_active)

    def _push(self, a, b, stiffness, tolerance, vecs=None, scals=None):
        idx = self.size()
        self.bodies_a.append(a)
        self.bodies_b.append(-1 if b is None else b)
        self.stiffness.append(float(stiffness))
        self.tolerance.append(float(tolerance))
        self.is_active.append(1.0)
        self.labels.append("")
        for k, v in (vecs or {}).items():
            self.vec.setdefault(k, []).append(np.asarray(v, dtype=np.float64))
        for k, v in (scals or {}).items():
            self.scal.setdefault(k, []).append(float(v))
        self.model.stark.mark_dirty(self.name)
        return idx

    def base_rows(self):
        rows = {
            "a": np.asarray(self.bodies_a, dtype=np.int32),
            "b": np.asarray(self.bodies_b, dtype=np.int32),
            "stiffness": np.asarray(self.stiffness),
            "active": np.asarray(self.is_active),
        }
        for k, v in self.vec.items():
            rows[k] = np.asarray(v)
        for k, v in self.scal.items():
            rows[k] = np.asarray(v)
        return rows

    def mark_dirty(self):
        self.model.stark.mark_dirty(self.name)


class EnergyRigidBodyConstraints:
    stiffness_hard_multiplier = 2.0
    stiffness_soft_multiplier = 1.05
    soft_constraint_capacity_hardening_point = 0.75

    def __init__(self, stark, rb, inertia):
        self.stark = stark
        self.rb = rb
        self.inertia = inertia

        stark.callbacks.newton.add_is_converged_state_valid(
            lambda: self._is_converged_state_valid())
        stark.callbacks.add_on_time_step_accepted(lambda: self._on_time_step_accepted())

        self.global_points = _Container(self, "rb_constraint_global_points")
        self.global_directions = _Container(self, "rb_constraint_global_directions")
        gp = stark.global_potential
        gp.add_potential(PotentialFamily("rb_constraint_global_points", 2,
                                         self._e_global_points),
                         lambda: self._prov(self.global_points, "aw"))
        gp.add_potential(PotentialFamily("rb_constraint_global_directions", 1,
                                         self._e_global_directions),
                         lambda: self._prov(self.global_directions, "w"))

    def _prov(self, cont: _Container, kind: str):
        if cont.size() == 0:
            return None
        lay = self.stark.layout
        va = lay.n_soft + 2 * np.asarray(cont.bodies_a, dtype=np.int64)
        conn = np.stack([va, va + 1], axis=1) if kind == "aw" else (va + 1).reshape(-1, 1)
        return FamilyData(conn.astype(np.int32), cont.base_rows())

    # ------------------------------------------------------------------
    # energies
    # ------------------------------------------------------------------
    def _e_global_points(self, u_e, row, glob):
        va, wa = u_e[0], u_e[1]
        a = row["a"]
        p = maths.integrate_loc_point(row["loc"], _at(glob["rb_t0"], a),
                                      _at(glob["rb_q0"], a), va, wa, glob["dt"])
        d = row["target"] - p
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_global_directions(self, u_e, row, glob):
        wa = u_e[0]
        d = maths.integrate_loc_direction(row["d_loc"], _at(glob["rb_q0"], row["a"]),
                                          wa, glob["dt"])
        u = row["target"] - d
        return 0.5 * row["stiffness"] * torch.dot(u, u)

    # ------------------------------------------------------------------
    # host-side violations (under the trial velocities, or at set positions)
    # ------------------------------------------------------------------
    def _get_x1(self, rb, loc, pos_set):
        if pos_set:
            return self.rb.get_position_at(rb, loc)
        return self.rb.get_x1(rb, loc, self.stark.dt)

    def _get_d1(self, rb, loc, pos_set):
        if pos_set:
            return self.rb.get_direction(rb, loc)
        return self.rb.get_d1(rb, loc, self.stark.dt)

    def violation_global_point(self, idx, pos_set=False):
        c = self.global_points
        p = self._get_x1(c.bodies_a[idx], c.vec["loc"][idx], pos_set)
        Cv = np.linalg.norm(p - c.vec["target"][idx])
        return Cv, c.stiffness[idx] * Cv

    def violation_global_direction(self, idx, pos_set=False):
        c = self.global_directions
        d = self._get_d1(c.bodies_a[idx], c.vec["d_loc"][idx], pos_set)
        u = d - c.vec["target"][idx]
        Cv = np.linalg.norm(u)
        force = -c.stiffness[idx] * Cv * u / (Cv + _EPS)
        angle_deg = rad2deg(math.asin(min(1.0, Cv)))
        torque = np.cross(c.vec["target"][idx], force)
        return angle_deg, np.linalg.norm(torque)

    # ------------------------------------------------------------------
    # stiffness ladder (EnergyRigidBodyConstraints.cpp:242-298)
    # ------------------------------------------------------------------
    def _adjust(self, cap: float, multiplier: float, pos_set: bool) -> bool:
        valid = True
        for cont, violation in ((self.global_points, self.violation_global_point),
                                (self.global_directions,
                                 self.violation_global_direction)):
            for i in range(cont.size()):
                C, _ = violation(i, pos_set)
                if cont.is_active[i] > 0.0 and abs(C) > cap * cont.tolerance[i]:
                    valid = False
                    cont.stiffness[i] *= multiplier
                    cont.mark_dirty()
        return valid

    def _is_converged_state_valid(self) -> bool:
        valid = self._adjust(1.0, self.stiffness_hard_multiplier, pos_set=False)
        if not valid:
            self.stark.output.print_with_new_line(
                "Rigid body constraints are not within tolerance. Hardening constraint stiffness.")
        return valid

    def _on_time_step_accepted(self):
        self._adjust(self.soft_constraint_capacity_hardening_point,
                     self.stiffness_soft_multiplier, pos_set=True)
