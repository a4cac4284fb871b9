"""Rigid body constraints: the 11 soft-penalty containers and their
hardening ladder.

Port of `stark_tpu/models/rigidbodies/constraints.py` (RigidBodyConstraints.h,
EnergyRigidBodyConstraints.cpp:16-398): the containers, their energies,
their violation measures, the converged-state check with stiffness
hardening x2 and the soft pre-hardening x1.05 at 75% of the tolerance on
accepted steps.

Direction constraints are written as the displacement between unit
direction vectors; body kinematics x1/d1 come from (v1, w1) by quaternion
time integration inside the energies. The velocity controllers are the
C1, force-capped `_c1_controller_energy` (RigidBodyConstraints.h:56-76).

On the card the energies' e, g and H come from kernel P (global points and
directions, csrc/egh_inertia.cu), kernel T (points, point on axis,
distances, distance limits, damped springs) and kernel U (directions,
angle limits, linear and angular velocity; both csrc/egh_joints.cu); each
family below registers the tables its kernel entry reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import maths
from ...ops import egh
from ...solver.potential import FamilyData, PotentialFamily
from ...utils.mesh_utils import deg2rad, rad2deg

_EPS = 100.0 * np.finfo(np.float64).eps


def _at(arr, idx):
    """arr[idx] for a 0-d index that stays a tensor under vmap."""
    return arr[idx[None]][0]


def _x1(loc, glob, body, v1, w1):
    return maths.integrate_loc_point(loc, _at(glob["rb_t0"], body), _at(glob["rb_q0"], body),
                                     v1, w1, glob["dt"])


def _d1(loc, glob, body, w1):
    return maths.integrate_loc_direction(loc, _at(glob["rb_q0"], body), w1, glob["dt"])


def _c1_controller_energy(da1, va1, vb1, target_v, max_force, delay, dt):
    """C1 force-capped velocity controller (RigidBodyConstraints.h:56-76)."""
    v = torch.dot(da1, vb1 - va1)
    k = max_force / delay
    eps = delay / 2.0
    dv = v - target_v
    E_c = 0.5 * k * dv * dv * dt
    E_r = max_force * (dv - eps) * dt
    E_l = -E_r
    return torch.where(dv < -delay, E_l, torch.where(dv < delay, E_c, E_r))


def _c1_controller_violation_and_force(da1, va1, vb1, target_v, max_force, delay):
    v = float(np.dot(da1, vb1 - va1))
    k = max_force / delay
    dv = v - target_v
    if dv < -delay:
        return dv, -max_force
    if dv < delay:
        return dv, -k * dv
    return dv, max_force


def opening_distance_of_angle(angle_deg: float) -> float:
    return math.sqrt(2.0 - 2.0 * math.cos(deg2rad(angle_deg)))


def angle_of_opening_distance(d: float) -> float:
    return rad2deg(math.acos(max(-1.0, min(1.0, (2.0 - d * d) / 2.0))))


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


# the tables each kernel entry reads, in its order: ("r", key) a row table,
# ("g", key) a global. P: csrc/egh_inertia.cu; T and U: csrc/egh_joints.cu
_R = lambda *keys: [("r", k) for k in keys]
_G = lambda *keys: [("g", k) for k in keys]
_T_HEAD = _R("a", "b", "a_loc", "b_loc") + _G("rb_t0", "rb_q0", "dt") + _R("stiffness")
_U_HEAD = _R("a", "b", "da_loc", "db_loc") + _G("rb_q0", "dt") + _R("stiffness")
_READS = {
    "global_points": _R("a", "loc", "target", "stiffness") + _G("rb_t0", "rb_q0", "dt"),
    "global_directions": _R("a", "d_loc", "target", "stiffness") + _G("rb_q0", "dt"),
    "points": _T_HEAD,
    "point_on_axis": _T_HEAD + _R("da_loc"),
    "distances": _T_HEAD + _R("target_distance"),
    "distance_limits": _T_HEAD + _R("min_distance", "max_distance"),
    "damped_spring": _T_HEAD + _R("rest_length", "damping"),
    "directions": _U_HEAD,
    "angle_limits": _U_HEAD + _R("max_distance"),
    "linear_velocity": _R("a", "da_loc") + _G("rb_q0", "dt")
    + _R("target_v", "max_force", "delay"),
    "angular_velocity": _R("a", "da_loc") + _G("rb_q0", "dt")
    + _R("target_w", "max_torque", "delay"),
}
# (attribute, family name, arity, conn layout, kernel source, kernel entry),
# in the JAX package's registration order
_FAMILIES = (
    ("global_points", "rb_constraint_global_points", 2, "aw", "egh_inertia", "global_points"),
    ("global_directions", "rb_constraint_global_directions", 1, "w", "egh_inertia",
     "global_directions"),
    ("points", "rb_constraint_points", 4, "awbw", "egh_joints", "points"),
    ("point_on_axes", "rb_constraint_point_on_axis", 4, "awbw", "egh_joints", "point_on_axis"),
    ("distances", "rb_constraint_distances", 4, "awbw", "egh_joints", "distances"),
    ("distance_limits", "rb_constraint_distance_limits", 4, "awbw", "egh_joints",
     "distance_limits"),
    ("directions", "rb_constraint_directions", 2, "ww", "egh_joints", "directions"),
    ("angle_limits", "rb_constraint_angle_limits", 2, "ww", "egh_joints", "angle_limits"),
    ("damped_springs", "rb_constraint_damped_spring", 4, "awbw", "egh_joints", "damped_spring"),
    ("linear_velocity", "rb_constraint_linear_velocity", 3, "vvw", "egh_joints",
     "linear_velocity"),
    ("angular_velocity", "rb_constraint_angular_velocity", 2, "ww", "egh_joints",
     "angular_velocity"),
)


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

        gp = stark.global_potential
        for attr, name, arity, kind, source, entry in _FAMILIES:
            cont = _Container(self, name)
            setattr(self, attr, cont)
            gp.add_potential(
                PotentialFamily(name, arity, getattr(self, "_e_" + entry),
                                kernel=egh.kernel(source, entry, _READS[entry])),
                lambda cont=cont, kind=kind: self._prov(cont, kind))

    def _prov(self, cont: _Container, kind: str):
        if cont.size() == 0:
            return None
        lay = self.stark.layout
        va = lay.n_soft + 2 * np.asarray(cont.bodies_a, dtype=np.int64)
        vb = lay.n_soft + 2 * np.maximum(np.asarray(cont.bodies_b, dtype=np.int64), 0)
        cols = {"aw": (va, va + 1), "w": (va + 1,), "awbw": (va, va + 1, vb, vb + 1),
                "ww": (va + 1, vb + 1), "vvw": (va, vb, va + 1)}[kind]
        return FamilyData(np.stack(cols, axis=1).astype(np.int32), cont.base_rows())

    # ------------------------------------------------------------------
    # energies (EnergyRigidBodyConstraints.cpp:30-240)
    # ------------------------------------------------------------------
    def _e_global_points(self, u_e, row, glob):
        p = _x1(row["loc"], glob, row["a"], u_e[0], u_e[1])
        d = row["target"] - p
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_global_directions(self, u_e, row, glob):
        d = _d1(row["d_loc"], glob, row["a"], u_e[0])
        u = row["target"] - d
        return 0.5 * row["stiffness"] * torch.dot(u, u)

    def _ab1(self, u_e, row, glob):
        """x1 of the row's points on bodies a and b ([va, wa, vb, wb])."""
        return (_x1(row["a_loc"], glob, row["a"], u_e[0], u_e[1]),
                _x1(row["b_loc"], glob, row["b"], u_e[2], u_e[3]))

    def _e_points(self, u_e, row, glob):
        a1, b1 = self._ab1(u_e, row, glob)
        d = b1 - a1
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_point_on_axis(self, u_e, row, glob):
        a1, b1 = self._ab1(u_e, row, glob)
        da1 = _d1(row["da_loc"], glob, row["a"], u_e[1])
        # sq_distance_point_line(b1; a1, a1 + da1) (models/distances.h)
        cr = maths.cross(b1 - a1, da1)
        sqd = torch.dot(cr, cr) / torch.dot(da1, da1)
        return 0.5 * row["stiffness"] * sqd

    def _e_distances(self, u_e, row, glob):
        a1, b1 = self._ab1(u_e, row, glob)
        l = maths.safe_norm(b1 - a1)
        return 0.5 * row["stiffness"] * (row["target_distance"] - l) ** 2

    def _e_distance_limits(self, u_e, row, glob):
        a1, b1 = self._ab1(u_e, row, glob)
        k = row["stiffness"]
        l = maths.safe_norm(b1 - a1)
        zero = torch.zeros_like(l)
        E_min = torch.where(l < row["min_distance"], k * (row["min_distance"] - l) ** 2 / 2.0,
                            zero)
        E_max = torch.where(l > row["max_distance"], k * (l - row["max_distance"]) ** 2 / 2.0,
                            zero)
        return E_min + E_max

    def _dab1(self, u_e, row, glob):
        """d1 of the row's directions on bodies a and b ([wa, wb])."""
        return (_d1(row["da_loc"], glob, row["a"], u_e[0]),
                _d1(row["db_loc"], glob, row["b"], u_e[1]))

    def _e_directions(self, u_e, row, glob):
        da, db = self._dab1(u_e, row, glob)
        u = db - da
        return 0.5 * row["stiffness"] * torch.dot(u, u)

    def _e_angle_limits(self, u_e, row, glob):
        da, db = self._dab1(u_e, row, glob)
        l = maths.safe_norm(db - da, 1e-30)
        k = row["stiffness"]
        return torch.where(l > row["max_distance"], k * (l - row["max_distance"]) ** 3 / 3.0,
                           torch.zeros_like(l))

    def _e_damped_spring(self, u_e, row, glob):
        a1, b1 = self._ab1(u_e, row, glob)
        a, b = row["a"], row["b"]
        a0 = _at(glob["rb_t0"], a) + maths.quat_to_rotation(_at(glob["rb_q0"], a)) @ row["a_loc"]
        b0 = _at(glob["rb_t0"], b) + maths.quat_to_rotation(_at(glob["rb_q0"], b)) @ row["b_loc"]
        l1 = maths.safe_norm(b1 - a1)
        l0 = maths.safe_norm(b0 - a0)
        E_spring = 0.5 * row["stiffness"] * (l1 - row["rest_length"]) ** 2
        E_damper = 0.5 * row["damping"] * ((l1 - l0) / glob["dt"]) ** 2
        return E_spring + E_damper

    def _e_linear_velocity(self, u_e, row, glob):
        va, vb, wa = u_e[0], u_e[1], u_e[2]
        da1 = _d1(row["da_loc"], glob, row["a"], wa)
        return _c1_controller_energy(da1, va, vb, row["target_v"], row["max_force"],
                                     row["delay"], glob["dt"])

    def _e_angular_velocity(self, u_e, row, glob):
        wa, wb = u_e[0], u_e[1]
        da1 = _d1(row["da_loc"], glob, row["a"], wa)
        return _c1_controller_energy(da1, wa, wb, row["target_w"], row["max_torque"],
                                     row["delay"], glob["dt"])

    # ------------------------------------------------------------------
    # host-side violations (under the trial velocities, or at set positions;
    # EnergyRigidBodyConstraints.cpp:300-398)
    # ------------------------------------------------------------------
    def _get_x1(self, rb, loc, pos_set):
        if pos_set:
            return self.rb.get_position_at(rb, loc)
        return self.rb.get_x1(rb, loc, self.stark.dt)

    def _get_d1(self, rb, loc, pos_set):
        if pos_set:
            return self.rb.get_direction(rb, loc)
        return self.rb.get_d1(rb, loc, self.stark.dt)

    def _points_ab(self, c, idx, pos_set):
        return (self._get_x1(c.bodies_a[idx], c.vec["a_loc"][idx], pos_set),
                self._get_x1(c.bodies_b[idx], c.vec["b_loc"][idx], pos_set))

    def _directions_ab(self, c, idx, pos_set):
        return (self._get_d1(c.bodies_a[idx], c.vec["da_loc"][idx], pos_set),
                self._get_d1(c.bodies_b[idx], c.vec["db_loc"][idx], pos_set))

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

    def violation_point(self, idx, pos_set=False):
        c = self.points
        a1, b1 = self._points_ab(c, idx, pos_set)
        Cv = np.linalg.norm(b1 - a1)
        return Cv, c.stiffness[idx] * Cv

    def violation_point_on_axis(self, idx, pos_set=False):
        c = self.point_on_axes
        a1, b1 = self._points_ab(c, idx, pos_set)
        da1 = self._get_d1(c.bodies_a[idx], c.vec["da_loc"][idx], pos_set)
        cr = np.cross(b1 - a1, da1)
        Cv = math.sqrt(np.dot(cr, cr) / np.dot(da1, da1))
        return Cv, c.stiffness[idx] * Cv

    def violation_distance(self, idx, pos_set=False):
        c = self.distances
        a1, b1 = self._points_ab(c, idx, pos_set)
        Cv = np.linalg.norm(b1 - a1) - c.scal["target_distance"][idx]
        return Cv, -c.stiffness[idx] * Cv

    def violation_distance_limits(self, idx, pos_set=False):
        c = self.distance_limits
        a1, b1 = self._points_ab(c, idx, pos_set)
        d = np.linalg.norm(b1 - a1)
        if d < c.scal["min_distance"][idx]:
            Cv = d - c.scal["min_distance"][idx]
            return Cv, -c.stiffness[idx] * Cv
        if d > c.scal["max_distance"][idx]:
            Cv = d - c.scal["max_distance"][idx]
            return Cv, -c.stiffness[idx] * Cv
        return 0.0, 0.0

    def violation_direction(self, idx, pos_set=False):
        c = self.directions
        da, db = self._directions_ab(c, idx, pos_set)
        u = db - da
        Cv = np.linalg.norm(u)
        force = c.stiffness[idx] * Cv * u / (Cv + _EPS)
        angle_deg = rad2deg(math.asin(min(1.0, Cv)))
        return angle_deg, np.linalg.norm(np.cross(da, force))

    def violation_angle_limit(self, idx, pos_set=False):
        c = self.angle_limits
        da, db = self._directions_ab(c, idx, pos_set)
        u = db - da
        d = np.linalg.norm(u)
        md = c.scal["max_distance"][idx]
        if d > md:
            Cv = d - md
            force = c.stiffness[idx] * Cv ** 2 * u / (d + _EPS)
            return angle_of_opening_distance(Cv), np.linalg.norm(np.cross(da, force))
        return 0.0, 0.0

    def violation_spring(self, idx):
        c = self.damped_springs
        a1, b1 = self._points_ab(c, idx, True)
        Cv = np.linalg.norm(b1 - a1) - c.scal["rest_length"][idx]
        return Cv, -c.stiffness[idx] * Cv

    def damper_velocity_and_force(self, idx):
        c = self.damped_springs
        a, b = c.bodies_a[idx], c.bodies_b[idx]
        a1, b1 = self._points_ab(c, idx, True)
        va1 = self.rb.get_velocity_at(a, c.vec["a_loc"][idx])
        vb1 = self.rb.get_velocity_at(b, c.vec["b_loc"][idx])
        r1 = b1 - a1
        r1 = r1 / np.linalg.norm(r1)
        dv = float(np.dot(vb1 - va1, r1))
        return dv, -c.scal["damping"][idx] * dv

    def violation_linear_velocity(self, idx):
        c = self.linear_velocity
        a, b = c.bodies_a[idx], c.bodies_b[idx]
        da1 = self.rb.get_direction(a, c.vec["da_loc"][idx])
        v1 = self.rb.host_v1()
        return _c1_controller_violation_and_force(
            da1, v1[a], v1[b], c.scal["target_v"][idx], c.scal["max_force"][idx],
            c.scal["delay"][idx])

    def violation_angular_velocity(self, idx):
        c = self.angular_velocity
        a, b = c.bodies_a[idx], c.bodies_b[idx]
        da1 = self.rb.get_direction(a, c.vec["da_loc"][idx])
        w1 = self.rb.host_w1()
        Cv, t = _c1_controller_violation_and_force(
            da1, w1[a], w1[b], c.scal["target_w"][idx], c.scal["max_torque"][idx],
            c.scal["delay"][idx])
        return rad2deg(Cv), t

    # ------------------------------------------------------------------
    # stiffness ladder (EnergyRigidBodyConstraints.cpp:242-298): the eight
    # position and direction containers, in the JAX package's order; the
    # springs and velocity controllers are not checked. The trial velocities
    # are read from the card once per check (rigid_dynamics.host_v1/_w1).
    # ------------------------------------------------------------------
    def _adjust(self, cap: float, multiplier: float, pos_set: bool) -> bool:
        valid = True
        for cont, violation in ((self.global_points, self.violation_global_point),
                                (self.global_directions, self.violation_global_direction),
                                (self.points, self.violation_point),
                                (self.point_on_axes, self.violation_point_on_axis),
                                (self.distances, self.violation_distance),
                                (self.distance_limits, self.violation_distance_limits),
                                (self.directions, self.violation_direction),
                                (self.angle_limits, self.violation_angle_limit)):
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
