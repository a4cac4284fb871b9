"""Constraint handlers and factories: global point, global direction and the
fix joint built from them.

Port of the corresponding part of `stark_tpu/models/rigidbodies/joints.py`
(rigidbody_constraints_ui.h, RigidBodies.cpp:43-304). Every other factory
(points, hinges, sliders, distances, limits, springs, motors, attachments)
raises NotImplementedError naming ROADMAP Queue 1 P6.
"""
from __future__ import annotations

import numpy as np

from ... import maths
from .constraints import EnergyRigidBodyConstraints

P6 = "ROADMAP Queue 1 P6 (rigid constraints other than the fix joint)"


class _BaseHandler:
    def __init__(self, model: EnergyRigidBodyConstraints, cont, idx: int):
        self.model = model
        self.cont = cont
        self.idx = idx

    def get_idx(self) -> int:
        return self.idx

    def enable(self):
        self.cont.is_active[self.idx] = 1.0
        self.cont.mark_dirty()
        return self

    def disable(self):
        self.cont.is_active[self.idx] = 0.0
        self.cont.mark_dirty()
        return self

    def is_enabled(self) -> bool:
        return self.cont.is_active[self.idx] > 0.0

    def set_stiffness(self, k: float):
        self.cont.stiffness[self.idx] = k
        self.cont.mark_dirty()
        return self

    def get_stiffness(self) -> float:
        return self.cont.stiffness[self.idx]

    def set_label(self, label: str):
        self.cont.labels[self.idx] = label
        return self

    def get_label(self) -> str:
        return self.cont.labels[self.idx]

    def _set_vec(self, key, value):
        self.cont.vec[key][self.idx] = np.asarray(value, dtype=np.float64)
        self.cont.mark_dirty()
        return self


class RBCGlobalPointHandler(_BaseHandler):
    def get_tolerance_in_m(self) -> float:
        return self.cont.tolerance[self.idx]

    def set_tolerance_in_m(self, tol: float):
        self.cont.tolerance[self.idx] = tol
        return self

    def get_violation_in_m_and_force(self):
        return self.model.violation_global_point(self.idx, pos_set=True)

    def set_target_position(self, p_glob):
        return self._set_vec("target", p_glob)


class RBCGlobalDirectionHandler(_BaseHandler):
    def get_tolerance_in_deg(self) -> float:
        return self.cont.tolerance[self.idx]

    def set_tolerance_in_deg(self, tol: float):
        self.cont.tolerance[self.idx] = tol
        return self

    def get_violation_in_deg_and_torque(self):
        return self.model.violation_global_direction(self.idx, pos_set=True)

    def set_target_direction(self, d_glob):
        d = np.asarray(d_glob, dtype=np.float64)
        return self._set_vec("target", d / np.linalg.norm(d))

    def set_rotation(self, R):
        """Rotate the BODY-LOCAL locked direction (d_loc = R d_loc_rest,
        rigidbody_constraints_ui.h:91): the global target stays, so the body
        must turn by R^-1 to satisfy the constraint."""
        rest = self.cont.vec["d_loc_rest"][self.idx]
        return self._set_vec("d_loc", np.asarray(R, np.float64) @ rest)


class RBCFixHandler:
    def __init__(self, body, anchor, z_lock, x_lock):
        self.body = body
        self.anchor = anchor
        self.z_lock = z_lock
        self.x_lock = x_lock

    def get_anchor_point(self):
        return self.anchor

    def get_z_lock(self):
        return self.z_lock

    def get_x_lock(self):
        return self.x_lock

    def enable(self):
        self.anchor.enable(); self.z_lock.enable(); self.x_lock.enable()
        return self

    def disable(self):
        self.anchor.disable(); self.z_lock.disable(); self.x_lock.disable()
        return self

    def set_transformation(self, t, angle_deg=0.0, axis=(0, 0, 1)):
        """Move the fixed target: the anchor goes to `t` in WORLD space; the
        rotation turns the locked LOCAL directions (the global targets stay),
        so a positive angle turns the body by the inverse rotation — the
        reference's convention (rigidbody_constraints_ui.h:369-379), the one
        the spinning-box golden needs."""
        R = maths.axis_angle_rotation(np.deg2rad(angle_deg), axis)
        self.anchor.set_target_position(t)
        self.z_lock.set_rotation(R)
        self.x_lock.set_rotation(R)
        return self


class ConstraintFactories:
    def __init__(self, rigidbodies):
        self.rigidbodies = rigidbodies

    @property
    def m(self) -> EnergyRigidBodyConstraints:
        return self.rigidbodies.constraints

    def add_constraint_global_point(self, body, p_glob):
        rbs = self.rigidbodies
        c = self.m.global_points
        idx = c._push(body.get_idx(), None, rbs.default_stiffness,
                      rbs.default_tolerance_in_m,
                      vecs={"loc": body.transform_global_to_local_point(p_glob),
                            "target": p_glob})
        return RBCGlobalPointHandler(self.m, c, idx)

    def add_constraint_global_direction(self, body, d_glob):
        rbs = self.rigidbodies
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.global_directions
        d_loc = body.transform_global_to_local_direction(d)
        idx = c._push(body.get_idx(), None, rbs.default_stiffness,
                      rbs.default_tolerance_in_deg,
                      vecs={"d_loc": d_loc, "target": d, "d_loc_rest": d_loc})
        return RBCGlobalDirectionHandler(self.m, c, idx)

    def add_constraint_fix(self, body):
        anchor = self.add_constraint_global_point(body, body.get_translation())
        z_lock = self.add_constraint_global_direction(body, np.array([0.0, 0.0, 1.0]))
        x_lock = self.add_constraint_global_direction(body, np.array([1.0, 0.0, 0.0]))
        return RBCFixHandler(body, anchor, z_lock, x_lock)

    def __getattr__(self, name):
        if name.startswith("add_constraint_"):
            raise NotImplementedError(f"{name}: {P6}")
        raise AttributeError(name)
