"""Constraint handlers and factories: the 11 primitive constraints and the
joints built from them.

Port of `stark_tpu/models/rigidbodies/joints.py` (rigidbody_constraints_ui.h,
RigidBodies.cpp:43-304): the fluent handlers, and the factories that
convert global points and directions to each body's local frame at add
time; the derived joints (fix, attachment, point with angle limit, hinge
with and without angle limit, slider, prismatic slider and press, spring
with limits, motor) are compositions of the primitives.
"""
from __future__ import annotations

import numpy as np

from ... import maths
from .constraints import EnergyRigidBodyConstraints, opening_distance_of_angle


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

    def _set_scal(self, key, value):
        self.cont.scal[key][self.idx] = float(value)
        self.cont.mark_dirty()
        return self

    def _set_vec(self, key, value):
        self.cont.vec[key][self.idx] = np.asarray(value, dtype=np.float64)
        self.cont.mark_dirty()
        return self


class _DistanceToleranceMixin:
    def get_tolerance_in_m(self) -> float:
        return self.cont.tolerance[self.idx]

    def set_tolerance_in_m(self, tol: float):
        self.cont.tolerance[self.idx] = tol
        return self


class _AngleToleranceMixin:
    def get_tolerance_in_deg(self) -> float:
        return self.cont.tolerance[self.idx]

    def set_tolerance_in_deg(self, tol: float):
        self.cont.tolerance[self.idx] = tol
        return self


class RBCGlobalPointHandler(_BaseHandler, _DistanceToleranceMixin):
    def get_violation_in_m_and_force(self):
        return self.model.violation_global_point(self.idx, pos_set=True)

    def set_target_position(self, p_glob):
        return self._set_vec("target", p_glob)


class RBCGlobalDirectionHandler(_BaseHandler, _AngleToleranceMixin):
    def get_violation_in_deg_and_torque(self):
        return self.model.violation_global_direction(self.idx, pos_set=True)

    def set_target_direction(self, d_glob):
        d = np.asarray(d_glob, dtype=np.float64)
        return self._set_vec("target", d / np.linalg.norm(d))

    def set_rotation(self, R):
        """Rotate the BODY-LOCAL locked direction (the reference's
        set_rotation, rigidbody_constraints_ui.h:91 sets
        d_loc = R * d_loc_rest): the global target stays put, so the body
        itself must rotate by R^-1 to satisfy the constraint. Animated fix
        constraints (set_transformation) rely on this convention."""
        rest = self.cont.vec["d_loc_rest"][self.idx]
        return self._set_vec("d_loc", np.asarray(R, np.float64) @ rest)


class RBCPointHandler(_BaseHandler, _DistanceToleranceMixin):
    def get_violation_in_m_and_force(self):
        return self.model.violation_point(self.idx, pos_set=True)


class RBCPointOnAxisHandler(_BaseHandler, _DistanceToleranceMixin):
    def get_violation_in_m_and_force(self):
        return self.model.violation_point_on_axis(self.idx, pos_set=True)


class RBCDistanceHandler(_BaseHandler, _DistanceToleranceMixin):
    def get_signed_violation_in_m_and_force(self):
        return self.model.violation_distance(self.idx, pos_set=True)

    def set_target_distance(self, d: float):
        return self._set_scal("target_distance", d)

    def get_target_distance(self) -> float:
        return self.cont.scal["target_distance"][self.idx]


class RBCDistanceLimitHandler(_BaseHandler, _DistanceToleranceMixin):
    def get_signed_violation_in_m_and_force(self):
        return self.model.violation_distance_limits(self.idx, pos_set=True)

    def set_limit_distances(self, min_distance: float, max_distance: float):
        self._set_scal("min_distance", min_distance)
        return self._set_scal("max_distance", max_distance)


class RBCDirectionHandler(_BaseHandler, _AngleToleranceMixin):
    def get_violation_in_deg_and_torque(self):
        return self.model.violation_direction(self.idx, pos_set=True)


class RBCAngleLimitHandler(_BaseHandler, _AngleToleranceMixin):
    def get_violation_in_deg_and_torque(self):
        return self.model.violation_angle_limit(self.idx, pos_set=True)

    def set_limit_angle_deg(self, angle_deg: float):
        return self._set_scal("max_distance", opening_distance_of_angle(angle_deg))


class RBCDampedSpringHandler(_BaseHandler):
    def get_signed_spring_displacement_in_m_and_force(self):
        return self.model.violation_spring(self.idx)

    def get_signed_damper_velocity_and_force(self):
        return self.model.damper_velocity_and_force(self.idx)

    def set_rest_length(self, l: float):
        return self._set_scal("rest_length", l)

    def set_damping(self, d: float):
        return self._set_scal("damping", d)


class RBCLinearVelocityHandler(_BaseHandler):
    def get_signed_velocity_violation_and_force(self):
        return self.model.violation_linear_velocity(self.idx)

    def set_target_velocity(self, v: float):
        return self._set_scal("target_v", v)

    def set_max_force(self, f: float):
        return self._set_scal("max_force", f)

    def set_direction(self, d_glob, body_a):
        return self._set_vec("da_loc", body_a.transform_global_to_local_direction(d_glob))


class RBCAngularVelocityHandler(_BaseHandler):
    def get_signed_angular_velocity_violation_in_deg_per_s_and_torque(self):
        return self.model.violation_angular_velocity(self.idx)

    def set_target_angular_velocity(self, w: float):
        return self._set_scal("target_w", w)

    def set_max_torque(self, t: float):
        return self._set_scal("max_torque", t)


# ---------------------------------------------------------------------------
# derived joint handlers (compositions, rigidbody_constraints_ui.h:400-869)
# ---------------------------------------------------------------------------

class RBCFixHandler:
    def __init__(self, body, anchor, z_lock, x_lock):
        self.body = body
        self.anchor = anchor
        self.z_lock = z_lock
        self.x_lock = x_lock

    def get_anchor_point(self): return self.anchor
    def get_z_lock(self): return self.z_lock
    def get_x_lock(self): return self.x_lock

    def enable(self):
        self.anchor.enable(); self.z_lock.enable(); self.x_lock.enable()
        return self

    def disable(self):
        self.anchor.disable(); self.z_lock.disable(); self.x_lock.disable()
        return self

    def set_transformation(self, t, angle_deg=0.0, axis=(0, 0, 1)):
        """Reposition the fixed target (used by scripted rigid animations).

        Matches the reference convention (rigidbody_constraints_ui.h:
        369-379): the anchor target moves to `t` in WORLD space, while the
        rotation is applied to the LOCKED LOCAL DIRECTIONS — the global
        direction targets never move, so a positive angle here rotates the
        BODY by the inverse rotation (verified against the reference's box
        quaternion trajectory in tests/test_trajectory_parity.py)."""
        R = maths.axis_angle_rotation(np.deg2rad(angle_deg), axis)
        self.anchor.set_target_position(t)
        self.z_lock.set_rotation(R)
        self.x_lock.set_rotation(R)
        return self


class RBCAttachmentHandler:
    def __init__(self, body_a, body_b, point, z_lock, x_lock):
        self.body_a, self.body_b = body_a, body_b
        self.point = point
        self.z_lock = z_lock
        self.x_lock = x_lock

    def get_point(self): return self.point
    def get_z_lock(self): return self.z_lock
    def get_x_lock(self): return self.x_lock

    def enable(self):
        self.point.enable(); self.z_lock.enable(); self.x_lock.enable()
        return self

    def disable(self):
        self.point.disable(); self.z_lock.disable(); self.x_lock.disable()
        return self


class RBCPointWithAngleLimitHandler:
    def __init__(self, body_a, body_b, point, angle_limit):
        self.point = point
        self.angle_limit = angle_limit

    def get_point(self): return self.point
    def get_angle_limit(self): return self.angle_limit


class RBCHingeJointHandler:
    def __init__(self, body_a, body_b, point, direction):
        self.point = point
        self.direction = direction

    def get_point(self): return self.point
    def get_direction_lock(self): return self.direction

    def enable(self):
        self.point.enable(); self.direction.enable()
        return self

    def disable(self):
        self.point.disable(); self.direction.disable()
        return self


class RBCHingeJointWithAngleLimitHandler:
    def __init__(self, body_a, body_b, hinge, angle_limit):
        self.hinge = hinge
        self.angle_limit = angle_limit

    def get_hinge(self): return self.hinge
    def get_angle_limit(self): return self.angle_limit


class RBCSliderHandler:
    def __init__(self, body_a, body_b, point_on_axis, dir_lock):
        self.point_on_axis = point_on_axis
        self.dir_lock = dir_lock

    def get_point_on_axis(self): return self.point_on_axis
    def get_direction_lock(self): return self.dir_lock


class RBCPrismaticSliderHandler:
    def __init__(self, body_a, body_b, slider, dir_lock):
        self.slider = slider
        self.dir_lock = dir_lock

    def get_slider(self): return self.slider
    def get_direction_lock(self): return self.dir_lock


class RBCSpringWithLimitsHandler:
    def __init__(self, body_a, body_b, spring, distance_limits):
        self.spring = spring
        self.distance_limits = distance_limits

    def get_spring(self): return self.spring
    def get_distance_limits(self): return self.distance_limits


class RBCPrismaticPressHandler:
    def __init__(self, body_a, body_b, prismatic_slider, linear_velocity):
        self.prismatic_slider = prismatic_slider
        self.linear_velocity = linear_velocity

    def get_prismatic_slider(self): return self.prismatic_slider
    def get_linear_velocity(self): return self.linear_velocity

    def set_target_velocity(self, v: float):
        self.linear_velocity.set_target_velocity(v)
        return self

    def set_max_force(self, f: float):
        self.linear_velocity.set_max_force(f)
        return self


class RBCMotorHandler:
    def __init__(self, body_a, body_b, hinge, angular_velocity):
        self.hinge = hinge
        self.angular_velocity = angular_velocity

    def get_hinge(self): return self.hinge
    def get_angular_velocity(self): return self.angular_velocity

    def set_target_angular_velocity(self, w: float):
        self.angular_velocity.set_target_angular_velocity(w)
        return self

    def set_max_torque(self, t: float):
        self.angular_velocity.set_max_torque(t)
        return self


# ---------------------------------------------------------------------------
# factories (RigidBodies.cpp:43-304)
# ---------------------------------------------------------------------------

class ConstraintFactories:
    def __init__(self, rigidbodies):
        self.rigidbodies = rigidbodies

    @property
    def m(self) -> EnergyRigidBodyConstraints:
        return self.rigidbodies.constraints

    @property
    def _k(self):
        return self.rigidbodies.default_stiffness

    @property
    def _tol_m(self):
        return self.rigidbodies.default_tolerance_in_m

    @property
    def _tol_deg(self):
        return self.rigidbodies.default_tolerance_in_deg

    def add_constraint_global_point(self, body, p_glob):
        c = self.m.global_points
        idx = c._push(body.get_idx(), None, self._k, self._tol_m,
                      vecs={"loc": body.transform_global_to_local_point(p_glob),
                            "target": p_glob})
        return RBCGlobalPointHandler(self.m, c, idx)

    def add_constraint_global_direction(self, body, d_glob):
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.global_directions
        d_loc = body.transform_global_to_local_direction(d)
        # d_loc_rest: creation-time local direction, the base that
        # set_rotation re-rotates (reference d_loc_rest, ui.h:91)
        idx = c._push(body.get_idx(), None, self._k, self._tol_deg,
                      vecs={"d_loc": d_loc, "target": d,
                            "d_loc_rest": d_loc})
        return RBCGlobalDirectionHandler(self.m, c, idx)

    def add_constraint_point(self, body_a, body_b, p_glob):
        c = self.m.points
        idx = c._push(body_a.get_idx(), body_b.get_idx(), self._k, self._tol_m,
                      vecs={"a_loc": body_a.transform_global_to_local_point(p_glob),
                            "b_loc": body_b.transform_global_to_local_point(p_glob)})
        return RBCPointHandler(self.m, c, idx)

    def add_constraint_point_on_axis(self, body_a, body_b, p_glob, d_glob):
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.point_on_axes
        idx = c._push(body_a.get_idx(), body_b.get_idx(), self._k, self._tol_m,
                      vecs={"a_loc": body_a.transform_global_to_local_point(p_glob),
                            "da_loc": body_a.transform_global_to_local_direction(d),
                            "b_loc": body_b.transform_global_to_local_point(p_glob)})
        return RBCPointOnAxisHandler(self.m, c, idx)

    def add_constraint_distance(self, body_a, body_b, a_glob, b_glob):
        c = self.m.distances
        target = float(np.linalg.norm(np.asarray(a_glob) - np.asarray(b_glob)))
        idx = c._push(body_a.get_idx(), body_b.get_idx(), self._k, self._tol_m,
                      vecs={"a_loc": body_a.transform_global_to_local_point(a_glob),
                            "b_loc": body_b.transform_global_to_local_point(b_glob)},
                      scals={"target_distance": target})
        return RBCDistanceHandler(self.m, c, idx)

    def add_constraint_distance_limits(self, body_a, body_b, a_glob, b_glob,
                                       min_distance, max_distance):
        d = float(np.linalg.norm(np.asarray(a_glob) - np.asarray(b_glob)))
        if d < min_distance or d > max_distance:
            raise ValueError("rest distance out of limits")
        c = self.m.distance_limits
        idx = c._push(body_a.get_idx(), body_b.get_idx(), self._k, self._tol_m,
                      vecs={"a_loc": body_a.transform_global_to_local_point(a_glob),
                            "b_loc": body_b.transform_global_to_local_point(b_glob)},
                      scals={"min_distance": min_distance, "max_distance": max_distance})
        return RBCDistanceLimitHandler(self.m, c, idx)

    def add_constraint_direction(self, body_a, body_b, d_glob):
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.directions
        idx = c._push(body_a.get_idx(), body_b.get_idx(), self._k, self._tol_deg,
                      vecs={"da_loc": body_a.transform_global_to_local_direction(d),
                            "db_loc": body_b.transform_global_to_local_direction(d)})
        return RBCDirectionHandler(self.m, c, idx)

    def add_constraint_angle_limit(self, body_a, body_b, d_glob, admissible_angle_deg):
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.angle_limits
        idx = c._push(body_a.get_idx(), body_b.get_idx(), self._k, self._tol_deg,
                      vecs={"da_loc": body_a.transform_global_to_local_direction(d),
                            "db_loc": body_b.transform_global_to_local_direction(d)},
                      scals={"max_distance": opening_distance_of_angle(admissible_angle_deg)})
        return RBCAngleLimitHandler(self.m, c, idx)

    def add_constraint_spring(self, body_a, body_b, a_glob, b_glob, stiffness,
                              damping=0.0):
        c = self.m.damped_springs
        rest = float(np.linalg.norm(np.asarray(a_glob) - np.asarray(b_glob)))
        idx = c._push(body_a.get_idx(), body_b.get_idx(), stiffness, 0.0,
                      vecs={"a_loc": body_a.transform_global_to_local_point(a_glob),
                            "b_loc": body_b.transform_global_to_local_point(b_glob)},
                      scals={"rest_length": rest, "damping": damping})
        return RBCDampedSpringHandler(self.m, c, idx)

    def add_constraint_linear_velocity(self, body_a, body_b, d_glob, target_v,
                                       max_abs_force, delay=0.01):
        if max_abs_force < 0.0:
            raise ValueError("negative max force")
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.linear_velocity
        idx = c._push(body_a.get_idx(), body_b.get_idx(), 0.0, 0.0,
                      vecs={"da_loc": body_a.transform_global_to_local_direction(d)},
                      scals={"target_v": target_v, "max_force": max_abs_force,
                             "delay": delay})
        return RBCLinearVelocityHandler(self.m, c, idx)

    def add_constraint_angular_velocity(self, body_a, body_b, d_glob, target_w,
                                        max_abs_torque, delay=0.01):
        if max_abs_torque < 0.0:
            raise ValueError("negative max torque")
        d = np.asarray(d_glob, dtype=np.float64)
        d = d / np.linalg.norm(d)
        c = self.m.angular_velocity
        idx = c._push(body_a.get_idx(), body_b.get_idx(), 0.0, 0.0,
                      vecs={"da_loc": body_a.transform_global_to_local_direction(d)},
                      scals={"target_w": target_w, "max_torque": max_abs_torque,
                             "delay": delay})
        return RBCAngularVelocityHandler(self.m, c, idx)

    # -- derived (RigidBodies.cpp:220-304) --
    def add_constraint_fix(self, body):
        anchor = self.add_constraint_global_point(body, body.get_translation())
        z_lock = self.add_constraint_global_direction(body, np.array([0.0, 0.0, 1.0]))
        x_lock = self.add_constraint_global_direction(body, np.array([1.0, 0.0, 0.0]))
        return RBCFixHandler(body, anchor, z_lock, x_lock)

    def add_constraint_attachment(self, body_a, body_b):
        point = self.add_constraint_point(
            body_a, body_b, 0.5 * (body_a.get_translation() + body_b.get_translation()))
        z_lock = self.add_constraint_direction(body_a, body_b, np.array([0.0, 0.0, 1.0]))
        x_lock = self.add_constraint_direction(body_a, body_b, np.array([1.0, 0.0, 0.0]))
        return RBCAttachmentHandler(body_a, body_b, point, z_lock, x_lock)

    def add_constraint_point_with_angle_limit(self, body_a, body_b, p_glob, d_glob,
                                              admissible_angle_deg):
        point = self.add_constraint_point(body_a, body_b, p_glob)
        angle = self.add_constraint_angle_limit(body_a, body_b, d_glob, admissible_angle_deg)
        return RBCPointWithAngleLimitHandler(body_a, body_b, point, angle)

    def add_constraint_hinge(self, body_a, body_b, p_glob, d_glob):
        point = self.add_constraint_point(body_a, body_b, p_glob)
        direction = self.add_constraint_direction(body_a, body_b, d_glob)
        return RBCHingeJointHandler(body_a, body_b, point, direction)

    def add_constraint_hinge_with_angle_limit(self, body_a, body_b, p_glob, d_glob,
                                              admissible_angle_deg):
        d = np.asarray(d_glob, dtype=np.float64)
        u = (np.cross(d, [1.0, 0, 0]) if abs(np.dot(d, [1.0, 0, 0])) < 0.5
             else np.cross(d, [0, 1.0, 0]))
        hinge = self.add_constraint_hinge(body_a, body_b, p_glob, d_glob)
        angle = self.add_constraint_angle_limit(body_a, body_b, u, admissible_angle_deg)
        return RBCHingeJointWithAngleLimitHandler(body_a, body_b, hinge, angle)

    def add_constraint_slider(self, body_a, body_b, p_glob, d_glob):
        poa = self.add_constraint_point_on_axis(body_a, body_b, p_glob, d_glob)
        dl = self.add_constraint_direction(body_a, body_b, d_glob)
        return RBCSliderHandler(body_a, body_b, poa, dl)

    def add_constraint_prismatic_slider(self, body_a, body_b, p_glob, d_glob):
        d = np.asarray(d_glob, dtype=np.float64)
        u = (np.cross(d, [1.0, 0, 0]) if abs(np.dot(d, [1.0, 0, 0])) < 0.5
             else np.cross(d, [0, 1.0, 0]))
        slider = self.add_constraint_slider(body_a, body_b, p_glob, d_glob)
        dl = self.add_constraint_direction(body_a, body_b, u)
        return RBCPrismaticSliderHandler(body_a, body_b, slider, dl)

    def add_constraint_spring_with_limits(self, body_a, body_b, a_glob, b_glob,
                                          stiffness, min_length, max_length, damping=0.0):
        spring = self.add_constraint_spring(body_a, body_b, a_glob, b_glob, stiffness, damping)
        limits = self.add_constraint_distance_limits(body_a, body_b, a_glob, b_glob,
                                                     min_length, max_length)
        return RBCSpringWithLimitsHandler(body_a, body_b, spring, limits)

    def add_constraint_prismatic_press(self, body_a, body_b, p_glob, d_glob,
                                       target_v, max_force, delay=0.01):
        ps = self.add_constraint_prismatic_slider(body_a, body_b, p_glob, d_glob)
        lv = self.add_constraint_linear_velocity(body_a, body_b, d_glob, target_v,
                                                 max_force, delay)
        return RBCPrismaticPressHandler(body_a, body_b, ps, lv)

    def add_constraint_motor(self, body_a, body_b, p_glob, d_glob, target_w,
                             max_torque, delay=0.01):
        hinge = self.add_constraint_hinge(body_a, body_b, p_glob, d_glob)
        av = self.add_constraint_angular_velocity(body_a, body_b, d_glob, target_w,
                                                  max_torque, delay)
        return RBCMotorHandler(body_a, body_b, hinge, av)
