"""RigidBodies aggregate and the per-body fluent handler.

Port of `stark_tpu/models/rigidbodies/rigidbodies.py` (RigidBodies.h,
RigidBodyHandler.h). Constraint factories forward to joints.py. Rigid mesh
output (VTK frames) is ROADMAP Queue 1 P10: output labels are accepted and
nothing is written.
"""
from __future__ import annotations

import numpy as np

from ... import maths
from ..rigid_dynamics import RigidBodyDynamics
from .constraints import EnergyRigidBodyConstraints
from .inertia import EnergyRigidBodyInertia
from .joints import ConstraintFactories


class RigidBodyHandler:
    def __init__(self, rigidbodies: "RigidBodies", idx: int):
        self.rigidbodies = rigidbodies
        self.rb = rigidbodies.rb
        self._idx = idx

    def get_idx(self) -> int:
        return self._idx

    @property
    def idx(self) -> int:
        return self._idx

    # -- state setters --
    def set_translation(self, t):
        i = self._idx
        self.rb.t0[i] = self.rb.t1[i] = np.asarray(t, dtype=np.float64)
        return self

    def set_rotation(self, angle_deg: float = None, axis=None, R=None, q=None):
        i = self._idx
        if q is not None:
            q = np.asarray(q, dtype=np.float64)
            q = q / np.linalg.norm(q)
            R = maths.np_quat_to_rotation(q)
        elif R is None:
            R = maths.axis_angle_rotation(np.deg2rad(angle_deg), axis)
        self.rb.R0[i] = self.rb.R1[i] = R
        self.rb.q0[i] = self.rb.q1[i] = maths.rotation_to_quat(R)
        return self

    def add_rotation(self, angle_deg: float, axis, pivot=None):
        i = self._idx
        R = maths.axis_angle_rotation(np.deg2rad(angle_deg), axis)
        if pivot is not None:
            pivot = np.asarray(pivot)
            self.rb.t0[i] = R @ (self.rb.t0[i] - pivot) + pivot
            self.rb.t1[i] = self.rb.t0[i]
        newR = R @ self.rb.R0[i]
        self.rb.R0[i] = self.rb.R1[i] = newR
        self.rb.q0[i] = self.rb.q1[i] = maths.rotation_to_quat(newR)
        return self

    def add_translation(self, t):
        i = self._idx
        self.rb.t0[i] += np.asarray(t)
        self.rb.t1[i] = self.rb.t0[i]
        return self

    def set_velocity(self, v):
        self.rb.v0[self._idx] = np.asarray(v, dtype=np.float64)
        return self

    def set_angular_velocity(self, w):
        self.rb.w0[self._idx] = np.asarray(w, dtype=np.float64)
        return self

    def set_acceleration(self, a):
        self.rb.a[self._idx] = np.asarray(a, dtype=np.float64)
        return self

    def set_angular_acceleration(self, aa):
        self.rb.aa[self._idx] = np.asarray(aa, dtype=np.float64)
        return self

    def set_force(self, f):
        self.rb.force[self._idx] = np.asarray(f, dtype=np.float64)
        return self

    def set_torque(self, t):
        self.rb.torque[self._idx] = np.asarray(t, dtype=np.float64)
        return self

    def add_force_at_centroid(self, f):
        self.rb.force[self._idx] += np.asarray(f, dtype=np.float64)
        return self

    def add_force_at(self, f, p_glob):
        f = np.asarray(f, dtype=np.float64)
        r = np.asarray(p_glob) - self.rb.t1[self._idx]
        self.rb.force[self._idx] += f
        self.rb.torque[self._idx] += np.cross(r, f)
        return self

    def add_torque(self, t):
        self.rb.torque[self._idx] += np.asarray(t, dtype=np.float64)
        return self

    def get_label(self) -> str:
        return self.rb.labels[self._idx]

    def set_damping(self, linear: float = 0.0, angular: float = 0.0):
        self.rigidbodies.inertia.set_damping(self._idx, linear, angular)
        return self

    # -- getters --
    def get_translation(self) -> np.ndarray:
        return self.rb.t1[self._idx].copy()

    def get_rotation_matrix(self) -> np.ndarray:
        return self.rb.R1[self._idx].copy()

    def get_quaternion(self) -> np.ndarray:
        return self.rb.q1[self._idx].copy()

    def get_velocity(self) -> np.ndarray:
        return self.rb.host_v1()[self._idx] if self.rb.frozen else self.rb.v0[self._idx].copy()

    def get_angular_velocity(self) -> np.ndarray:
        return self.rb.host_w1()[self._idx] if self.rb.frozen else self.rb.w0[self._idx].copy()

    def get_mass(self) -> float:
        return self.rigidbodies.inertia.get_mass(self._idx)

    def get_local_inertia_tensor(self) -> np.ndarray:
        return self.rigidbodies.inertia.get_inertia_loc(self._idx)

    # -- coordinate transforms --
    def transform_local_to_global_point(self, p_loc) -> np.ndarray:
        return self.rb.get_position_at(self._idx, p_loc)

    def transform_local_to_global_direction(self, d_loc) -> np.ndarray:
        return self.rb.get_direction(self._idx, d_loc)

    def transform_global_to_local_point(self, p_glob) -> np.ndarray:
        i = self._idx
        return self.rb.R1[i].T @ (np.asarray(p_glob) - self.rb.t1[i])

    def transform_global_to_local_direction(self, d_glob) -> np.ndarray:
        return self.rb.R1[self._idx].T @ np.asarray(d_glob)

    def get_position_at(self, x_loc) -> np.ndarray:
        return self.rb.get_position_at(self._idx, x_loc)

    def get_velocity_at(self, x_loc) -> np.ndarray:
        return self.rb.get_velocity_at(self._idx, x_loc)

    def exit_if_not_valid(self, where=""):
        if self._idx < 0 or self._idx >= self.rb.n_bodies:
            raise RuntimeError(f"invalid RigidBodyHandler in {where}")


class RigidBodies:
    def __init__(self, stark, rb: RigidBodyDynamics):
        self.stark = stark
        self.rb = rb
        self.inertia = EnergyRigidBodyInertia(stark, rb)
        self.constraints = EnergyRigidBodyConstraints(stark, rb, self.inertia)
        self._factories = ConstraintFactories(self)
        self.default_stiffness = 1e6
        self.default_tolerance_in_m = 0.001
        self.default_tolerance_in_deg = 1.0

    def add(self, mass: float, inertia_local, label: str = "") -> RigidBodyHandler:
        idx = self.rb.add(label)
        self.inertia.add(idx, mass, inertia_local)
        return RigidBodyHandler(self, idx)

    def set_default_constraint_stiffness(self, s):
        self.default_stiffness = s

    def set_default_constraint_distance_tolerance(self, t):
        self.default_tolerance_in_m = t

    def set_default_constraint_angle_tolerance(self, t):
        self.default_tolerance_in_deg = t

    def get_default_constraint_stiffness(self):
        return self.default_stiffness

    def get_default_constraint_distance_tolerance(self):
        return self.default_tolerance_in_m

    def get_default_constraint_angle_tolerance(self):
        return self.default_tolerance_in_deg

    def __getattr__(self, name):
        # add_constraint_* go to the factories (RigidBodies.h:44-183)
        if name.startswith("add_constraint_"):
            return getattr(self._factories, name)
        raise AttributeError(name)
