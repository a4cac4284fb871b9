"""Rigid body state container and kinematics.

Port of `stark_tpu/models/rigid_dynamics.py`. Per body: t0/t1, the unit
quaternions q0/q1 (w, x, y, z), R0/R1, v0/w0, a, aa, force, torque, kept on
the host in numpy between steps. The DOFs are the next-step velocities v1 and
w1 (two 3-blocks per body, solver/dofs.py), tensors on the simulation's
device. `before_time_step` zeroes v1/w1; `on_time_step_accepted` integrates
the quaternion and rolls the state (RigidBodyDynamics.cpp:9-15, 136-166).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import maths


class RigidBodyDynamics:
    def __init__(self, stark):
        self._stark = stark
        self.labels: List[str] = []
        self.t0 = np.zeros((0, 3))
        self.t1 = np.zeros((0, 3))
        self.q0 = np.zeros((0, 4))
        self.q1 = np.zeros((0, 4))
        self.R0 = np.zeros((0, 3, 3))
        self.R1 = np.zeros((0, 3, 3))
        self.v0 = np.zeros((0, 3))
        self.w0 = np.zeros((0, 3))
        self.a = np.zeros((0, 3))
        self.aa = np.zeros((0, 3))
        self.force = np.zeros((0, 3))
        self.torque = np.zeros((0, 3))
        self.frozen = False
        self.dtype = torch.float64
        self.device = torch.device("cpu")
        # device trial velocities (the DOFs) and their host mirrors, primed
        # from the solver's one per-step pull
        self._v1 = None
        self._w1 = None
        self._host_v1 = None
        self._host_w1 = None

        stark.callbacks.add_before_time_step(self._before_time_step)
        stark.callbacks.add_on_time_step_accepted(self._on_time_step_accepted)

    @property
    def v1(self):
        return self._v1

    @v1.setter
    def v1(self, value):
        self._v1 = value
        self._host_v1 = None

    @property
    def w1(self):
        return self._w1

    @w1.setter
    def w1(self, value):
        self._w1 = value
        self._host_w1 = None

    # -- scene building --
    def add(self, label: str = "") -> int:
        if self.frozen:
            raise RuntimeError("cannot add rigid bodies after the simulation started")
        idx = self.t0.shape[0]
        self.t0 = np.vstack([self.t0, np.zeros(3)])
        self.t1 = np.vstack([self.t1, np.zeros(3)])
        self.q0 = np.vstack([self.q0, [1.0, 0, 0, 0]])
        self.q1 = np.vstack([self.q1, [1.0, 0, 0, 0]])
        self.R0 = np.concatenate([self.R0, np.eye(3)[None]])
        self.R1 = np.concatenate([self.R1, np.eye(3)[None]])
        for name in ("v0", "w0", "a", "aa", "force", "torque"):
            setattr(self, name, np.vstack([getattr(self, name), np.zeros(3)]))
        self.labels.append(label or f"rb_{idx}")
        return idx

    @property
    def n_bodies(self) -> int:
        return self.t0.shape[0]

    def freeze(self, dtype: torch.dtype, device: torch.device):
        self.frozen = True
        self.dtype = dtype
        self.device = device
        self.v1 = torch.zeros((self.n_bodies, 3), dtype=dtype, device=device)
        self.w1 = torch.zeros((self.n_bodies, 3), dtype=dtype, device=device)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # -- glob contribution --
    def glob_entries(self):
        return {"rb_t0": self._t(self.t0), "rb_q0": self._t(self.q0),
                "rb_v0": self._t(self.v0), "rb_w0": self._t(self.w0),
                "rb_a": self._t(self.a), "rb_aa": self._t(self.aa),
                "rb_force": self._t(self.force), "rb_torque": self._t(self.torque)}

    def prime_host(self, v1_np: np.ndarray, w1_np: np.ndarray):
        """Feed the host mirrors from the solver's one per-step pull."""
        self._host_v1 = v1_np
        self._host_w1 = w1_np

    # -- host-side kinematics under the current trial velocities --
    def host_v1(self) -> np.ndarray:
        if self._v1 is None:
            return np.zeros((self.n_bodies, 3))
        if self._host_v1 is None:
            self._host_v1 = self._v1.cpu().numpy()
        return self._host_v1

    def host_w1(self) -> np.ndarray:
        if self._w1 is None:
            return np.zeros((self.n_bodies, 3))
        if self._host_w1 is None:
            self._host_w1 = self._w1.cpu().numpy()
        return self._host_w1

    def _host_quat_int(self, rb: int, dt: float) -> np.ndarray:
        return maths.np_quat_time_integration(self.q0[rb], self.host_w1()[rb], dt)

    def get_x1(self, rb: int, x_loc, dt: float) -> np.ndarray:
        R1 = maths.np_quat_to_rotation(self._host_quat_int(rb, dt))
        return self.t0[rb] + dt * self.host_v1()[rb] + R1 @ np.asarray(x_loc)

    def get_d1(self, rb: int, d_loc, dt: float) -> np.ndarray:
        R1 = maths.np_quat_to_rotation(self._host_quat_int(rb, dt))
        return R1 @ np.asarray(d_loc)

    def get_position_at(self, rb: int, x_loc) -> np.ndarray:
        return self.t1[rb] + self.R1[rb] @ np.asarray(x_loc)

    def get_velocity_at(self, rb: int, x_loc) -> np.ndarray:
        r = self.get_position_at(rb, x_loc) - self.t1[rb]
        return self.host_v1()[rb] + np.cross(self.host_w1()[rb], r)

    def get_direction(self, rb: int, d_loc) -> np.ndarray:
        return self.R1[rb] @ np.asarray(d_loc)

    # -- callbacks --
    def _before_time_step(self):
        if self.n_bodies == 0 or not self.frozen:
            return
        self.v1 = torch.zeros_like(self.v1)
        self.w1 = torch.zeros_like(self.w1)

    def _on_time_step_accepted(self):
        if self.n_bodies == 0:
            return
        dt = self._stark.dt
        v1 = self.host_v1()
        w1 = self.host_w1()
        self.t1 = self.t0 + dt * v1
        self.q1 = maths.np_quat_time_integration(self.q0, w1, dt)
        self.R1 = maths.np_quat_to_rotation(self.q1)
        self.t0 = self.t1.copy()
        self.q0 = self.q1.copy()
        self.R0 = self.R1.copy()
        self.v0 = v1.copy()
        self.w0 = w1.copy()
