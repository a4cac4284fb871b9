"""Rigid body inertia energies (linear and angular).

Port of `stark_tpu/models/rigidbodies/inertia.py`
(EnergyRigidBodyInertia.cpp:13-104):
  Linear:  E = 0.5 m |v1-v0|^2 + 0.5 m |v1|^2 d dt - dt (m (a+g) + f).v1
  Angular: E = 0.5 (w1-w0)^T J (w1-w0) + 0.5 w1^T J w1 d dt - dt (J aa + t).w1
with J rotated to world space from R0 before each step, and a quasistatic
switch that drops the inertial parts.
"""
from __future__ import annotations

import numpy as np
import torch

from ...solver.potential import FamilyData, PotentialFamily


def _at(arr, idx):
    """arr[idx] for a 0-d index that stays a tensor under vmap."""
    return arr[idx[None]][0]


class EnergyRigidBodyInertia:
    NAME_LIN = "EnergyRigidBodyInertia_Linear"
    NAME_ANG = "EnergyRigidBodyInertia_Angular"

    def __init__(self, stark, rb):
        self.stark = stark
        self.rb = rb
        self.mass: list[float] = []
        self.J_loc: list[np.ndarray] = []
        self.linear_damping: list[float] = []
        self.angular_damping: list[float] = []
        self.is_quasistatic: list[float] = []
        self.J0_glob = np.zeros((0, 3, 3))

        stark.callbacks.add_before_time_step(self._before_time_step)
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME_LIN, 1, self._energy_linear, psd=True),
            self._provider_lin)
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME_ANG, 1, self._energy_angular, psd=True),
            self._provider_ang)

    @property
    def _layout(self):
        return self.stark.layout

    def _energy_linear(self, u_e, row, glob):
        v1 = u_e[0]
        b = row["body"]
        dt = glob["dt"]
        v0 = _at(glob["rb_v0"], b)
        a = _at(glob["rb_a"], b)
        f = _at(glob["rb_force"], b)
        m = row["mass"]
        dev = v1 - v0
        E_inertia = 0.5 * m * torch.dot(dev, dev) \
            + 0.5 * m * torch.dot(v1, v1) * row["damping"] * dt
        f_ext = m * (a + glob["gravity"]) + f
        E_ext = -dt * torch.dot(f_ext, v1)
        return E_ext + torch.where(row["is_quasistatic"] > 0.5,
                                   torch.zeros_like(E_inertia), E_inertia)

    def _energy_angular(self, u_e, row, glob):
        w1 = u_e[0]
        b = row["body"]
        dt = glob["dt"]
        w0 = _at(glob["rb_w0"], b)
        aa = _at(glob["rb_aa"], b)
        t = _at(glob["rb_torque"], b)
        J = _at(glob["rb_J0glob"], b)
        dev = w1 - w0
        E_inertia = 0.5 * (torch.dot(dev, J @ dev)
                           + torch.dot(w1, J @ w1) * row["damping"] * dt)
        t_ext = J @ aa + t
        E_ext = -dt * torch.dot(t_ext, w1)
        return E_ext + torch.where(row["is_quasistatic"] > 0.5,
                                   torch.zeros_like(E_inertia), E_inertia)

    def _provider_base(self, block_fn):
        n = len(self.mass)
        if n == 0:
            return None
        bodies = np.arange(n, dtype=np.int32)
        conn = np.asarray([block_fn(b) for b in range(n)], dtype=np.int32).reshape(-1, 1)
        return conn, bodies

    def _provider_lin(self):
        out = self._provider_base(self._layout.rigid_v_block)
        if out is None:
            return None
        conn, bodies = out
        rows = {"body": bodies, "mass": np.asarray(self.mass),
                "damping": np.asarray(self.linear_damping),
                "is_quasistatic": np.asarray(self.is_quasistatic)}
        return FamilyData(conn, rows)

    def _provider_ang(self):
        out = self._provider_base(self._layout.rigid_w_block)
        if out is None:
            return None
        conn, bodies = out
        rows = {"body": bodies,
                "damping": np.asarray(self.angular_damping),
                "is_quasistatic": np.asarray(self.is_quasistatic)}
        return FamilyData(conn, rows)

    def add(self, rb_idx: int, mass: float, inertia_loc):
        if rb_idx != len(self.mass):
            raise RuntimeError("non-consecutive rigid body added to inertia model")
        self.mass.append(float(mass))
        self.J_loc.append(np.asarray(inertia_loc, dtype=np.float64).reshape(3, 3))
        self.linear_damping.append(0.0)
        self.angular_damping.append(0.0)
        self.is_quasistatic.append(0.0)

    def glob_entries(self):
        return {"rb_J0glob": torch.as_tensor(self.J0_glob, dtype=self.rb.dtype,
                                             device=self.rb.device)}

    def _before_time_step(self):
        n = len(self.mass)
        if n == 0:
            return
        R0 = self.rb.R0[:n]
        J = np.stack(self.J_loc)
        self.J0_glob = np.einsum("bij,bjk,blk->bil", R0, J, R0)

    def get_mass(self, rb_idx: int) -> float:
        return self.mass[rb_idx]

    def get_inertia_loc(self, rb_idx: int) -> np.ndarray:
        return self.J_loc[rb_idx]

    def set_damping(self, rb_idx: int, linear: float, angular: float):
        self.linear_damping[rb_idx] = linear
        self.angular_damping[rb_idx] = angular
        self.stark.mark_dirty(self.NAME_LIN)
        self.stark.mark_dirty(self.NAME_ANG)

    def set_quasistatic(self, rb_idx: int, value: bool):
        self.is_quasistatic[rb_idx] = 1.0 if value else 0.0
        self.stark.mark_dirty(self.NAME_LIN)
        self.stark.mark_dirty(self.NAME_ANG)
