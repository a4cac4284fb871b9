"""Deformable nodal state container.

Port of `stark_tpu/models/point_dynamics.py`. All deformable nodes of all
objects live in one flat array family (X, x0, x1, v0, v1, a, f) with
per-object intervals. Registers two callbacks: zero v1 before each step,
and on accept x1 = x0 + dt*v1, x0 <- x1, v0 <- v1.

Scene building appends host-side (numpy); `freeze()` moves the arrays onto
the simulation's torch device once shapes are final.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class PointSetHandler:
    """Per-object view into the flat node arrays (PointSetHandler.h)."""

    def __init__(self, dyn: "PointDynamics", idx: int):
        self._dyn = dyn
        self._idx = idx

    @property
    def idx(self) -> int:
        return self._idx

    def size(self) -> int:
        b, e = self._dyn.intervals[self._idx]
        return e - b

    def get_begin(self) -> int:
        return self._dyn.intervals[self._idx][0]

    def get_global_index(self, i: int) -> int:
        b, e = self._dyn.intervals[self._idx]
        if not 0 <= i < e - b:
            raise IndexError(f"point {i} out of range for set of size {e - b}")
        return b + i

    def get_global_indices(self, idx):
        b = self._dyn.intervals[self._idx][0]
        return np.asarray(idx, dtype=np.int32) + b

    def all_global_indices(self) -> np.ndarray:
        b, e = self._dyn.intervals[self._idx]
        return np.arange(b, e, dtype=np.int32)

    def get_position(self, i: int) -> np.ndarray:
        return self._dyn.host_x(self.get_global_index(i))

    def get_positions(self) -> np.ndarray:
        b, e = self._dyn.intervals[self._idx]
        return self._dyn.host_x_all()[b:e]

    def get_rest_positions(self) -> np.ndarray:
        b, e = self._dyn.intervals[self._idx]
        return self._dyn.host_X()[b:e]

    def get_velocities(self) -> np.ndarray:
        b, e = self._dyn.intervals[self._idx]
        if self._dyn.frozen:
            return self._dyn.host_v1()[b:e]
        return self._dyn._v1_host[b:e]

    def set_velocities(self, v) -> None:
        b, e = self._dyn.intervals[self._idx]
        v = np.asarray(v, dtype=np.float64).reshape(e - b, 3)
        if self._dyn.frozen:
            vt = torch.as_tensor(v, dtype=self._dyn.v1.dtype,
                                 device=self._dyn.v1.device)
            v1 = self._dyn.v1.clone()
            v1[b:e] = vt
            self._dyn.v1 = v1
            v0 = self._dyn.v0.clone()
            v0[b:e] = vt
            self._dyn.v0 = v0
        else:
            self._dyn._v1_host[b:e] = v
            self._dyn._v0_host[b:e] = v

    # -- pre-freeze transforms (PointSetHandler add_rotation/add_displacement) --
    def _transform(self, f):
        if self._dyn.frozen:
            raise RuntimeError("cannot transform a point set after the simulation started")
        b, e = self._dyn.intervals[self._idx]
        for arr in (self._dyn._X_host, self._dyn._x0_host):
            arr[b:e] = f(arr[b:e])
        return self

    def add_rotation(self, angle_deg: float, axis, pivot=(0.0, 0.0, 0.0)):
        from ..utils.mesh_utils import rotate_deg

        return self._transform(lambda x: rotate_deg(x, angle_deg, axis, pivot))

    def add_displacement(self, t):
        return self._transform(lambda x: x + np.asarray(t))

    def exit_if_not_valid(self, where: str):
        if self._idx < 0 or self._idx >= len(self._dyn.intervals):
            raise RuntimeError(f"invalid PointSetHandler in {where}")


class PointDynamics:
    def __init__(self, stark):
        self._stark = stark
        self.intervals: List[Tuple[int, int]] = []
        self.labels: List[str] = []
        self._X_host: np.ndarray = np.zeros((0, 3))
        self._x0_host: np.ndarray = np.zeros((0, 3))
        self._v0_host: np.ndarray = np.zeros((0, 3))
        self._v1_host: np.ndarray = np.zeros((0, 3))
        self._a_host: np.ndarray = np.zeros((0, 3))
        self._f_host: np.ndarray = np.zeros((0, 3))
        self.frozen = False
        # device state (set at freeze); v1/x0/x1 keep cached host mirrors,
        # primed from the solver's single per-step pull (prime_host_v1) so
        # the accept and validity paths do not copy from the device again
        self.X = self.x0 = self.x1 = self.v0 = self.a = self.f = None
        self._v1 = None
        self._host_x1 = None
        self._host_x0 = None
        self._host_v1 = None
        self._host_X = None

        stark.callbacks.add_before_time_step(self._before_time_step)
        stark.callbacks.add_on_time_step_accepted(self._on_time_step_accepted)

    # -- scene building --
    def add(self, vertices, label: str = "") -> PointSetHandler:
        if self.frozen:
            raise RuntimeError("cannot add points after the simulation started")
        vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        b = self._X_host.shape[0]
        e = b + vertices.shape[0]
        self.intervals.append((b, e))
        self.labels.append(label or f"pointset_{len(self.intervals) - 1}")
        self._X_host = np.concatenate([self._X_host, vertices])
        self._x0_host = np.concatenate([self._x0_host, vertices])
        z = np.zeros_like(vertices)
        self._v0_host = np.concatenate([self._v0_host, z])
        self._v1_host = np.concatenate([self._v1_host, z])
        self._a_host = np.concatenate([self._a_host, z])
        self._f_host = np.concatenate([self._f_host, z])
        return PointSetHandler(self, len(self.intervals) - 1)

    @property
    def n_points(self) -> int:
        return self._X_host.shape[0] if not self.frozen else self.X.shape[0]

    def freeze(self, dtype: torch.dtype, device: torch.device):
        self.frozen = True

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device).clone()

        self.X = t(self._X_host)
        self.x0 = t(self._x0_host)
        self.x1 = t(self._x0_host)
        self.v0 = t(self._v0_host)
        self.v1 = t(self._v1_host)
        self.a = t(self._a_host)
        self.f = t(self._f_host)
        # host mirrors (X is immutable post-freeze; x0 rolls on accept)
        self._host_X = np.array(self._X_host)
        self._host_x0 = np.array(self._x0_host)

    # -- host accessors (work pre- and post-freeze) --
    def host_x_all(self) -> np.ndarray:
        if not self.frozen:
            return self._x0_host
        if self._host_x0 is None:
            self._host_x0 = self.x0.cpu().numpy()
        return self._host_x0

    def host_x(self, i: int) -> np.ndarray:
        return self.host_x_all()[i]

    def host_X(self) -> np.ndarray:
        if not self.frozen:
            return self._X_host
        if self._host_X is None:
            self._host_X = self.X.cpu().numpy()
        return self._host_X

    @property
    def v1(self):
        return self._v1

    @v1.setter
    def v1(self, value):
        self._v1 = value
        self._host_x1 = None
        self._host_v1 = None

    def prime_host_v1(self, v1_np: np.ndarray):
        """Feed the v1 host mirror from the solver's single per-step pull."""
        self._host_v1 = v1_np
        self._host_x1 = None

    def host_v1(self) -> np.ndarray:
        if self._v1 is None:
            return np.zeros((self.n_points, 3))
        if self._host_v1 is None:
            self._host_v1 = self._v1.cpu().numpy()
        return self._host_v1

    def get_x1(self, dt):
        """x1 = x0 + dt*v1 under current trial velocities (device)."""
        return self.x0 + dt * self.v1

    def host_x1(self, dt) -> np.ndarray:
        """Cached host mirror of x1 from the host mirrors of x0 and v1,
        computed IN THE SIMULATION DTYPE so the mirror tracks the device
        roll exactly (f64 host arithmetic over an f32 device roll would
        drift by eps32 per step)."""
        if self._host_x1 is None:
            d = np.dtype(np.float32 if self.frozen
                         and self.x0.dtype == torch.float32 else np.float64)
            self._host_x1 = (self.host_x_all().astype(d)
                             + d.type(dt) * self.host_v1().astype(d))
        return self._host_x1

    # -- glob contribution for energy functions --
    def glob_entries(self):
        return {"x0": self.x0, "v0": self.v0, "pt_a": self.a, "pt_f": self.f,
                "X": self.X}

    # -- callbacks --
    def _before_time_step(self):
        if self.n_points == 0:
            return
        # zero next-step velocity guess (PointDynamics.cpp:58-63)
        self.v1 = torch.zeros_like(self.v1)

    def _on_time_step_accepted(self):
        if self.n_points == 0:
            return
        dt = self._stark.dt
        # roll host mirrors first (pure host math from the primed v1 pull)
        new_host_x0 = self.host_x1(dt) if self._host_v1 is not None else None
        self.x1 = self.x0 + dt * self.v1
        self.x0 = self.x1
        self.v0 = self.v1
        self._host_x0 = new_host_x0
        self._host_x1 = None
