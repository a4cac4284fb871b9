"""Simulation facade: the single user entry point.

Port of `stark_tpu/simulation.py`: it owns the core (`Stark`), the
deformables, the rigid bodies, the interactions (IPC contact with lagged
friction) and the presets, exposes run() / run_one_time_step() / add_time_event, and
is the data manager: it freezes all static potential family tables onto the
device at the first step, regenerates dirty families (parameter changes,
animated targets, stiffness hardening), builds the contact engine, and wires
the DOF connector into the core.

A regenerated table keeps the tensors of its connectivity and active mask
when their values did not change (an animated rigid target changes only its
rows), so the solver's frozen static topology stays valid.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .core.script import EventDrivenScript, EventInfo
from .core.settings import Settings
from .core.stark import Stark
from .models.point_dynamics import PointDynamics
from .models.rigid_dynamics import RigidBodyDynamics
from .solver.dofs import DofLayout
from .solver.potential import FamilyData, pad_family_data


def _to_device(fd: FamilyData, dtype: torch.dtype, device: torch.device) -> Dict:
    rows = {}
    for k, v in fd.rows.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            rows[k] = torch.as_tensor(v, dtype=dtype, device=device)
        else:
            rows[k] = torch.as_tensor(v.astype(np.int64), device=device)
    conn = torch.as_tensor(np.asarray(fd.conn).astype(np.int64), device=device)
    return {"conn": conn, "rows": rows}


class Simulation:
    def __init__(self, settings: Optional[Settings] = None):
        self.stark = Stark(settings or Settings())

        self._dyn = PointDynamics(self.stark)
        self._rb_dyn = RigidBodyDynamics(self.stark)

        from .models.deformables.deformables import Deformables
        from .models.interactions.interactions import Interactions
        from .models.rigidbodies.rigidbodies import RigidBodies
        from .presets.presets import Presets

        self.deformables = Deformables(self.stark, self._dyn)
        self.rigidbodies = RigidBodies(self.stark, self._rb_dyn)
        self.interactions = Interactions(self.stark, self._dyn, self._rb_dyn)
        self.presets = Presets(self.stark, self.deformables, self.rigidbodies,
                               self.interactions)

        self.script = EventDrivenScript()
        self._layout: Optional[DofLayout] = None
        self._device_data: Dict[str, Dict] = {}
        self._capacities: Dict[str, int] = {}

        self.stark.add_init_hook(self._freeze)
        self.stark.connect(
            n_blocks_fn=lambda: self._layout.n_blocks,
            get_dofs=self._get_dofs,
            set_dofs=self._set_dofs,
            get_glob=self._get_glob,
            get_static_data=self._get_static_data,
            prime_host_dofs=self._prime_host_dofs,
            get_engine=lambda: self.interactions.contact.engine(),
        )
        # host copies of each table's conn/active, to keep their tensors
        # when a regenerated table did not change them
        self._host_index: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # public API (Simulation.h:13-43)
    # ------------------------------------------------------------------
    def get_time(self) -> float:
        return self.stark.current_time

    def get_time_step_size(self) -> float:
        return self.stark.dt

    def get_frame(self) -> int:
        return self.stark.current_frame

    def get_gravity(self) -> np.ndarray:
        return self.stark.gravity

    def set_gravity(self, gravity):
        self.stark.gravity = np.asarray(gravity, dtype=np.float64)

    def get_logger(self):
        return self.stark.logger

    def get_settings(self) -> Settings:
        return self.stark.settings

    def get_script(self) -> EventDrivenScript:
        return self.script

    def get_stark(self) -> Stark:
        return self.stark

    def add_time_event(self, t0: float, t1: float, action: Callable):
        """action(t) or action(t, event_info), active while t in [t0, t1)
        (Simulation.cpp:39-50)."""
        n_args = len(inspect.signature(action).parameters)

        def _action(info: EventInfo):
            if n_args >= 2:
                action(self.get_time(), info)
            else:
                action(self.get_time())

        self.script.add_event(
            run_when=lambda info: t0 <= self.get_time() < t1,
            action=_action,
            delete_when=lambda info: self.get_time() >= t1,
        )

    def run(self, duration: float = math.inf, callback: Optional[Callable] = None) -> bool:
        def cb():
            self.script.run_a_cycle(self.get_time())
            if callback is not None:
                callback()

        return self.stark.run(duration, cb)

    def run_one_time_step(self) -> bool:
        self.script.run_a_cycle(self.get_time())
        return self.stark.run_one_step()

    # ------------------------------------------------------------------
    # freeze + data management
    # ------------------------------------------------------------------
    def _freeze(self):
        dtype, device = self.stark.dtype, self.stark.device
        self._dyn.freeze(dtype, device)
        self._rb_dyn.freeze(dtype, device)
        self._layout = DofLayout(self._dyn.n_points, self._rb_dyn.n_bodies)
        self.stark.layout = self._layout
        pad = self.stark.settings.device.element_pad_multiple
        static = self.stark.global_potential.freeze_static_data(pad)
        for name, fd in static.items():
            self._capacities[name] = fd.conn.shape[0]
            self._store(name, fd, dtype, device)
        self.stark.dirty_families.clear()
        self.interactions.freeze(self._layout, dtype, device)

    def _store(self, name, fd, dtype, device):
        new = _to_device(fd, dtype, device)
        conn = np.asarray(fd.conn)
        act = np.asarray(fd.rows["active"])
        old = self._host_index.get(name)
        if old is not None and np.array_equal(old[0], conn) \
                and np.array_equal(old[1], act):
            prev = self._device_data[name]
            new["conn"] = prev["conn"]
            new["rows"]["active"] = prev["rows"]["active"]
        self._host_index[name] = (conn.copy(), act.copy())
        self._device_data[name] = new

    def _refresh_dirty(self):
        if not self.stark.dirty_families:
            return
        dtype, device = self.stark.dtype, self.stark.device
        gp = self.stark.global_potential
        pad = self.stark.settings.device.element_pad_multiple
        fam_by_name = {f.name: f for f in gp.families}
        for name in list(self.stark.dirty_families):
            if name not in self._device_data:
                continue  # family had no elements at freeze; stays empty
            provider = gp.get_provider(name)
            if provider is None:
                continue
            fd = provider()
            if fd is None:
                continue
            fd = pad_family_data(fd, fam_by_name[name].arity, pad,
                                 capacity=self._capacities[name])
            self._store(name, fd, dtype, device)
        self.stark.dirty_families.clear()

    def _get_static_data(self):
        self._refresh_dirty()
        return dict(self._device_data)

    def _get_glob(self):
        dtype, device = self.stark.dtype, self.stark.device
        glob = {
            "dt": torch.as_tensor(self.stark.dt, dtype=dtype, device=device),
            "gravity": torch.as_tensor(self.stark.gravity, dtype=dtype, device=device),
        }
        if self._dyn.n_points > 0:
            glob.update(self._dyn.glob_entries())
        if self._rb_dyn.n_bodies > 0:
            glob.update(self._rb_dyn.glob_entries())
            glob.update(self.rigidbodies.inertia.glob_entries())
        glob.update(self.interactions.glob_entries())
        return glob

    # ------------------------------------------------------------------
    # DOF connector (GlobalPotential get/set_dofs analog)
    # ------------------------------------------------------------------
    def _get_dofs(self):
        ns, nr = self._layout.n_soft, self._layout.n_rigid
        parts = []
        if ns > 0:
            parts.append(self._dyn.v1)
        if nr > 0:
            parts.append(torch.stack([self._rb_dyn.v1, self._rb_dyn.w1],
                                     dim=1).reshape(-1, 3))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def _set_dofs(self, u):
        ns, nr = self._layout.n_soft, self._layout.n_rigid
        if ns > 0:
            self._dyn.v1 = u[:ns]
        if nr > 0:
            rw = u[ns:].reshape(nr, 2, 3)
            self._rb_dyn.v1 = rw[:, 0]
            self._rb_dyn.w1 = rw[:, 1]

    def _prime_host_dofs(self, u_np: np.ndarray):
        """Feed the host DOF mirrors from the solver's single per-step
        device->host transfer."""
        ns, nr = self._layout.n_soft, self._layout.n_rigid
        if ns > 0:
            self._dyn.prime_host_v1(u_np[:ns])
        if nr > 0:
            rw = u_np[ns:].reshape(nr, 2, 3)
            self._rb_dyn.prime_host(rw[:, 0], rw[:, 1])
