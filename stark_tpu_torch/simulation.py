"""Simulation facade: the single user entry point.

Port of `stark_tpu/simulation.py` for the cloth path: it owns the core
(`Stark`), the deformables and the presets, exposes run() /
run_one_time_step() / add_time_event, and is the data manager: it freezes
all static potential family tables onto the device at the first step,
regenerates dirty families (parameter changes, animated targets, stiffness
hardening), and wires the DOF connector into the core.

Rigid bodies (ROADMAP Queue 1 P2) and interactions/contact (P3) are not
ported yet: accessing them raises NotImplementedError, and so does
`Settings.simulation.init_frictional_contact = True` (the default), rather
than silently running without contact.
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
        settings = settings or Settings()
        if settings.simulation.init_frictional_contact:
            raise NotImplementedError(
                "frictional contact is not ported yet (ROADMAP Queue 1 P3): "
                "set settings.simulation.init_frictional_contact = False")
        self.stark = Stark(settings)

        self._dyn = PointDynamics(self.stark)

        from .models.deformables.deformables import Deformables
        from .presets.presets import Presets

        self.deformables = Deformables(self.stark, self._dyn)
        self.presets = Presets(self.stark, self.deformables)

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
        )

    @property
    def rigidbodies(self):
        raise NotImplementedError("rigid bodies are not ported yet (ROADMAP Queue 1 P2)")

    @property
    def interactions(self):
        raise NotImplementedError(
            "interactions (contact, attachments) are not ported yet "
            "(ROADMAP Queue 1 P3, P8)")

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
        self._layout = DofLayout(self._dyn.n_points, 0)
        self.stark.layout = self._layout
        pad = self.stark.settings.device.element_pad_multiple
        static = self.stark.global_potential.freeze_static_data(pad)
        for name, fd in static.items():
            self._capacities[name] = fd.conn.shape[0]
            self._device_data[name] = _to_device(fd, dtype, device)
        self.stark.dirty_families.clear()

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
            self._device_data[name] = _to_device(fd, dtype, device)
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
        return glob

    # ------------------------------------------------------------------
    # DOF connector (GlobalPotential get/set_dofs analog)
    # ------------------------------------------------------------------
    def _get_dofs(self):
        return self._dyn.v1

    def _set_dofs(self, u):
        self._dyn.v1 = u

    def _prime_host_dofs(self, u_np: np.ndarray):
        """Feed the host DOF mirrors from the solver's single per-step
        device->host transfer."""
        self._dyn.prime_host_v1(u_np)
