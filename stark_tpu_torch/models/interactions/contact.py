"""IPC frictional contact: mesh registry, global parameters, stiffness
ladder, lagged friction.

Port of `stark_tpu/models/interactions/contact.py`
(EnergyFrictionalContact.h:20-60, .cpp:20-48, 531-810). Collision meshes
(deformable point-set surfaces or rigid-body local meshes) register their
vertices, edges and triangles; at freeze the contact engine
(contact_engine.py) takes them over. Barrier stiffness doubles when a step
fails with too many invalid intermediate states (code 6) and decays by 0.99
on every accepted step, bounded by the global parameters.

Friction between two meshes (`set_friction`, Coulomb mu) is lagged: its
pair anchors, tangent bases and normal forces freeze once per step at the
step-start state. The fused solve builds those tables itself, once per
solve (solver/fused.py, `ContactEngine.friction_tables`). The staged solver
reads host tables: `_before_time_step` refreshes the friction tables once
per step (left empty while the fused solve is eligible, as it builds its
own), `_before_energy_evaluation` the contact tables before every energy
evaluation, and `dynamic_family_data` hands both to the solver; its line
search asks the intersection oracle for every trial state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..types import FluentParams


class IPCBarrierType:
    Log = "Log"
    Cubic = "Cubic"


class IPCFrictionType:
    C0 = "C0"
    C1 = "C1"


@dataclass
class ContactParams(FluentParams):
    contact_thickness: float = 0.0   # 0.0 -> the global default


@dataclass
class ContactGlobalParams(FluentParams):
    default_contact_thickness: float = -1.0
    min_contact_stiffness: float = 1e6
    max_contact_stiffness: float = 1e20
    friction_stick_slide_threshold: float = 0.1
    collisions_enabled: bool = True
    friction_enabled: bool = True
    triangle_point_enabled: bool = True
    edge_edge_enabled: bool = True
    intersection_test_enabled: bool = True


@dataclass
class ContactMesh:
    """One registered collision mesh."""
    handler_idx: int
    is_rigid: bool
    point_ids: Optional[np.ndarray] = None       # deformable: global point ids
    rb_idx: int = -1
    local_vertices: Optional[np.ndarray] = None  # rigid: body-local vertices
    edges: np.ndarray = None
    triangles: np.ndarray = None


class ContactHandler:
    def __init__(self, model: "EnergyFrictionalContact", idx: int):
        self.model = model
        self.idx = idx

    def get_idx(self) -> int:
        return self.idx

    def set_contact_thickness(self, d: float):
        self.model.set_contact_thickness(self, d)

    def set_friction(self, other: "ContactHandler", coulombs_mu: float):
        self.model.set_friction(self, other, coulombs_mu)

    def disable_collision(self, other: "ContactHandler"):
        self.model.disable_collision(self, other)

    def is_valid(self) -> bool:
        return self.model is not None


class EnergyFrictionalContact:
    def __init__(self, stark, dyn, rb_dyn):
        self.stark = stark
        self.dyn = dyn
        self.rb_dyn = rb_dyn

        self.global_params = ContactGlobalParams()
        self.contact_stiffness = 1e3
        self.ipc_barrier_type = IPCBarrierType.Cubic
        self.ipc_friction_type = IPCFrictionType.C0
        # relative parallel-edge cutoff (sin^2 of the angle); None = the
        # dtype default of collision/narrow_phase._parallel_tol
        self.edge_edge_cross_norm_sq_cutoff = None
        # the friction potential's perturbation of the tangential
        # displacement is fixed at this value (contact_energies.py)
        self.friction_displacement_perturbation = 1e-9

        self.contact_thicknesses: List[float] = []
        self.meshes: List[ContactMesh] = []
        self.pair_mu: Dict[tuple, float] = {}
        self.disabled_pairs: set = set()
        # candidate search: "auto" (a block over 2^27 pairs takes the hash
        # grid), "dense" or "grid"; read when the engine is built
        self.broad_phase = "auto"
        self._engine = None
        # set by the fused solve while it runs the host converged-state
        # checks (it has run the intersection test on the device)
        self._suppress_converged_intersection = False

        stark.callbacks.add_before_time_step(self._before_time_step)
        stark.callbacks.newton.add_before_energy_evaluation(self._before_energy_evaluation)
        stark.callbacks.newton.add_is_initial_state_valid(
            lambda: self._is_state_valid())
        stark.callbacks.newton.add_is_intermediate_state_valid(
            lambda: self._is_state_valid())
        stark.callbacks.newton.add_on_intermediate_state_invalid(
            self._on_intermediate_state_invalid)
        stark.callbacks.newton.add_is_converged_state_valid(self._is_converged_state_valid)
        stark.callbacks.add_on_time_step_accepted(self._on_time_step_accepted)

        from . import contact_energies as ce

        self._families = ce.make_families(self)
        for fam in self._families.values():
            stark.global_potential.add_potential(fam)

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def _new_handler(self, params: ContactParams) -> ContactHandler:
        t = params.contact_thickness
        if t == 0.0:
            t = self.global_params.default_contact_thickness
        if t <= 0.0:
            raise ValueError(
                "contact thickness not set (no default_contact_thickness defined)")
        self.contact_thicknesses.append(t)
        return ContactHandler(self, len(self.contact_thicknesses) - 1)

    def add_triangles(self, obj, triangles=None, params: ContactParams = None,
                      vertices=None, point_set_map=None):
        """Deformable: add_triangles(point_set, triangles, params).
        Rigid: add_triangles(rb_handler, triangles=..., vertices=..., params=...)."""
        from ...utils.mesh_utils import find_edges_from_simplices

        params = params or ContactParams()
        triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
        h = self._new_handler(params)
        if hasattr(obj, "get_global_index"):
            n = obj.size() if point_set_map is None else len(point_set_map)
            pids = (obj.all_global_indices() if point_set_map is None
                    else obj.get_global_indices(np.asarray(point_set_map)))
            self.meshes.append(ContactMesh(
                handler_idx=h.idx, is_rigid=False, point_ids=pids,
                edges=find_edges_from_simplices(triangles, n), triangles=triangles))
        else:
            vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
            self.meshes.append(ContactMesh(
                handler_idx=h.idx, is_rigid=True, rb_idx=obj.get_idx(),
                local_vertices=vertices,
                edges=find_edges_from_simplices(triangles, len(vertices)),
                triangles=triangles))
        return h

    def add_edges(self, obj, edges=None, params: ContactParams = None,
                  vertices=None, point_set_map=None):
        """A mesh of edges only (rods, nets): edge-edge contact, and its
        vertices as points against other meshes' triangles; the same
        signatures as add_triangles."""
        params = params or ContactParams()
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        empty_tris = np.zeros((0, 3), dtype=np.int64)
        h = self._new_handler(params)
        if hasattr(obj, "get_global_index"):
            pids = (obj.all_global_indices() if point_set_map is None
                    else obj.get_global_indices(np.asarray(point_set_map)))
            self.meshes.append(ContactMesh(
                handler_idx=h.idx, is_rigid=False, point_ids=pids,
                edges=edges, triangles=empty_tris))
        else:
            vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
            self.meshes.append(ContactMesh(
                handler_idx=h.idx, is_rigid=True, rb_idx=obj.get_idx(),
                local_vertices=vertices, edges=edges, triangles=empty_tris))
        return h

    # ------------------------------------------------------------------
    # setters / getters
    # ------------------------------------------------------------------
    def get_global_params(self) -> ContactGlobalParams:
        return self.global_params

    def set_global_params(self, params: ContactGlobalParams):
        # also resets the running stiffness (EnergyFrictionalContact.cpp:44-48)
        self.global_params = params
        self.contact_stiffness = params.min_contact_stiffness

    def set_contact_thickness(self, handler: ContactHandler, t: float):
        self.contact_thicknesses[handler.idx] = t

    def get_contact_stiffness(self) -> float:
        return self.contact_stiffness

    def set_friction(self, h0: ContactHandler, h1: ContactHandler, mu: float):
        """Coulomb mu between two meshes (applies from the next step)."""
        self.pair_mu[self._pair_key(h0, h1)] = float(mu)

    def disable_collision(self, h0: ContactHandler, h1: ContactHandler):
        self.disabled_pairs.add(self._pair_key(h0, h1))

    @staticmethod
    def _pair_key(h0, h1):
        return (min(h0.idx, h1.idx), max(h0.idx, h1.idx))

    def get_friction(self, idx0: int, idx1: int) -> float:
        return self.pair_mu.get((min(idx0, idx1), max(idx0, idx1)), 0.0)

    def is_empty(self) -> bool:
        return len(self.meshes) == 0

    @property
    def enabled(self) -> bool:
        return (not self.is_empty()) and self.global_params.collisions_enabled

    # ------------------------------------------------------------------
    # freeze: build the device engine
    # ------------------------------------------------------------------
    def freeze(self, layout, dtype, device):
        if self.is_empty():
            return
        from .contact_engine import ContactEngine

        self._engine = ContactEngine(self, layout, dtype, device)

    def engine(self):
        """The contact engine the solve uses, or None without contact."""
        if self._engine is None or not self.enabled:
            return None
        return self._engine

    # ------------------------------------------------------------------
    # callbacks
    # ------------------------------------------------------------------
    def _is_state_valid(self) -> bool:
        eng = self.engine()
        if eng is None or not self.global_params.intersection_test_enabled:
            return True
        return not eng.has_intersection(self.stark.dt)

    def _is_converged_state_valid(self) -> bool:
        # the reference tests the converged state for intersections too
        # (EnergyFrictionalContact.cpp:25)
        if self._suppress_converged_intersection:
            return True
        return self._is_state_valid()

    def _before_time_step(self):
        eng = self.engine()
        if eng is None or not self.global_params.friction_enabled \
                or not self.stark.settings.simulation.init_frictional_contact:
            return
        nm = self.stark.newton
        if nm is not None and nm._fused_eligible():
            # the fused solve builds the dt = 0 friction tables itself
            eng._friction_data = None
            return
        eng.refresh_friction(self.stark.dt)

    def _before_energy_evaluation(self):
        eng = self.engine()
        if eng is not None:
            eng.refresh_contacts(self.stark.dt)

    def _friction_ready(self, eng):
        """Build the step's friction tables if no staged step start has
        (a staged solve after a fused-eligible _before_time_step, e.g. the
        line-search diagnostic re-solve). The dt = 0 pass reads the
        step-start state, so a lazy build freezes the same anchors."""
        if self.global_params.friction_enabled \
                and self.stark.settings.simulation.init_frictional_contact \
                and eng._friction_data is None and eng.friction_enabled_now():
            eng.refresh_friction(self.stark.dt)

    def dynamic_family_data(self):
        """The staged solver's contact and friction tables."""
        eng = self.engine()
        if eng is None:
            return {}
        self._friction_ready(eng)
        return eng.current_family_data()

    def _on_intermediate_state_invalid(self):
        # stiffness hardening x2 (EnergyFrictionalContact.cpp:800-806)
        self.contact_stiffness = min(self.contact_stiffness * 2.0,
                                     self.global_params.max_contact_stiffness)

    def _on_time_step_accepted(self):
        # stiffness decay x0.99 bounded below (EnergyFrictionalContact.cpp:807-810)
        self.contact_stiffness = max(self.contact_stiffness * 0.99,
                                     self.global_params.min_contact_stiffness)

    def glob_entries(self):
        eng = self.engine()
        return {} if eng is None else eng.glob_entries()
