"""Deformable energy models (per-element incremental potentials).

Port of `stark_tpu/models/deformables/energies.py` for the four families the
cloth path registers: lumped inertia, prescribed positions, triangle strain
and discrete shells (full and flat-rest). Each energy is a plain PyTorch
per-element function `(u_e, row, glob) -> scalar`, the plain twin from
which `torch.func` derives its gradient and Hessian (ops/egh.py); on the
card kernels M (triangle strain) and P (the others but full shells)
compute them. The host-side table builders
(rest-pose precomputation) are numpy copies of the JAX package's, so both
packages freeze identical element tables.

The rod (segment strain) and tet families are ROADMAP Queue 1 P7.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ... import maths
from ...ops import egh
from ...solver.potential import FamilyData, PotentialFamily
from ..point_dynamics import PointSetHandler
from ..types import FluentParams

_EPS = 1e-12


def _group_gather(group_arrays: dict, group_idx: np.ndarray) -> dict:
    """Gather per-group params into per-element rows (host)."""
    g = np.asarray(group_idx, dtype=np.int64)
    return {k: np.asarray(v, dtype=np.float64)[g] for k, v in group_arrays.items()}


class _HandlerBase:
    """Fluent handler: get/set_params per group (reference STARK_COMMON_HANDLER
    macro system, models/types.h:8-53)."""

    def __init__(self, model, idx: int):
        self._model = model
        self._idx = idx

    def get_idx(self) -> int:
        return self._idx

    def get_params(self):
        return self._model.get_params(self._idx)

    def set_params(self, params):
        self._model.set_params(self._idx, params)
        return self

    def exit_if_not_valid(self, where=""):
        pass


# ============================================================================
# Lumped inertia
# ============================================================================
@dataclass
class LumpedInertiaParams(FluentParams):
    density: float = 1000.0
    damping: float = 0.0
    quasistatic: bool = False


# the tables kernel P's lumped entry reads (csrc/egh_inertia.cu), in its
# order: ("r", key) a row table of _provider's, ("g", key) a global
_LUMPED_READS = [("r", "node"), ("r", "lumped_volume"), ("r", "density"), ("r", "damping"),
                 ("r", "is_quasistatic"), ("g", "x0"), ("g", "v0"), ("g", "pt_a"),
                 ("g", "pt_f"), ("g", "gravity"), ("g", "dt")]


class EnergyLumpedInertia:
    NAME = "EnergyLumpedInertia"

    def __init__(self, stark, dyn):
        self.stark = stark
        self.dyn = dyn
        self.density: list[float] = []
        self.damping: list[float] = []
        self.is_quasistatic: list[float] = []
        self.lumped_volume: list[float] = []
        self._nodes: list[int] = []
        self._groups: list[int] = []
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME, 1, self._energy, psd=True,
                            kernel=egh.kernel("egh_inertia", "lumped", _LUMPED_READS)),
            self._provider)

    # energy: E_ext + (quasistatic ? 0 : E_inertia) (EnergyLumpedInertia.cpp:28-46)
    def _energy(self, u_e, row, glob):
        v1 = u_e[0]
        node = row["node"][None]   # a 0-d index would read as a Python int under vmap
        dt = glob["dt"]
        x0 = glob["x0"][node][0]
        v0 = glob["v0"][node][0]
        a = glob["pt_a"][node][0]
        f = glob["pt_f"][node][0]
        mass = row["lumped_volume"] * row["density"]
        x1 = x0 + dt * v1
        xhat = x0 + dt * v0
        dev = x1 - xhat
        dev2 = x1 - x0
        E_inertia = 0.5 * mass * (torch.dot(dev, dev) / (dt * dt)
                                  + torch.dot(dev2, dev2) * row["damping"] / dt)
        f_ext = mass * (a + glob["gravity"]) + f
        # -f_ext.x1 up to the u-independent constant -f_ext.x0 (dropped so
        # the per-step energy decrease survives f32 rounding)
        E_ext = -torch.dot(f_ext, dt * v1)
        return E_ext + torch.where(row["is_quasistatic"] > 0.5,
                                   torch.zeros_like(E_inertia), E_inertia)

    def _provider(self):
        if not self._nodes:
            return None
        groups = np.asarray(self._groups)
        rows = _group_gather({"density": self.density, "damping": self.damping,
                              "is_quasistatic": self.is_quasistatic}, groups)
        rows["lumped_volume"] = np.asarray(self.lumped_volume, dtype=np.float64)
        rows["node"] = np.asarray(self._nodes, dtype=np.int32)
        conn = rows["node"].reshape(-1, 1)
        return FamilyData(conn, rows)

    def _add_with_volumes(self, set_: PointSetHandler, points, lumped_volume,
                          params: LumpedInertiaParams):
        group = len(self.density)
        self.density.append(params.density)
        self.damping.append(params.damping)
        self.is_quasistatic.append(1.0 if params.quasistatic else 0.0)
        for p, vol in zip(points, lumped_volume):
            self._nodes.append(int(set_.get_global_index(p)))
            self._groups.append(group)
            self.lumped_volume.append(float(vol))
        return _HandlerBase(self, group)

    def add(self, set_: PointSetHandler, simplices, params: LumpedInertiaParams):
        """Lump volume from edges/triangles/tets onto nodes
        (EnergyLumpedInertia.cpp:95-164)."""
        X = set_.get_rest_positions()
        simplices = np.asarray(simplices, dtype=np.int64)
        lumped = np.zeros(set_.size())
        k = simplices.shape[1]
        for s in simplices:
            v = X[s]
            if k == 2:
                m = np.linalg.norm(v[0] - v[1]) / 2.0
            elif k == 3:
                m = 0.5 * np.linalg.norm(np.cross(v[0] - v[2], v[1] - v[2])) / 3.0
            elif k == 4:
                m = abs(np.dot(np.cross(v[1] - v[0], v[2] - v[0]), v[3] - v[0])) / 6.0 / 4.0
            else:
                raise ValueError("simplices must have 2..4 vertices")
            for i in s:
                lumped[i] += m
        points = [i for i in range(set_.size()) if lumped[i] > 0.0]
        vols = [lumped[i] for i in points]
        return self._add_with_volumes(set_, points, vols, params)

    def get_mass(self, group: int) -> float:
        return sum(self.density[g] * v
                   for g, v in zip(self._groups, self.lumped_volume) if g == group)

    def get_params(self, group):
        return LumpedInertiaParams(self.density[group], self.damping[group],
                                   self.is_quasistatic[group] > 0.5)

    def set_params(self, group, p: LumpedInertiaParams):
        self.density[group] = p.density
        self.damping[group] = p.damping
        self.is_quasistatic[group] = 1.0 if p.quasistatic else 0.0
        self.stark.mark_dirty(self.NAME)


# ============================================================================
# Prescribed positions (penalty BCs + animated targets)
# ============================================================================
@dataclass
class PrescribedPositionsParams(FluentParams):
    stiffness: float = 1e7
    tolerance: float = 1e-4


class PrescribedPositionsHandler(_HandlerBase):
    """Adds the animated-BC surface (set_transformation,
    EnergyPrescribedPositions.cpp:107-131)."""

    def set_transformation(self, t, angle_deg=0.0, axis=(0, 0, 1), R=None):
        if R is None:
            self._model.set_transformation(self._idx, t, angle_deg=angle_deg, axis=axis)
        else:
            self._model.set_transformation(self._idx, t, R=R)
        return self

    def set_target_position(self, prescribed_idx, t):
        self._model.set_target_position(self._idx, prescribed_idx, t)
        return self


# kernel P's prescribed entry (csrc/egh_inertia.cu)
_PRESCRIBED_READS = [("r", "node"), ("r", "target"), ("r", "stiffness"), ("g", "x0"),
                     ("g", "dt")]


class EnergyPrescribedPositions:
    NAME = "EnergyPrescribedPositions"

    def __init__(self, stark, dyn):
        self.stark = stark
        self.dyn = dyn
        self.stiffness: list[float] = []
        self.tolerance: list[float] = []
        self._nodes: list[int] = []
        self._groups: list[int] = []
        self.target_positions: list[np.ndarray] = []
        self.rest_positions: list[np.ndarray] = []
        self.group_begin_end: list[tuple[int, int]] = []
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME, 1, self._energy, psd=True,
                            kernel=egh.kernel("egh_inertia", "prescribed",
                                              _PRESCRIBED_READS)),
            self._provider)
        stark.callbacks.newton.add_is_converged_state_valid(self._is_converged_state_valid)

    def _energy(self, u_e, row, glob):
        # E = 0.5*k*||x1 - target||^2 (EnergyPrescribedPositions.cpp:17-32)
        v1 = u_e[0]
        x0 = glob["x0"][row["node"][None]][0]
        x1 = x0 + glob["dt"] * v1
        d = x1 - row["target"]
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _provider(self):
        if not self._nodes:
            return None
        groups = np.asarray(self._groups)
        rows = _group_gather({"stiffness": self.stiffness}, groups)
        rows["node"] = np.asarray(self._nodes, dtype=np.int32)
        rows["target"] = np.asarray(self.target_positions, dtype=np.float64)
        return FamilyData(rows["node"].reshape(-1, 1), rows)

    def add(self, set_: PointSetHandler, points, params: PrescribedPositionsParams):
        group = len(self.stiffness)
        self.stiffness.append(params.stiffness)
        self.tolerance.append(params.tolerance)
        begin = len(self.target_positions)
        x = self.dyn.host_x_all()
        for p in points:
            gi = int(set_.get_global_index(p))
            self._nodes.append(gi)
            self._groups.append(group)
            self.target_positions.append(x[gi].copy())
            self.rest_positions.append(x[gi].copy())
        self.group_begin_end.append((begin, len(self.target_positions)))
        return PrescribedPositionsHandler(self, group)

    def add_inside_aabb(self, set_: PointSetHandler, aabb_center, aabb_dim, params):
        c = np.asarray(aabb_center)
        h = 0.5 * np.asarray(aabb_dim)
        pos = set_.get_positions()
        inside = np.all(np.abs(pos - c) <= h, axis=1)
        return self.add(set_, np.nonzero(inside)[0].tolist(), params)

    def add_outside_aabb(self, set_: PointSetHandler, aabb_center, aabb_dim, params):
        c = np.asarray(aabb_center)
        h = 0.5 * np.asarray(aabb_dim)
        pos = set_.get_positions()
        inside = np.all(np.abs(pos - c) <= h, axis=1)
        return self.add(set_, np.nonzero(~inside)[0].tolist(), params)

    def set_transformation(self, group: int, t, R=None, angle_deg=None, axis=None):
        """Animated boundary condition: target = R*rest + t
        (EnergyPrescribedPositions.cpp:107-131)."""
        if R is None:
            R = maths.axis_angle_rotation(math.radians(angle_deg), axis)
        R = np.asarray(R)
        t = np.asarray(t)
        b, e = self.group_begin_end[group]
        for i in range(b, e):
            self.target_positions[i] = R @ self.rest_positions[i] + t
        self.stark.mark_dirty(self.NAME)

    def set_target_position(self, group: int, prescribed_idx: int, t):
        b, _ = self.group_begin_end[group]
        self.target_positions[b + prescribed_idx] = np.asarray(t, dtype=np.float64)
        self.stark.mark_dirty(self.NAME)

    def _is_converged_state_valid(self) -> bool:
        # tolerance check + stiffness hardening x2 (EnergyPrescribedPositions.cpp:132-156)
        if not self._nodes:
            return True
        dt = self.stark.dt
        x1 = self.dyn.host_x1(dt)
        nodes = np.asarray(self._nodes)
        targets = np.asarray(self.target_positions)
        d2 = np.sum((x1[nodes] - targets) ** 2, axis=1)
        tol = np.asarray([self.tolerance[g] for g in self._groups])
        bad = d2 > tol * tol
        if np.any(bad):
            g = self._groups[int(np.argmax(bad))]
            self.stiffness[g] *= 2.0
            self.stark.mark_dirty(self.NAME)
            self.stark.output.print_with_new_line(
                "Deformable prescribed position constraints not within tolerance. Stiffness hardened.")
            return False
        return True

    def get_params(self, group):
        return PrescribedPositionsParams(self.stiffness[group], self.tolerance[group])

    def set_params(self, group, p: PrescribedPositionsParams):
        self.stiffness[group] = p.stiffness
        self.tolerance[group] = p.tolerance
        self.stark.mark_dirty(self.NAME)


# ============================================================================
# Triangle strain (2D Neo-Hookean membrane)
# ============================================================================
@dataclass
class TriangleStrainParams(FluentParams):
    elasticity_only: bool = False
    scale: float = 1.0
    thickness: float = 0.001
    youngs_modulus: float = 1e6
    poissons_ratio: float = 0.3
    damping: float = 0.0
    strain_limit: float = math.inf
    strain_limit_stiffness: float = 1e4
    inflation: float = 0.0


# kernel M's entries, full and elasticity-only (csrc/egh_strain.cu)
_STRAIN_READS = [("r", "nodes"), ("r", "DXinv"), ("r", "rest_area"), ("r", "thickness"),
                 ("r", "youngs_modulus"), ("r", "poissons_ratio"), ("r", "strain_damping"),
                 ("r", "strain_limit"), ("r", "strain_limit_stiffness"), ("r", "inflation"),
                 ("g", "x0"), ("g", "dt")]


class EnergyTriangleStrain:
    NAME = "EnergyTriangleStrain"
    NAME_EO = "EnergyTriangleStrain_ElasticityOnly"

    def __init__(self, stark, dyn):
        self.stark = stark
        self.dyn = dyn
        self.params_per_group: list[TriangleStrainParams] = []
        self._tris = {self.NAME: [], self.NAME_EO: []}
        self._groups = {self.NAME: [], self.NAME_EO: []}
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME, 3, self._energy_full,
                            kernel=egh.kernel("egh_strain", "strain", _STRAIN_READS)),
            lambda: self._provider(self.NAME))
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME_EO, 3, self._energy_eo,
                            kernel=egh.kernel("egh_strain", "strain_eo", _STRAIN_READS)),
            lambda: self._provider(self.NAME_EO))

    @staticmethod
    def _eye2(like):
        return torch.eye(2, dtype=like.dtype, device=like.device)

    def _kinematics(self, u_e, row, glob):
        dt = glob["dt"]
        nodes = row["nodes"]
        x0 = glob["x0"][nodes]
        x1 = x0 + dt * u_e
        DXinv = row["DXinv"]            # (2,2) precomputed from scaled rest pose
        Dx1 = torch.stack([x1[1] - x1[0], x1[2] - x1[0]], dim=1)  # (3,2)
        F1 = Dx1 @ DXinv                # 3x2
        C1 = F1.T @ F1                  # 2x2
        rest_area = row["rest_area"]
        area = 0.5 * maths.safe_norm(maths.cross(x1[0] - x1[2], x1[1] - x1[2]))
        J = area / rest_area
        # guard: padded/degenerate rows produce J<=0; active rows keep J>0 by
        # the validity/backtracking guarantees (energy -> inf as J -> 0)
        J = torch.clamp_min(J, 1e-12)
        return x0, x1, F1, C1, J, rest_area, Dx1, DXinv

    def _elastic_density(self, C1, J, row):
        e, nu = row["youngs_modulus"], row["poissons_ratio"]
        mu = e / (2.0 * (1.0 + nu))
        lam = (e * nu) / ((1.0 + nu) * (1.0 - nu))  # 2D
        Ic = C1[0, 0] + C1[1, 1]
        logJ = torch.log(J)
        return 0.5 * mu * (Ic - 2.0) - mu * logJ + 0.5 * lam * logJ * logJ

    def _inflation_density(self, x0, x1, row):
        n0 = -maths.normalized(maths.cross(x0[1] - x0[0], x0[2] - x0[0]))
        # inflation * n0 . mean(x1) up to the u-independent n0 . mean(x0)
        # constant (dropped for f32 cancellation safety; same derivatives)
        dx = (x1[0] - x0[0]) + (x1[1] - x0[1]) + (x1[2] - x0[2])
        return row["inflation"] * torch.dot(n0, dx) / 3.0

    def _energy_full(self, u_e, row, glob):
        # EnergyTriangleStrain.cpp:13-80
        dt = glob["dt"]
        x0, x1, F1, C1, J, rest_area, _, DXinv = self._kinematics(u_e, row, glob)
        E1 = 0.5 * (C1 - self._eye2(C1))
        Dx0 = torch.stack([x0[1] - x0[0], x0[2] - x0[0]], dim=1)
        F0 = Dx0 @ DXinv
        E0 = 0.5 * (F0.T @ F0 - self._eye2(C1))
        dE_dt = (E1 - E0) / dt
        elastic = self._elastic_density(C1, J, row)
        damping = 0.5 * row["strain_damping"] * torch.sum(dE_dt * dE_dt)
        s0, s1 = maths.eigenvalues_sym_2x2(E1)
        limit = (maths.cubic_one_sided(s0 - row["strain_limit"], row["strain_limit_stiffness"])
                 + maths.cubic_one_sided(s1 - row["strain_limit"], row["strain_limit_stiffness"]))
        inflation = self._inflation_density(x0, x1, row)
        return row["thickness"] * rest_area * (elastic + damping + limit + inflation)

    def _energy_eo(self, u_e, row, glob):
        # EnergyTriangleStrain.cpp:82-130
        x0, x1, F1, C1, J, rest_area, _, _ = self._kinematics(u_e, row, glob)
        elastic = self._elastic_density(C1, J, row)
        inflation = self._inflation_density(x0, x1, row)
        return row["thickness"] * rest_area * (elastic + inflation)

    def _provider(self, name):
        tris = self._tris[name]
        if not tris:
            return None
        groups = np.asarray(self._groups[name])
        P = self.params_per_group
        conn = np.asarray(tris, dtype=np.int32)
        X = self.dyn.host_X()
        scale = np.asarray([P[g].scale for g in groups])
        # rest-pose projection Jacobian (deformable_tools.cpp triangle_jacobian)
        Xs = X[conn] * scale[:, None, None]
        u = Xs[:, 1] - Xs[:, 0]
        u = u / np.linalg.norm(u, axis=1, keepdims=True)
        n = np.cross(u, Xs[:, 2] - Xs[:, 0])
        v = np.cross(u, n)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        # DX columns = projections of edge vectors onto (u, v)
        e1 = Xs[:, 1] - Xs[:, 0]
        e2 = Xs[:, 2] - Xs[:, 0]
        DX = np.stack([
            np.stack([np.sum(u * e1, axis=1), np.sum(u * e2, axis=1)], axis=1),
            np.stack([np.sum(v * e1, axis=1), np.sum(v * e2, axis=1)], axis=1),
        ], axis=1)  # (E, 2, 2)
        DXinv = np.linalg.inv(DX)
        rest_area = 0.5 * np.linalg.norm(
            np.cross(Xs[:, 0] - Xs[:, 2], Xs[:, 1] - Xs[:, 2]), axis=1)
        rows = {
            "thickness": np.asarray([P[g].thickness for g in groups]),
            "youngs_modulus": np.asarray([P[g].youngs_modulus for g in groups]),
            "poissons_ratio": np.asarray([P[g].poissons_ratio for g in groups]),
            "strain_damping": np.asarray([P[g].damping for g in groups]),
            "strain_limit": np.asarray([min(P[g].strain_limit, 1e30) for g in groups]),
            "strain_limit_stiffness": np.asarray([P[g].strain_limit_stiffness for g in groups]),
            "inflation": np.asarray([P[g].inflation for g in groups]),
            "DXinv": DXinv,
            "rest_area": rest_area,
            "nodes": conn,
        }
        return FamilyData(conn, rows)

    def add(self, set_: PointSetHandler, triangles, params: TriangleStrainParams):
        group = len(self.params_per_group)
        self.params_per_group.append(params)
        name = self.NAME_EO if params.elasticity_only else self.NAME
        for tri in triangles:
            self._tris[name].append(set_.get_global_indices(tri).tolist())
            self._groups[name].append(group)
        return _HandlerBase(self, group)

    def get_params(self, group):
        return self.params_per_group[group]

    def set_params(self, group, p: TriangleStrainParams):
        if p.elasticity_only != self.params_per_group[group].elasticity_only:
            raise ValueError("elasticity_only cannot be changed")
        self.params_per_group[group] = p
        self.stark.mark_dirty(self.NAME)
        self.stark.mark_dirty(self.NAME_EO)


# ============================================================================
# Discrete shells bending
# ============================================================================
@dataclass
class DiscreteShellsParams(FluentParams):
    scale: float = 1.0
    stiffness: float = 1.0
    damping: float = 0.0
    flat_rest_angle: bool = False


# kernel P's flat-rest shells entry (csrc/egh_inertia.cu)
_SHELLS_FLAT_READS = [("r", "nodes"), ("r", "bergou_K"), ("r", "bergou_coef"),
                      ("r", "stiffness"), ("g", "x0"), ("g", "dt")]


class EnergyDiscreteShells:
    NAME = "EnergyDiscreteShells"
    NAME_FLAT = "EnergyBendingFlat"

    def __init__(self, stark, dyn):
        self.stark = stark
        self.dyn = dyn
        self.params_per_group: list[DiscreteShellsParams] = []
        self._conn = {self.NAME: [], self.NAME_FLAT: []}
        self._groups = {self.NAME: [], self.NAME_FLAT: []}
        self._rest = {self.NAME: [], self.NAME_FLAT: []}   # per-element rest tuples
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME, 4, self._energy_full),
            lambda: self._provider(self.NAME))
        stark.global_potential.add_potential(
            PotentialFamily(self.NAME_FLAT, 4, self._energy_flat, psd=True,
                            kernel=egh.kernel("egh_inertia", "shells_flat",
                                              _SHELLS_FLAT_READS)),
            lambda: self._provider(self.NAME_FLAT))

    def _energy_full(self, u_e, row, glob):
        # bending k*(theta-theta_rest)^2*(l_rest/h_rest) + angle-rate damping
        # (EnergyDiscreteShells.cpp:28-62)
        dt = glob["dt"]
        nodes = row["nodes"]
        x0 = glob["x0"][nodes]
        x1 = x0 + dt * u_e
        ratio = (row["rest_edge_length"] * row["scale"]) / (row["rest_height"] * row["scale"])
        da1 = maths.dihedral_angle(x1[0], x1[1], x1[2], x1[3])
        dd = da1 - row["rest_dihedral_angle"]
        E_bend = row["stiffness"] * dd * dd * ratio
        da0 = maths.dihedral_angle(x0[0], x0[1], x0[2], x0[3])
        E_damp = row["damping"] / dt * (0.5 * da1 * da1 - da0 * da1) * ratio
        return E_bend + E_damp

    def _energy_flat(self, u_e, row, glob):
        # Bergou quadratic flat-rest-angle bending 0.5*k*x^T Q x per component
        # (EnergyDiscreteShells.cpp:64-92)
        nodes = row["nodes"]
        x0 = glob["x0"][nodes]
        x1 = x0 + glob["dt"] * u_e  # (4,3)
        K = row["bergou_K"]         # (4,)
        Q = row["bergou_coef"] * torch.outer(K, K)
        # sum over the 3 coordinates of 0.5*k*(x_d^T Q x_d)
        eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
        return 0.5 * row["stiffness"] * torch.sum(x1.T @ Q @ x1 * eye)

    def _provider(self, name):
        conn_list = self._conn[name]
        if not conn_list:
            return None
        groups = np.asarray(self._groups[name])
        P = self.params_per_group
        conn = np.asarray(conn_list, dtype=np.int32)
        rest = self._rest[name]
        rows = {
            "scale": np.asarray([P[g].scale for g in groups]),
            "stiffness": np.asarray([P[g].stiffness for g in groups]),
            "damping": np.asarray([P[g].damping for g in groups]),
            "nodes": conn,
            "rest_dihedral_angle": np.asarray([r[0] for r in rest]),
            "rest_edge_length": np.asarray([r[1] for r in rest]),
            "rest_height": np.asarray([r[2] for r in rest]),
            "bergou_coef": np.asarray([r[3] for r in rest]),
            "bergou_K": np.asarray([r[4] for r in rest]),
        }
        return FamilyData(conn, rows)

    def add(self, set_: PointSetHandler, triangles, params: DiscreteShellsParams):
        from ...utils.mesh_utils import find_internal_angles

        if params.flat_rest_angle and params.scale != 1.0:
            raise ValueError("scale must be 1.0 when flat_rest_angle is true")
        group = len(self.params_per_group)
        self.params_per_group.append(params)
        name = self.NAME_FLAT if params.flat_rest_angle else self.NAME
        internal = find_internal_angles(np.asarray(triangles, dtype=np.int64), set_.size())
        X = self.dyn.host_X()
        for ia in internal:
            gconn = set_.get_global_indices(ia)
            self._conn[name].append(gconn.tolist())
            self._groups[name].append(group)
            xa = X[gconn]
            # rest precompute (EnergyDiscreteShells.cpp:110-169)
            e0 = xa[1] - xa[0]
            e1 = xa[2] - xa[0]
            e2 = xa[3] - xa[0]
            e3 = xa[2] - xa[1]
            e4 = xa[3] - xa[1]
            el = np.linalg.norm(e0)
            n0 = np.cross(e0, e1)
            n1 = -np.cross(e0, e2)
            cosang = (1.0 - _EPS) * np.dot(n0 / np.linalg.norm(n0), n1 / np.linalg.norm(n1))
            rest_angle = math.acos(np.clip(cosang, -1.0, 1.0))
            A0 = 0.5 * np.linalg.norm(n0)
            A1 = 0.5 * np.linalg.norm(n1)
            h = (2.0 * A0 / el + 2.0 * A1 / el) / 6.0

            def cot(v, w):
                return np.dot(v, w) / np.linalg.norm(np.cross(v, w))

            c01, c02 = cot(e0, e1), cot(e0, e2)
            c03, c04 = cot(-e0, e3), cot(-e0, e4)
            coef = 3.0 / (A0 + A1) * 0.5
            K = np.array([c03 + c04, c01 + c02, -c01 - c03, -c02 - c04])
            self._rest[name].append((rest_angle, el, h, coef, K))
        return _HandlerBase(self, group)

    def get_params(self, group):
        return self.params_per_group[group]

    def set_params(self, group, p: DiscreteShellsParams):
        if p.flat_rest_angle != self.params_per_group[group].flat_rest_angle:
            raise ValueError("flat_rest_angle cannot be changed")
        self.params_per_group[group] = p
        self.stark.mark_dirty(self.NAME)
        self.stark.mark_dirty(self.NAME_FLAT)
