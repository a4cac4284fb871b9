"""Attachment (gluing) penalties between deformables and rigid bodies.

Port of `stark_tpu/models/interactions/attachments.py`
(EnergyAttachments.cpp:17-341): five penalty families,
  d-d point-point        E = 0.5k||x1_b - x1_a||^2
  d-d point-edge         E = 0.5k||bary.e - p||^2
  d-d point-triangle     E = 0.5k||bary.t - p||^2
  d-d edge-edge          E = 0.5k||bary1.eb - bary0.ea||^2
  rb-d point             E = 0.5k||x1_d - x1_rb(loc)||^2
with JAX's names, arities, `psd` flags and tables. `add_by_distance`
builds barycentric anchors from a point -> mesh nearest-entity query
(`collision/mesh_distance.py`, a copy of the JAX package's). The
converged-state check doubles a group's stiffness for every element past
its tolerance and marks the family dirty, so its tables are rebuilt
between Newton solves; the kernel reads `stiffness` per row at every call.

On the card the five families' e, g and H come from kernel W
(csrc/egh_attachments.cu); the energies below are its plain twins.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import maths
from ...collision.mesh_distance import classify_bary, closest_point_on_triangles
from ...ops import egh
from ...solver.potential import FamilyData, PotentialFamily
from ..types import FluentParams


@dataclass
class AttachmentParams(FluentParams):
    stiffness: float = 1e6
    tolerance: float = 1e-3


class AttachmentHandler:
    def __init__(self, model, kind, group):
        self.model = model
        self.kind = kind
        self.group = group

    def set_stiffness(self, k):
        self.model.set_stiffness(self.kind, self.group, k)
        return self

    def get_stiffness(self):
        return self.model.groups[self.kind][self.group]["stiffness"]

    def set_tolerance(self, tol):
        self.model.groups[self.kind][self.group]["tolerance"] = tol
        return self


class MultiHandler:
    """Bundle of handlers produced by one add_by_distance call
    (EnergyAttachments::MultiHandler)."""

    def __init__(self, handlers):
        self.handlers = handlers

    def set_stiffness(self, k):
        for h in self.handlers:
            h.set_stiffness(k)
        return self


PP = "EnergyAttachments_d_d_p_p"
PE = "EnergyAttachments_d_d_p_e"
PT = "EnergyAttachments_d_d_p_t"
EE = "EnergyAttachments_d_d_e_e"
RBD = "EnergyAttachments_rb_d"
KINDS = (PP, PE, PT, EE, RBD)

# kernel W's entries (csrc/egh_attachments.cu) and the tables each reads,
# in its order
_R = lambda *keys: [("r", k) for k in keys]
_G = lambda *keys: [("g", k) for k in keys]
_W = {
    PP: ("att_pp", _R("nodes", "stiffness") + _G("x0", "dt")),
    PE: ("att_pe", _R("nodes", "stiffness") + _G("x0", "dt") + _R("bary")),
    PT: ("att_pt", _R("nodes", "stiffness") + _G("x0", "dt") + _R("bary")),
    EE: ("att_ee", _R("nodes", "stiffness") + _G("x0", "dt") + _R("bary0", "bary1")),
    RBD: ("att_rbd", _R("node", "stiffness") + _G("x0", "dt") + _R("body", "loc")
          + _G("rb_t0", "rb_q0")),
}


def _at(arr, idx):
    """arr[idx] for a 0-d index that stays a tensor under vmap."""
    return arr[idx[None]][0]


class EnergyAttachments:
    def __init__(self, stark, dyn, rb_dyn):
        self.stark = stark
        self.dyn = dyn
        self.rb_dyn = rb_dyn
        self.groups = {k: [] for k in KINDS}
        self._elems = {k: [] for k in KINDS}

        gp = stark.global_potential
        for name, arity, fn, psd in ((PP, 2, self._e_pp, True), (PE, 3, self._e_pe, True),
                                     (PT, 4, self._e_pt, True), (EE, 4, self._e_ee, True),
                                     (RBD, 3, self._e_rbd, False)):
            entry, reads = _W[name]
            gp.add_potential(
                PotentialFamily(name, arity, fn, psd=psd,
                                kernel=egh.kernel("egh_attachments", entry, reads)),
                lambda name=name: self._provider(name))
        stark.callbacks.newton.add_is_converged_state_valid(self._is_converged_state_valid)

    # -- energies (EnergyAttachments.cpp:17-136), the twins of kernel W --
    def _x1(self, glob, nodes, u):
        return glob["x0"][nodes] + glob["dt"] * u

    def _e_pp(self, u_e, row, glob):
        x = self._x1(glob, row["nodes"], u_e)
        d = x[1] - x[0]
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_pe(self, u_e, row, glob):
        x = self._x1(glob, row["nodes"], u_e)   # p, e0, e1
        q = row["bary"][0] * x[1] + row["bary"][1] * x[2]
        d = q - x[0]
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_pt(self, u_e, row, glob):
        x = self._x1(glob, row["nodes"], u_e)   # p, t0, t1, t2
        q = row["bary"][0] * x[1] + row["bary"][1] * x[2] + row["bary"][2] * x[3]
        d = q - x[0]
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_ee(self, u_e, row, glob):
        x = self._x1(glob, row["nodes"], u_e)   # ea0, ea1, eb0, eb1
        p = row["bary0"][0] * x[0] + row["bary0"][1] * x[1]
        q = row["bary1"][0] * x[2] + row["bary1"][1] * x[3]
        d = q - p
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    def _e_rbd(self, u_e, row, glob):
        dt = glob["dt"]
        xd = _at(glob["x0"], row["node"]) + dt * u_e[0]
        b = row["body"]
        xr = maths.integrate_loc_point(row["loc"], _at(glob["rb_t0"], b),
                                       _at(glob["rb_q0"], b), u_e[1], u_e[2], dt)
        d = xd - xr
        return 0.5 * row["stiffness"] * torch.dot(d, d)

    # -- providers --
    def _provider(self, name):
        elems = self._elems[name]
        if not elems:
            return None
        groups = self.groups[name]
        k = np.asarray([groups[e["group"]]["stiffness"] for e in elems])
        if name == RBD:
            lay = self.stark.layout
            conn = np.asarray(
                [[e["node"], lay.rigid_v_block(e["body"]), lay.rigid_w_block(e["body"])]
                 for e in elems], dtype=np.int32)
            rows = {"node": conn[:, 0],
                    "body": np.asarray([e["body"] for e in elems], dtype=np.int32),
                    "loc": np.asarray([e["loc"] for e in elems]),
                    "stiffness": k}
            return FamilyData(conn, rows)
        conn = np.asarray([e["nodes"] for e in elems], dtype=np.int32)
        rows = {"nodes": conn, "stiffness": k}
        if name == PE:
            rows["bary"] = np.asarray([e["bary"] for e in elems]).reshape(-1, 2)
        elif name == PT:
            rows["bary"] = np.asarray([e["bary"] for e in elems]).reshape(-1, 3)
        elif name == EE:
            rows["bary0"] = np.asarray([e["bary0"] for e in elems]).reshape(-1, 2)
            rows["bary1"] = np.asarray([e["bary1"] for e in elems]).reshape(-1, 2)
        return FamilyData(conn, rows)

    def _new_group(self, name, params):
        params = params or AttachmentParams()
        self.groups[name].append({"stiffness": params.stiffness,
                                  "tolerance": params.tolerance})
        self.stark.mark_dirty(name)
        return len(self.groups[name]) - 1

    # -- API (EnergyAttachments.cpp:140-341) --
    def add(self, set_0, set_1, points_0, points_1, params: AttachmentParams = None):
        """Glue point pairs (d-d point-point)."""
        g = self._new_group(PP, params)
        for pa, pb in zip(points_0, points_1):
            self._elems[PP].append({
                "nodes": [int(set_0.get_global_index(pa)), int(set_1.get_global_index(pb))],
                "group": g})
        return AttachmentHandler(self, PP, g)

    def add_point_edge(self, set_p, set_e, point, edge, bary, params=None):
        g = self._new_group(PE, params)
        self._elems[PE].append({
            "nodes": [int(set_p.get_global_index(point))]
            + [int(set_e.get_global_index(i)) for i in edge],
            "bary": bary, "group": g})
        return AttachmentHandler(self, PE, g)

    def add_by_distance(self, obj, set_, *args, **kwargs):
        """d-d: add_by_distance(set_0, set_1, points, triangles, distance, params)
        -> glue points of set_0 to the closest entity of set_1's triangle mesh.
        rb-d: add_by_distance(rb_handler, set_, loc_vertices, triangles,
        set_points, distance, params)."""
        if hasattr(obj, "get_global_index"):  # PointSetHandler (d-d)
            set_0, set_1 = obj, set_
            points, triangles, distance = args[0], args[1], args[2]
            params = args[3] if len(args) > 3 else kwargs.get("params")
            x = self.dyn.host_x_all()
            tri = np.asarray(triangles, dtype=np.int64)
            V1 = x[set_1.get_global_indices(np.arange(set_1.size()))]
            P = x[set_0.get_global_indices(np.asarray(points))]
            d, tidx, bary = closest_point_on_triangles(P, V1, tri)
            handlers = []
            gpp = gpe = gpt = None
            for i, p_loc in enumerate(points):
                if d[i] > distance:
                    continue
                p_gid = int(set_0.get_global_index(p_loc))
                t = tri[tidx[i]]
                cls = classify_bary(bary[i])
                if cls[0] == "vertex":
                    if gpp is None:
                        gpp = self._new_group(PP, params)
                        handlers.append(AttachmentHandler(self, PP, gpp))
                    self._elems[PP].append({
                        "nodes": [p_gid, int(set_1.get_global_index(int(t[cls[1]])))],
                        "group": gpp})
                elif cls[0] == "edge":
                    if gpe is None:
                        gpe = self._new_group(PE, params)
                        handlers.append(AttachmentHandler(self, PE, gpe))
                    (i0, i1), b2 = cls[1], cls[2]
                    self._elems[PE].append({
                        "nodes": [p_gid,
                                  int(set_1.get_global_index(int(t[i0]))),
                                  int(set_1.get_global_index(int(t[i1])))],
                        "bary": b2, "group": gpe})
                else:
                    if gpt is None:
                        gpt = self._new_group(PT, params)
                        handlers.append(AttachmentHandler(self, PT, gpt))
                    self._elems[PT].append({
                        "nodes": [p_gid] + [int(set_1.get_global_index(int(v))) for v in t],
                        "bary": bary[i], "group": gpt})
            for name in (PP, PE, PT):
                self.stark.mark_dirty(name)
            return MultiHandler(handlers)

        # rb-d: glue set_ points near the rigid mesh to body-local points
        rb_handler = obj
        loc_vertices, triangles, set_points, distance = args[0], args[1], args[2], args[3]
        params = args[4] if len(args) > 4 else kwargs.get("params")
        W = (np.asarray(loc_vertices) @ rb_handler.get_rotation_matrix().T
             + rb_handler.get_translation())
        x = self.dyn.host_x_all()
        P = x[set_.get_global_indices(np.asarray(set_points))]
        d, _, _ = closest_point_on_triangles(P, W, triangles)
        near = [int(p) for p, di in zip(set_points, d) if di <= distance]
        return self.add_rb_point(rb_handler, set_, near, params)

    def add_rb_point(self, rb_handler, set_, points, params: AttachmentParams = None):
        """Glue deformable points to body-local points (rb-d)."""
        g = self._new_group(RBD, params)
        x = self.dyn.host_x_all()
        b = rb_handler.get_idx()
        for p in points:
            gi = int(set_.get_global_index(p))
            loc = rb_handler.transform_global_to_local_point(x[gi])
            self._elems[RBD].append({"node": gi, "body": b, "loc": loc, "group": g})
        return AttachmentHandler(self, RBD, g)

    def set_stiffness(self, kind, group, k):
        self.groups[kind][group]["stiffness"] = k
        self.stark.mark_dirty(kind)

    # -- converged-state tolerance check + hardening --
    def gaps(self, name, current: bool = False) -> np.ndarray:
        """The gap of each element of family `name` (the converged-state
        check's measure): at the trial state x1 = x0 + dt v1, or, with
        `current`, at the positions the last accepted step left."""
        elems = self._elems[name]
        if not elems:
            return np.zeros(0)
        dt = self.stark.dt
        x1 = self.dyn.host_x_all() if current else self.dyn.host_x1(dt)
        if name == RBD:
            body_point = self.rb_dyn.get_position_at if current else \
                (lambda b, loc: self.rb_dyn.get_x1(b, loc, dt))
            return np.asarray([np.linalg.norm(x1[e["node"]] - body_point(e["body"], e["loc"]))
                               for e in elems])
        n = np.asarray([e["nodes"] for e in elems], dtype=np.int64)
        if name == PP:
            d = x1[n[:, 1]] - x1[n[:, 0]]
        elif name == EE:
            b0 = np.asarray([e["bary0"] for e in elems])
            b1 = np.asarray([e["bary1"] for e in elems])
            p = b0[:, :1] * x1[n[:, 0]] + b0[:, 1:2] * x1[n[:, 1]]
            d = (b1[:, :1] * x1[n[:, 2]] + b1[:, 1:2] * x1[n[:, 3]]) - p
        else:   # PE, PT: sum_i bary_i x1[n[1 + i]] - p
            b = np.asarray([e["bary"] for e in elems])
            q = b[:, :1] * x1[n[:, 1]]
            for i in range(1, b.shape[1]):
                q = q + b[:, i:i + 1] * x1[n[:, 1 + i]]
            d = q - x1[n[:, 0]]
        return np.linalg.norm(d, axis=1)

    def _is_converged_state_valid(self) -> bool:
        if not any(self._elems[k] for k in self._elems):
            return True
        ok = True
        for name, elems in self._elems.items():
            if not elems:
                continue
            for e, gap in zip(elems, self.gaps(name)):
                grp = self.groups[name][e["group"]]
                if gap > grp["tolerance"]:
                    grp["stiffness"] *= 2.0
                    self.stark.mark_dirty(name)
                    ok = False
        if not ok:
            self.stark.output.print_with_new_line(
                "Attachments not within tolerance. Stiffness hardened.")
        return ok
