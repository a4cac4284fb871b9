"""Differentiable IPC contact barrier energies (frictionless).

Port of the contact half of `stark_tpu/models/interactions/
contact_energies.py` (EnergyFrictionalContact.cpp:830-1259): the cubic
(default) and log barriers, the edge-edge mollifier, and the 7 families
that cover every system combination; the distance type is classified inside
the energy as a branchless select (collision/narrow_phase.py), so one PT and
one EE family per combination replace the reference's per-type potentials.
The 7 friction families are ROADMAP Queue 1 P4.

Family table (conn = DOF block indices; see solver/dofs.py):
  contact_pt_dd [p,t0,t1,t2]      contact_ee_dd [ea0,ea1,eb0,eb1]
  contact_pt_dr [p,vB,wB]         contact_ee_dr [vA,wA,eb0,eb1]  (A rigid)
  contact_pt_rd [vA,wA,t0,t1,t2]  contact_ee_rr [vA,wA,vB,wB]
  contact_pt_rr [vA,wA,vB,wB]
"""
from __future__ import annotations

import torch

from ... import maths
from ...collision import narrow_phase as nph
from ...solver.potential import PotentialFamily


def _at(arr, idx):
    """arr[idx] for a 0-d index that stays a tensor under vmap."""
    return arr[idx[None]][0]


def _soft_x1(glob, nodes, v1_blocks):
    return glob["x0"][nodes] + glob["dt"] * v1_blocks


def _rb_x1(glob, body, v, w, locs):
    """World positions (k, 3) of body-local points under trial velocities."""
    dt = glob["dt"]
    R1 = maths.quat_integration_rotation(_at(glob["rb_q0"], body), w, dt)
    t1 = _at(glob["rb_t0"], body) + dt * v
    return t1 + locs @ R1.T


def barrier(d, dhat, k, barrier_type: str, active):
    """EnergyFrictionalContact.cpp:1225-1237, with the gap clamped at 0 so
    the potential is exactly zero for d >= dhat (the energy re-derives d
    from the trial DOFs, which may straddle dhat)."""
    gap = torch.clamp_min(dhat - d, 0.0)
    if barrier_type == "Cubic":
        return k * gap ** 3 / 3.0
    d_safe = torch.where(active, torch.clamp_min(d, 1e-35), dhat)
    return -k * gap ** 2 * torch.log(torch.clamp_max(d_safe / dhat, 1.0))


def _pt_barrier(cfg, p, t0, t1, t2, row, glob):
    active = row["active"] > 0.5
    # padded rows: coincident points would give d=0; shift p away
    p = torch.where(active, p, t0 + 1.0)
    d = nph.point_triangle_distance(p, t0, t1, t2)
    return barrier(d, row["dhat"], glob["contact_k"], cfg["barrier"], active)


def _ee_barrier(cfg, ea0, ea1, eb0, eb1, EA0, EA1, EB0, EB1, row, glob):
    active = row["active"] > 0.5
    eb0 = torch.where(active, eb0, ea0 + torch.tensor(
        [1.0, 0.0, 0.0], dtype=ea0.dtype, device=ea0.device))
    eb1 = torch.where(active, eb1, ea1 + torch.tensor(
        [1.0, 0.0, 1.0], dtype=ea0.dtype, device=ea0.device))
    d = nph.edge_edge_distance(ea0, ea1, eb0, eb1, parallel_tol=cfg["parallel_tol"])
    m = nph.edge_edge_mollifier(ea0, ea1, eb0, eb1, EA0, EA1, EB0, EB1)
    return m * barrier(d, row["dhat"], glob["contact_k"], cfg["barrier"], active)


def make_families(model):
    """The 7 contact families closed over the model's barrier type and
    parallel cutoff (read at call time, so they may be set any time before
    the first step)."""

    class _Cfg:
        def __getitem__(self, key):
            if key == "barrier":
                return model.ipc_barrier_type
            return model.edge_edge_cross_norm_sq_cutoff

    cfg = _Cfg()

    def contact_pt_dd(u_e, row, glob):
        x = _soft_x1(glob, row["nodes"], u_e)
        return _pt_barrier(cfg, x[0], x[1], x[2], x[3], row, glob)

    def contact_pt_dr(u_e, row, glob):
        p = _soft_x1(glob, row["node_p"][None], u_e[0][None])[0]
        t = _rb_x1(glob, row["body_b"], u_e[1], u_e[2], row["t_loc"])
        return _pt_barrier(cfg, p, t[0], t[1], t[2], row, glob)

    def contact_pt_rd(u_e, row, glob):
        p = _rb_x1(glob, row["body_a"], u_e[0], u_e[1], row["p_loc"][None, :])[0]
        t = _soft_x1(glob, row["nodes_t"], u_e[2:5])
        return _pt_barrier(cfg, p, t[0], t[1], t[2], row, glob)

    def contact_pt_rr(u_e, row, glob):
        p = _rb_x1(glob, row["body_a"], u_e[0], u_e[1], row["p_loc"][None, :])[0]
        t = _rb_x1(glob, row["body_b"], u_e[2], u_e[3], row["t_loc"])
        return _pt_barrier(cfg, p, t[0], t[1], t[2], row, glob)

    def contact_ee_dd(u_e, row, glob):
        x = _soft_x1(glob, row["nodes"], u_e)
        X = glob["X"][row["nodes"]]
        return _ee_barrier(cfg, x[0], x[1], x[2], x[3], X[0], X[1], X[2], X[3],
                           row, glob)

    def contact_ee_dr(u_e, row, glob):
        ea = _rb_x1(glob, row["body_a"], u_e[0], u_e[1], row["ea_loc"])
        eb = _soft_x1(glob, row["nodes_b"], u_e[2:4])
        EB = glob["X"][row["nodes_b"]]
        return _ee_barrier(cfg, ea[0], ea[1], eb[0], eb[1],
                           row["ea_loc"][0], row["ea_loc"][1], EB[0], EB[1],
                           row, glob)

    def contact_ee_rr(u_e, row, glob):
        ea = _rb_x1(glob, row["body_a"], u_e[0], u_e[1], row["ea_loc"])
        eb = _rb_x1(glob, row["body_b"], u_e[2], u_e[3], row["eb_loc"])
        return _ee_barrier(cfg, ea[0], ea[1], eb[0], eb[1],
                           row["ea_loc"][0], row["ea_loc"][1],
                           row["eb_loc"][0], row["eb_loc"][1], row, glob)

    fams = [
        PotentialFamily("contact_pt_dd", 4, contact_pt_dd, dynamic=True),
        PotentialFamily("contact_pt_dr", 3, contact_pt_dr, dynamic=True),
        PotentialFamily("contact_pt_rd", 5, contact_pt_rd, dynamic=True),
        PotentialFamily("contact_pt_rr", 4, contact_pt_rr, dynamic=True),
        PotentialFamily("contact_ee_dd", 4, contact_ee_dd, dynamic=True),
        PotentialFamily("contact_ee_dr", 4, contact_ee_dr, dynamic=True),
        PotentialFamily("contact_ee_rr", 4, contact_ee_rr, dynamic=True),
    ]
    return {f.name: f for f in fams}
