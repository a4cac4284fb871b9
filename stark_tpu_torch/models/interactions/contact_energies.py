"""Differentiable IPC contact barrier and lagged-friction energies.

Port of `stark_tpu/models/interactions/contact_energies.py`
(EnergyFrictionalContact.cpp:830-1289): the cubic (default) and log
barriers, the edge-edge mollifier, the lagged friction potential (C0 or C1
stick-slide transition, with the fixed 1e-9 perturbation that keeps |u|
differentiable at 0), and 7 contact plus 7 friction families that cover
every system combination; the distance type is classified inside the
energy as a branchless select (collision/narrow_phase.py), so one PT and one
EE family per combination replace the reference's per-type potentials.

Family table (conn = DOF block indices; see solver/dofs.py):
  contact_pt_dd [p,t0,t1,t2]      contact_ee_dd [ea0,ea1,eb0,eb1]
  contact_pt_dr [p,vB,wB]         contact_ee_dr [vA,wA,eb0,eb1]  (A rigid)
  contact_pt_rd [vA,wA,t0,t1,t2]  contact_ee_rr [vA,wA,vB,wB]
  contact_pt_rr [vA,wA,vB,wB]
plus friction_* with the same connectivity and frozen per-pair (T, mu, fn,
bary or s, t) rows.
"""
from __future__ import annotations

import torch

from ... import maths
from ...collision import narrow_phase as nph
from ...ops import egh
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


def _rb_point_vel(glob, body, v, w, locs):
    """World velocities (k, 3) of body-local points under trial velocities:
    v + w x (x1 - t1) (RigidBodyDynamics.cpp:66-87)."""
    R1 = maths.quat_integration_rotation(_at(glob["rb_q0"], body), w, glob["dt"])
    r = locs @ R1.T
    return v[None, :] + torch.linalg.cross(w.expand_as(r), r, dim=-1)


def barrier(d, dhat, k, barrier_type: str, active):
    """EnergyFrictionalContact.cpp:1225-1237, with the gap clamped at 0 so
    the potential is exactly zero for d >= dhat (the energy re-derives d
    from the trial DOFs, which may straddle dhat)."""
    gap = torch.clamp_min(dhat - d, 0.0)
    if barrier_type == "Cubic":
        return k * gap ** 3 / 3.0
    d_safe = torch.where(active, torch.clamp_min(d, 1e-35), dhat)
    return -k * gap ** 2 * torch.log(torch.clamp_max(d_safe / dhat, 1.0))


def barrier_force(d, dhat, k, barrier_type: str):
    """Normal force magnitude -dE/dd of the barrier, the lagged friction's fn
    (cpp:1238-1250). The reference's Log branch returns +dE/dd, negative
    for d < dhat, which turns friction into propulsion; this is the
    repulsive magnitude k(dhat-d)(dhat-d-2d log(d/dhat))/d, as in the JAX
    package. The default Cubic branch is the reference's."""
    gap = torch.clamp_min(dhat - d, 0.0)
    if barrier_type == "Cubic":
        return k * gap ** 2
    d_safe = torch.clamp_min(d, 1e-35)
    return (k * gap
            * (gap - 2.0 * d_safe * torch.log(torch.clamp_max(d_safe / dhat, 1.0)))) / d_safe


def friction_potential(v_rel, fn, mu, T, epsv, dt, friction_type: str):
    """cpp:1260-1289: the potential of the tangential displacement
    u = T v_rel dt, perturbed by a fixed 1e-9 so that |u| stays
    differentiable at u = 0. C0 is quadratic below the stick-slide
    displacement epsu = dt*epsv, C1 cubic; both are linear above it."""
    PERT = 1e-9
    pert = torch.tensor([1.13 * PERT, -1.07 * PERT], dtype=v_rel.dtype,
                        device=v_rel.device)
    ut = (T @ v_rel) * dt + pert
    u = torch.sqrt(torch.dot(ut, ut))
    epsu = dt * epsv
    if friction_type == "C0":
        k = mu * fn / epsu
        eps = epsu / 2.0    # mu*fn/(2k), written so that mu*fn = 0 stays finite
        E_stick = 0.5 * k * u * u
        E_slide = mu * fn * (u - eps)
        return torch.where(u < epsu, E_stick, E_slide)
    E_stick = mu * fn * (-u ** 3 / (3.0 * epsu ** 2) + u * u / epsu + epsu / 3.0)
    E_slide = mu * fn * u
    return torch.where(u < epsu, E_stick, E_slide)


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


# per contact stem: (side A's index table, its local positions, side B's
# index table, its local positions); None where a side is soft
_CONTACT_SIDES = {
    "pt_dd": ("nodes", None, "nodes", None),
    "pt_dr": ("node_p", None, "body_b", "t_loc"),
    "pt_rd": ("body_a", "p_loc", "nodes_t", None),
    "pt_rr": ("body_a", "p_loc", "body_b", "t_loc"),
    "ee_dd": ("nodes", None, "nodes", None),
    "ee_dr": ("body_a", "ea_loc", "nodes_b", None),
    "ee_rr": ("body_a", "ea_loc", "body_b", "eb_loc"),
}


def _contact_reads(stem):
    """The tables kernels N and O's entry for contact_<stem> reads
    (csrc/egh_contact.cu), in its order: ("r", key) a row table, ("g", key)
    a global, None a slot it leaves unread (X: edge-edge only)."""
    return [("r", "dhat"), ("g", "contact_k"), ("g", "dt"), ("g", "x0"),
            ("g", "X") if stem.startswith("ee") else None, ("g", "rb_t0"),
            ("g", "rb_q0")] + [None if k is None else ("r", k) for k in _CONTACT_SIDES[stem]]


def make_families(model):
    """The 14 contact and friction families closed over the model's barrier
    and friction types and parallel cutoff (read at call time, so they may
    be set any time before the first step)."""

    class _Cfg:
        def __getitem__(self, key):
            if key == "barrier":
                return model.ipc_barrier_type
            if key == "friction":
                return model.ipc_friction_type
            return model.edge_edge_cross_norm_sq_cutoff

    cfg = _Cfg()

    def scalars(dtype):
        # kernels N and O's float arguments: Log barrier, EE parallel cutoff
        ptol = cfg["parallel_tol"]
        return (1.0 if cfg["barrier"] == "Log" else 0.0,
                nph._parallel_tol(dtype) if ptol is None else ptol)

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

    # ---- friction: the potential of the relative velocity of the frozen
    # closest points (vb - va) ----
    def _fric(row, glob, va, vb):
        return friction_potential(vb - va, row["fn"], row["mu"], row["T"],
                                  glob["friction_epsv"], glob["dt"], cfg["friction"])

    def friction_pt_dd(u_e, row, glob):
        return _fric(row, glob, u_e[0], row["bary"] @ u_e[1:4])

    def friction_pt_dr(u_e, row, glob):
        vtri = _rb_point_vel(glob, row["body_b"], u_e[1], u_e[2], row["t_loc"])
        return _fric(row, glob, u_e[0], row["bary"] @ vtri)

    def friction_pt_rd(u_e, row, glob):
        vp = _rb_point_vel(glob, row["body_a"], u_e[0], u_e[1], row["p_loc"][None, :])[0]
        return _fric(row, glob, vp, row["bary"] @ u_e[2:5])

    def friction_pt_rr(u_e, row, glob):
        vp = _rb_point_vel(glob, row["body_a"], u_e[0], u_e[1], row["p_loc"][None, :])[0]
        vtri = _rb_point_vel(glob, row["body_b"], u_e[2], u_e[3], row["t_loc"])
        return _fric(row, glob, vp, row["bary"] @ vtri)

    def friction_ee_dd(u_e, row, glob):
        va = u_e[0] + row["s"] * (u_e[1] - u_e[0])
        vb = u_e[2] + row["t"] * (u_e[3] - u_e[2])
        return _fric(row, glob, va, vb)

    def friction_ee_dr(u_e, row, glob):
        vea = _rb_point_vel(glob, row["body_a"], u_e[0], u_e[1], row["ea_loc"])
        va = vea[0] + row["s"] * (vea[1] - vea[0])
        vb = u_e[2] + row["t"] * (u_e[3] - u_e[2])
        return _fric(row, glob, va, vb)

    def friction_ee_rr(u_e, row, glob):
        vea = _rb_point_vel(glob, row["body_a"], u_e[0], u_e[1], row["ea_loc"])
        veb = _rb_point_vel(glob, row["body_b"], u_e[2], u_e[3], row["eb_loc"])
        va = vea[0] + row["s"] * (vea[1] - vea[0])
        vb = veb[0] + row["t"] * (veb[1] - veb[0])
        return _fric(row, glob, va, vb)

    def contact(stem, arity, fn):
        # on the card: kernel N (PT) or O (EE)
        return PotentialFamily("contact_" + stem, arity, fn, dynamic=True,
                               kernel=egh.kernel("egh_contact", stem, _contact_reads(stem),
                                                 scalars))

    fams = [
        contact("pt_dd", 4, contact_pt_dd),
        contact("pt_dr", 3, contact_pt_dr),
        contact("pt_rd", 5, contact_pt_rd),
        contact("pt_rr", 4, contact_pt_rr),
        contact("ee_dd", 4, contact_ee_dd),
        contact("ee_dr", 4, contact_ee_dr),
        contact("ee_rr", 4, contact_ee_rr),
        PotentialFamily("friction_pt_dd", 4, friction_pt_dd, dynamic=True),
        PotentialFamily("friction_pt_dr", 3, friction_pt_dr, dynamic=True),
        PotentialFamily("friction_pt_rd", 5, friction_pt_rd, dynamic=True),
        PotentialFamily("friction_pt_rr", 4, friction_pt_rr, dynamic=True),
        PotentialFamily("friction_ee_dd", 4, friction_ee_dd, dynamic=True),
        PotentialFamily("friction_ee_dr", 4, friction_ee_dr, dynamic=True),
        PotentialFamily("friction_ee_rr", 4, friction_ee_rr, dynamic=True),
    ]
    return {f.name: f for f in fams}
