"""Seeded element tables for the kernel families of kernels M-P (K11): the
inputs `tests/test_torch_egh.py` (CPU, against JAX), `tests/test_torch_cuda.py`
(card, against the twins) and `chip_smoke.py` (the families no scene of the
smoke runs) hand to a family's kernel and its twin.

`make_case(name, seed)` gives numpy (glob, u, conn, rows) for one family:
random elements over N_SOFT soft nodes and N_BODIES rigid bodies, plus the
ties where the twin's autodiff picks a branch: an undeformed triangle (the
strain limit's clamped square root), a row with d = dhat exactly (the
barrier's gap of 0), a touching row (d = 0, the distance's floor), inactive
rows, rows past dhat and a body at w = 0.
"""
from __future__ import annotations

import numpy as np
import torch

N_SOFT, N_BODIES = 48, 3
N_ROWS = 40


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _state(rng):
    """Globals and DOFs: soft nodes 0-11 stand still (u = 0), 0-8 at the tie
    rows' exact positions; body 0 has w = 0."""
    q0 = _unit(rng.normal(size=(N_BODIES, 4)))
    A = rng.normal(size=(N_BODIES, 3, 3))
    glob = {
        "dt": np.asarray(1.0 / 30.0), "gravity": np.array([0.0, 0.0, -9.81]),
        "x0": rng.normal(0.0, 0.1, (N_SOFT, 3)), "v0": rng.normal(0.0, 0.3, (N_SOFT, 3)),
        "pt_a": rng.normal(0.0, 1.0, (N_SOFT, 3)), "pt_f": rng.normal(0.0, 0.1, (N_SOFT, 3)),
        "X": rng.normal(0.0, 0.1, (N_SOFT, 3)),
        "rb_t0": rng.normal(0.0, 0.1, (N_BODIES, 3)), "rb_q0": q0,
        "rb_v0": rng.normal(0.0, 0.3, (N_BODIES, 3)),
        "rb_w0": rng.normal(0.0, 1.0, (N_BODIES, 3)),
        "rb_a": rng.normal(0.0, 1.0, (N_BODIES, 3)),
        "rb_aa": rng.normal(0.0, 1.0, (N_BODIES, 3)),
        "rb_force": rng.normal(0.0, 1.0, (N_BODIES, 3)),
        "rb_torque": rng.normal(0.0, 1.0, (N_BODIES, 3)),
        "rb_J0glob": np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(3),
        "contact_k": np.asarray(1e3),
    }
    # the PT tie: p over the face of ((0,0,0), (1,0,0), (0,1,0)) at 0.5; the
    # EE tie: (0,0,0)-(1,0,0) against (.5,-.5,.5)-(.5,.5,.5), both exactly 0.5
    glob["x0"][0:4] = [[0.25, 0.25, 0.5], [0, 0, 0], [1, 0, 0], [0, 1, 0]]
    glob["x0"][4:8] = [[0, 0, 0], [1, 0, 0], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5]]
    glob["X"][4:8] = glob["x0"][4:8]
    # a touching point: on the face of the triangle 1-3
    glob["x0"][8] = [0.25, 0.25, 0.0]
    u = rng.normal(0.0, 0.3, (N_SOFT + 2 * N_BODIES, 3))
    u[0:12] = 0.0
    u[N_SOFT + 1] = 0.0                      # body 0: w = 0
    return glob, u


def _soft(rng, n, k, lo=12):
    """n rows of k distinct soft nodes, past the tie nodes."""
    return np.stack([lo + rng.choice(N_SOFT - lo, k, replace=False) for _ in range(n)])


def _vw(b):
    return N_SOFT + 2 * np.asarray(b), N_SOFT + 2 * np.asarray(b) + 1


def _active(rng, n):
    a = (rng.random(n) < 0.8).astype(np.float64)
    a[:4] = 1.0
    return a


def _strain_rows(rng, glob, n):
    nodes = _soft(rng, n, 3)
    nodes[0] = [1, 2, 3]           # undeformed (u = 0 at its nodes)
    X = glob["x0"][nodes]
    u = _unit(X[:, 1] - X[:, 0])
    nrm = np.cross(u, X[:, 2] - X[:, 0])
    v = _unit(np.cross(u, nrm))
    e1, e2 = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]
    DX = np.stack([np.stack([np.sum(u * e1, 1), np.sum(u * e2, 1)], 1),
                   np.stack([np.sum(v * e1, 1), np.sum(v * e2, 1)], 1)], 1)
    # no limit: 10 (float32's twin turns 1e30, the providers' "inf", into
    # NaN derivatives through its unselected cubic branch)
    lim = np.where(rng.random(n) < 0.5, 0.01, 10.0)
    lim[0] = 0.0                   # the undeformed row meets the limit's kink
    return nodes, {
        "nodes": nodes, "DXinv": np.linalg.inv(DX),
        "rest_area": 0.5 * np.linalg.norm(np.cross(X[:, 0] - X[:, 2], X[:, 1] - X[:, 2]), axis=1),
        "thickness": rng.uniform(1e-3, 2e-3, n), "youngs_modulus": rng.uniform(1e3, 1e4, n),
        "poissons_ratio": rng.uniform(0.1, 0.45, n), "strain_damping": rng.uniform(0.0, 1.0, n),
        "strain_limit": lim, "strain_limit_stiffness": rng.uniform(1e3, 1e6, n),
        "inflation": rng.uniform(-1.0, 1.0, n)}


def _contact_rows(rng, glob, stem, n):
    """Rows of contact_<stem>: random pairs of soft nodes and body points,
    plus (row 0) the exact d = dhat tie and (row 1, PT) a touching point,
    both on soft nodes; rows past dhat where dhat is small."""
    locs = lambda k: rng.normal(0.0, 0.05, (n, k, 3))
    body = lambda: rng.integers(0, N_BODIES, n)
    dhat = np.where(rng.random(n) < 0.8, 0.3, 0.02)
    pt = stem.startswith("pt")
    # pt_dr: a soft point on a rigid triangle; ee_dr: a rigid edge a
    a_rigid = stem[3] == "r" if pt else stem[3:] in ("dr", "rr")
    b_rigid = stem[4] == "r" if pt else stem[3:] == "rr"
    ka, kb = (1, 3) if pt else (2, 2)
    rows = {"active": _active(rng, n), "dhat": dhat}
    conn = []
    if a_rigid:
        b = body()
        rows["body_a"] = b
        rows["p_loc" if pt else "ea_loc"] = locs(1)[:, 0] if pt else locs(2)
        conn += list(_vw(b))
    if b_rigid:
        b = body()
        rows["body_b"] = b
        rows["t_loc" if pt else "eb_loc"] = locs(3 if pt else 2)
    if not a_rigid and not b_rigid:
        nodes = _soft(rng, n, 4)
        if pt:
            nodes[0], nodes[1] = [0, 1, 2, 3], [8, 1, 2, 3]
            dhat[0], dhat[1] = 0.5, 0.3
        else:
            nodes[0] = [4, 5, 6, 7]
            dhat[0] = 0.5
        rows["nodes"] = nodes
        return nodes, rows
    if not a_rigid:
        rows["node_p"] = _soft(rng, n, 1)[:, 0]
        conn = [rows["node_p"]]
    if not b_rigid:
        key = "nodes_t" if pt else "nodes_b"
        rows[key] = _soft(rng, n, kb)
        conn += [rows[key][:, j] for j in range(kb)]
    else:
        conn += list(_vw(rows["body_b"]))
    return np.stack(conn, 1), rows


def _family_data(name, rng, glob):
    n = N_ROWS
    if name.startswith("contact_"):
        conn, rows = _contact_rows(rng, glob, name[len("contact_"):], n)
        return conn, rows
    if name.startswith("EnergyTriangleStrain"):
        conn, rows = _strain_rows(rng, glob, n)
    elif name == "EnergyLumpedInertia":
        node = rng.integers(0, N_SOFT, n)
        rows = {"node": node, "lumped_volume": rng.uniform(1e-4, 1e-3, n),
                "density": rng.uniform(0.1, 1.0, n), "damping": rng.uniform(0.0, 1.0, n),
                "is_quasistatic": (rng.random(n) < 0.2).astype(np.float64)}
        conn = node[:, None]
    elif name == "EnergyPrescribedPositions":
        node = rng.integers(0, N_SOFT, n)
        rows = {"node": node, "target": rng.normal(0.0, 0.1, (n, 3)),
                "stiffness": rng.uniform(1e3, 1e7, n)}
        conn = node[:, None]
    elif name == "EnergyBendingFlat":
        conn = _soft(rng, n, 4)
        rows = {"nodes": conn, "bergou_K": rng.normal(size=(n, 4)),
                "bergou_coef": rng.uniform(1.0, 10.0, n), "stiffness": rng.uniform(1e-6, 1e-3, n)}
    elif name.startswith("EnergyRigidBodyInertia"):
        b = rng.integers(0, N_BODIES, n)
        rows = {"body": b, "mass": rng.uniform(0.1, 2.0, n), "damping": rng.uniform(0.0, 1.0, n),
                "is_quasistatic": (rng.random(n) < 0.2).astype(np.float64)}
        conn = _vw(b)[0 if name.endswith("Linear") else 1][:, None]
    elif name == "rb_constraint_global_points":
        a = rng.integers(0, N_BODIES, n)
        rows = {"a": a, "b": np.full(n, -1), "loc": rng.normal(0.0, 0.1, (n, 3)),
                "target": rng.normal(0.0, 0.1, (n, 3)), "stiffness": rng.uniform(1e3, 1e6, n)}
        conn = np.stack(_vw(a), 1)
    else:   # rb_constraint_global_directions
        a = rng.integers(0, N_BODIES, n)
        rows = {"a": a, "b": np.full(n, -1), "d_loc": _unit(rng.normal(size=(n, 3))),
                "target": _unit(rng.normal(size=(n, 3))), "stiffness": rng.uniform(1e3, 1e6, n)}
        conn = _vw(a)[1][:, None]
    rows["active"] = _active(rng, n)
    return conn, rows


def per_elem_err(out, ref):
    """max over elements of |out - ref| / max|ref_e| (exact zeros where the
    reference row is all zero)."""
    out = np.asarray(out, dtype=np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, dtype=np.float64).reshape(len(ref), -1)
    scale = np.max(np.abs(ref), axis=1, keepdims=True)
    err = np.abs(out - ref)
    return float(np.max(np.where(scale > 0, err / np.where(scale > 0, scale, 1.0),
                                 np.where(err > 0, np.inf, 0.0))))


def make_case(name: str, seed: int):
    """numpy (glob, u, conn, rows) of family `name` (its registry name)."""
    rng = np.random.default_rng(seed)
    glob, u = _state(rng)
    conn, rows = _family_data(name, rng, glob)
    return glob, u, conn, rows


def to_torch(glob, u, conn, rows, dtype=torch.float64, device="cpu"):
    """The case as tensors: floats in `dtype`, indices int64."""
    def t(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, dtype=dtype, device=device)
        return torch.as_tensor(a.astype(np.int64), device=device)

    return ({k: t(v) for k, v in glob.items()}, t(u), t(conn),
            {k: t(v) for k, v in rows.items()})


KERNEL_FAMILIES = (
    "EnergyTriangleStrain", "EnergyTriangleStrain_ElasticityOnly", "EnergyLumpedInertia",
    "EnergyPrescribedPositions", "EnergyBendingFlat", "EnergyRigidBodyInertia_Linear",
    "EnergyRigidBodyInertia_Angular", "rb_constraint_global_points",
    "rb_constraint_global_directions", "contact_pt_dd", "contact_pt_dr", "contact_pt_rd",
    "contact_pt_rr", "contact_ee_dd", "contact_ee_dr", "contact_ee_rr")


def port_families(barrier: str = "Cubic"):
    """The port's registered families by name (a CPU Simulation; their
    kernel launchers take tensors on any card)."""
    from stark_tpu_torch import Settings, Simulation

    s = Settings()
    s.output.enable_output = False
    s.device.device = "cpu"
    sim = Simulation(s)
    sim.interactions.contact.ipc_barrier_type = barrier
    return {f.name: f for f in sim.stark.global_potential.families}


def f64_spread(energy_fn, u64, conn, rows64, glob64, draws: int = 3, seed: int = 0):
    """Per element, how far the float64 twin's e, g and H move when the
    positions and rotations move by what rounding them to float32 alone
    may do: every soft point and body origin by +-eps32 X (X the largest
    |coordinate| of x0 and rb_t0), every body's rotation by +-4 eps32
    radians per axis (its matrix is built from the quaternion in about four
    roundings per entry); random signs, `draws` draws, the largest move
    kept. The DOF blocks are the soft nodes', then each body's v and w.
    Returns (e, g, H) spreads, each (E,)."""
    from ..ops import egh

    eps = torch.finfo(torch.float32).eps
    dt = float(glob64["dt"])
    X = max([float(glob64[k].abs().max()) for k in ("x0", "rb_t0")
             if k in glob64 and glob64[k].numel()] or [1.0])
    step = torch.full((u64.shape[0], 1), eps * X / dt, dtype=u64.dtype, device=u64.device)
    if "rb_q0" in glob64:
        n_soft = u64.shape[0] - 2 * glob64["rb_q0"].shape[0]
        step[n_soft + 1::2] = 4.0 * eps / dt
    gen = torch.Generator().manual_seed(seed)
    ref = egh.plain(energy_fn, u64, conn, rows64, glob64)
    n = conn.shape[0]
    out = [torch.zeros(n, dtype=torch.float64, device=u64.device) for _ in ref]
    for _ in range(draws):
        sign = torch.randint(0, 2, u64.shape, generator=gen).to(u64) * 2.0 - 1.0
        moved = egh.plain(energy_fn, u64 + step * sign, conn, rows64, glob64)
        for k, (a, b) in enumerate(zip(moved, ref)):
            out[k] = torch.maximum(out[k], (a - b).reshape(n, -1).abs().amax(dim=1)
                                   if n else out[k])
    return tuple(out)


def f32_ratio(out32, twin32, twin64, part: str, spread) -> tuple:
    """A float32 kernel result against its twins, element by element:
    (the worst ratio of an element's error to its tolerance, <= 1 passes;
    the number of elements held by the second rule below).

    An element passes within 64 eps of its largest |entry| of the f32 twin
    (for `part` "e": of the family's largest |e|, since the energies are
    summed over the family). Where no float32 evaluation can come that
    close, because the f32 twin itself lies farther from the f64 twin or
    because rounding the positions moves the f64 twin farther (`spread`,
    f64_spread's for this part), the element may instead lie within twice
    the larger of those two distances from the f64 twin."""
    n = out32.shape[0]
    if n == 0:
        return 0.0, 0
    o = out32.double().reshape(n, -1)
    t = twin32.double().reshape(n, -1).to(o.device)
    r = twin64.double().reshape(n, -1).to(o.device)
    eps = torch.finfo(torch.float32).eps
    tiny = torch.finfo(torch.float32).tiny
    scale = t.abs().amax(dim=1)
    if part == "e":
        scale = torch.full_like(scale, float(t.abs().max()))
    tol = 64.0 * eps * scale + tiny
    ratio = (o - t).abs().amax(dim=1) / tol
    floor = torch.maximum((t - r).abs().amax(dim=1), spread.to(o.device))
    by_floor = (o - r).abs().amax(dim=1) / (2.0 * floor + tiny)
    wide = (floor > tol) & (by_floor < ratio)
    ratio = torch.where(wide, by_floor, ratio)
    return float(ratio.max()), int(wide.sum())


def f64_err(out64, twin64, part: str) -> float:
    """The worst per-element relative distance of a float64 kernel result
    from its twin: each element's entries against its largest |entry|
    (for `part` "e": against the family's largest |e|, since the energies
    are summed over the family; an energy of a barrier row at a tiny gap
    carries its gap's relative rounding)."""
    if part != "e":
        return per_elem_err(out64, twin64)
    ref = np.asarray(twin64, dtype=np.float64).reshape(-1)
    out = np.asarray(out64, dtype=np.float64).reshape(-1)
    scale = np.max(np.abs(ref)) if ref.size else 0.0
    err = np.max(np.abs(out - ref)) if ref.size else 0.0
    return float(err / scale) if scale > 0 else (0.0 if err == 0 else float("inf"))
