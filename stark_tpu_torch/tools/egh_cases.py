"""Seeded element tables for the kernel families of kernels M-V (K11): the
inputs `tests/test_torch_egh.py` (CPU, against JAX), `tests/test_torch_cuda.py`
(card, against the twins) and `chip_smoke.py` (the families no scene of the
smoke runs) hand to a family's kernel and its twin.

`make_case(name, seed)` gives numpy (glob, u, conn, rows) for one family:
random elements over N_SOFT soft nodes and N_BODIES rigid bodies, plus the
ties where the twin's autodiff picks a branch: an undeformed triangle or
tet (the strain limit's clamped square root), a segment of zero length
(safe_norm's clamp), a row with d = dhat exactly (the barrier's gap of 0),
a touching row (d = 0, the distance's floor), friction rows at rest (stick)
and exactly at u = epsu (the slide branch), inactive rows (some with the
zero tables of capacity padding), rows past dhat and a body at w = 0;
for the joints (T, U) angle and distance limits on both sides, an angle
limit at rest, zero-length distances and the velocity controllers at dv =
+-delay exactly; for full shells (V) a flat stencil.
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
    lim = np.where(rng.random(n) < 0.5, 0.01, 10.0)
    lim[0] = 0.0                   # the undeformed row meets the limit's kink
    # (10 for no limit: the float32 twin read 1e30, the providers' "inf",
    # as NaN derivatives before maths.cubic_one_sided's double where)
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


def _segment_rows(rng, glob, n):
    """Rods: random segments, an undeformed one (row 0, at the limit's
    kink) and one of zero length (row 1: safe_norm's clamp)."""
    nodes = _soft(rng, n, 2)
    nodes[0], nodes[1] = [1, 2], [9, 10]
    glob["x0"][10] = glob["x0"][9]
    X = glob["x0"][nodes]
    l_rest = np.linalg.norm(X[:, 0] - X[:, 1], axis=1)
    l_rest[1] = 0.05
    lim = np.where(rng.random(n) < 0.5, 0.01, 10.0)
    lim[0] = 0.0
    return nodes, {
        "nodes": nodes, "l_rest": l_rest, "section_radius": rng.uniform(1e-3, 5e-3, n),
        "youngs_modulus": rng.uniform(1e3, 1e6, n), "strain_damping": rng.uniform(0.0, 1.0, n),
        "strain_limit": lim, "strain_limit_stiffness": rng.uniform(1e3, 1e5, n)}


def _tet_rows(rng, glob, n):
    """Tets over well-shaped node quadruples (rest = x0, so F = I where u
    = 0), row 0 at rest and compressed uniformly, F = I / 1.05 (dev E = 0
    to rounding: safe_sqrt's clamp; at F = I itself the elastic gradient
    is rounding noise, as the Stable Neo-Hookean rest state cancels)."""
    x0 = glob["x0"]
    nodes = [[0, 1, 2, 3]]
    while len(nodes) < n:
        q = _soft(rng, 1, 4)[0]
        D = np.stack([x0[q[k]] - x0[q[0]] for k in (1, 2, 3)], axis=1)
        edges = np.linalg.norm(D, axis=0)
        if abs(np.linalg.det(D)) > 0.05 * np.prod(edges):
            nodes.append(q.tolist())
    nodes = np.asarray(nodes)
    X = x0[nodes]
    DX = np.stack([X[:, 1] - X[:, 0], X[:, 2] - X[:, 0], X[:, 3] - X[:, 0]], axis=2)
    lim = np.where(rng.random(n) < 0.5, 0.01, 10.0)
    DXinv = np.linalg.inv(DX)
    DXinv[0] /= 1.05
    return nodes, {
        "nodes": nodes, "DXinv": DXinv, "rest_volume": np.linalg.det(DX) / 6.0,
        "youngs_modulus": rng.uniform(1e3, 1e5, n), "poissons_ratio": rng.uniform(0.1, 0.45, n),
        "strain_damping": rng.uniform(0.0, 1.0, n), "strain_limit": lim,
        "strain_limit_stiffness": rng.uniform(1e2, 1e4, n)}


def _friction_tie(glob, u):
    """Node 9's velocity and friction_epsv such that a row between node 9
    and nodes at rest, with T = [[1, 0, 0], [0, 1, 0]], has u = |ut| =
    epsu exactly in float64: ut_1 cancels the perturbation to 0, and dt
    epsv rounds to ut_0 (every operation of the twin and the kernel on it
    exact or one rounding alike)."""
    dt = float(glob["dt"])
    p0, p1 = 1.13 * 1e-9, -1.07 * 1e-9
    vy = -p1 / dt
    for _ in range(64):
        if vy * dt == -p1:
            break
        vy = np.nextafter(vy, np.inf if vy * dt < -p1 else -np.inf)
    assert vy * dt == -p1
    for a in np.linspace(0.4, 0.8, 41):
        ut0 = a * dt + p0
        epsv = ut0 / dt
        for k in range(-8, 9):
            e = epsv + k * np.spacing(epsv)
            if dt * e == ut0:
                # the row's vrel = 0 - u9
                u[9] = [-a, -vy, 0.0]
                glob["friction_epsv"] = np.asarray(e)
                return
    raise AssertionError("no exact friction tie")


def _friction_rows(rng, glob, u, stem, n):
    """Rows of friction_<stem>: the sides of contact_<stem>'s rows with a
    frozen orthonormal tangent basis T, mu, fn and anchors (bary, or s and
    t); for the soft-soft families a stick row at rest (row 1) and the
    exact u = epsu tie (row 0); inactive rows, two of them zeroed as the
    capacity padding leaves them."""
    conn, rows = _contact_rows(rng, glob, stem, n)
    del rows["dhat"]
    if stem.endswith("rr"):
        # two bodies: a body does not rub itself (the same body on both
        # sides at w = 0 leaves vb - va at rounding noise, a gradient of
        # the perturbation's size that any rounding moves by 1e-9 of itself)
        rows["body_b"] = (rows["body_a"] + 1 + rng.integers(0, N_BODIES - 1, n)) % N_BODIES
        conn = np.stack(list(_vw(rows["body_a"])) + list(_vw(rows["body_b"])), 1)
    _friction_tie(glob, u)
    a = rng.normal(size=(n, 3))
    b = rng.normal(size=(n, 3))
    t0 = _unit(a)
    t1 = _unit(b - np.sum(b * t0, axis=1, keepdims=True) * t0)
    rows["T"] = np.stack([t0, t1], axis=1)
    rows["mu"] = rng.uniform(0.1, 1.0, n)
    rows["fn"] = rng.uniform(0.1, 10.0, n)
    if stem.startswith("pt"):
        bary = rng.uniform(0.05, 1.0, (n, 3))
        rows["bary"] = bary / bary.sum(axis=1, keepdims=True)
    else:
        rows["s"], rows["t"] = rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 1.0, n)
    if stem in ("pt_dd", "ee_dd"):
        rows["nodes"][0], rows["nodes"][1] = [9, 10, 11, 0], [1, 2, 3, 4]
        conn = rows["nodes"]
        rows["T"][0] = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
        if stem == "pt_dd":
            rows["bary"][0] = [0.2, 0.3, 0.5]
        else:
            rows["s"][0], rows["t"][0] = 0.0, 0.5
    rows["active"][n - 2:] = 0.0
    for k in ("T", "mu", "fn"):
        rows[k][n - 2:] = 0.0
    return conn, rows


def _x1_d1(glob, u, body, loc):
    """numpy x1 and d1 = R1 loc of body-local `loc` under the case's w (the
    rows' geometry, to place the limits' rows)."""
    from ..maths import np_quat_time_integration, np_quat_to_rotation

    dt = float(glob["dt"])
    v, w = u[N_SOFT + 2 * body], u[N_SOFT + 2 * body + 1]
    R1 = np_quat_to_rotation(np_quat_time_integration(glob["rb_q0"][body], w, dt))
    d = np.einsum("nij,nj->ni", R1, loc)
    return glob["rb_t0"][body] + dt * v + d, d


def _joint_rows(name, rng, glob, u, n):
    """Rows of the rigid joint families (kernels T and U): random pairs of
    distinct bodies, plus the ties where the twin's autodiff picks a branch.
    Body 0 turns with w = 0 from q0 = 1, so its directions are exact: row 0
    of an angle limit at rest (the same direction of body 0 twice: l is
    safe_norm's 1e-15, the where's zero); rows 0 and 1 of the velocity
    controllers at dv = +delay and -delay exactly (the inner where's E_r and
    E_c); rows on both sides of the limits; the distance families' row 1 of
    zero length (the same point of one body twice: safe_norm's clamp)."""
    glob["rb_q0"][0] = [1.0, 0.0, 0.0, 0.0]
    kind = name[len("rb_constraint_"):]
    a = rng.integers(0, N_BODIES, n)
    b = (a + 1 + rng.integers(0, N_BODIES - 1, n)) % N_BODIES
    rows = {"stiffness": rng.uniform(1e3, 1e6, n)}
    if kind in ("linear_velocity", "angular_velocity"):
        rows["da_loc"] = _unit(rng.normal(size=(n, 3)))
        a[:2], b[:2], rows["da_loc"][:2] = 0, 1, [1.0, 0.0, 0.0]
        lin = kind == "linear_velocity"
        # v1 of bodies 0 and 1 (w1 of body 1): da1 . (vb - va) = 0.75 exactly
        if lin:
            u[N_SOFT], u[N_SOFT + 2] = [0.25, 0.3, -0.1], [1.0, -0.2, 0.4]
        else:
            u[N_SOFT + 3] = [0.75, 0.2, -0.3]
        side = lambda body: u[N_SOFT + 2 * body + (0 if lin else 1)]
        v = np.sum(_x1_d1(glob, u, a, rows["da_loc"])[1] * (side(b) - side(a)), axis=1)
        delay = rng.uniform(0.005, 0.05, n)
        # dv = v - target in each branch: below -delay, within, above
        f = rng.choice([-3.0, -0.5, 0.5, 3.0], n)
        target = v - f * delay
        delay[:2] = 2.0 ** -7
        target[:2] = [0.75 - 2.0 ** -7, 0.75 + 2.0 ** -7]
        rows["target_v" if lin else "target_w"] = target
        rows["max_force" if lin else "max_torque"] = rng.uniform(1.0, 50.0, n)
        rows["delay"] = delay
        vb, wb = _vw(b)
        va, wa = _vw(a)
        conn = np.stack([va, vb, wa] if lin else [wa, wb], 1)
    elif kind in ("directions", "angle_limits"):
        rows["da_loc"] = _unit(rng.normal(size=(n, 3)))
        rows["db_loc"] = _unit(rng.normal(size=(n, 3)))
        if kind == "angle_limits":
            a[0], b[0], rows["db_loc"][0] = 0, 0, rows["da_loc"][0]
            l = np.linalg.norm(_x1_d1(glob, u, b, rows["db_loc"])[1]
                               - _x1_d1(glob, u, a, rows["da_loc"])[1], axis=1)
            rows["max_distance"] = l * np.where(rng.random(n) < 0.5, 0.8, 1.25)
            rows["max_distance"][0] = 0.1
        conn = np.stack([_vw(a)[1], _vw(b)[1]], 1)
    else:
        rows["a_loc"] = rng.normal(0.0, 0.1, (n, 3))
        rows["b_loc"] = rng.normal(0.0, 0.1, (n, 3))
        if kind in ("distances", "distance_limits", "damped_spring"):
            b[1], rows["b_loc"][1] = a[1], rows["a_loc"][1]
        l = np.linalg.norm(_x1_d1(glob, u, b, rows["b_loc"])[0]
                           - _x1_d1(glob, u, a, rows["a_loc"])[0], axis=1)
        if kind == "point_on_axis":
            rows["da_loc"] = _unit(rng.normal(size=(n, 3)))
        elif kind == "distances":
            rows["target_distance"] = l * rng.uniform(0.8, 1.2, n)
        elif kind == "distance_limits":
            # below min, inside, above max
            where = rng.integers(0, 3, n)
            lo = np.choose(where, [1.2, 0.8, 0.5])
            rows["min_distance"], rows["max_distance"] = l * lo, l * (lo + 0.4)
            rows["min_distance"][1], rows["max_distance"][1] = 0.05, 0.2
        elif kind == "damped_spring":
            rows["rest_length"] = l * rng.uniform(0.8, 1.2, n)
            rows["damping"] = rng.uniform(0.0, 10.0, n)
        va, wa = _vw(a)
        vb, wb = _vw(b)
        conn = np.stack([va, wa, vb, wb], 1)
    rows.update(a=a, b=b)
    return conn, rows


def _shell_rows(rng, glob, n):
    """Full DiscreteShells (kernel V): random stencils (folded), and row 0
    flat: the edge from node 1 (0, 0, 0) to node 2 (1, 0, 0), wings node 3
    (0, 1, 0) and node 11 (0.5, -1, 0), all at rest (u = 0): exact, so
    n0^ . n1^ = 1 and acos sits at 1 - 100 eps."""
    glob["x0"][11] = [0.5, -1.0, 0.0]
    nodes = _soft(rng, n, 4)
    nodes[0] = [1, 2, 3, 11]
    return nodes, {
        "nodes": nodes, "rest_dihedral_angle": rng.uniform(0.0, 1.0, n),
        "rest_edge_length": rng.uniform(0.05, 0.2, n), "rest_height": rng.uniform(0.02, 0.1, n),
        "scale": rng.uniform(0.5, 2.0, n), "stiffness": rng.uniform(1e-3, 1.0, n),
        "damping": rng.uniform(0.0, 0.1, n)}


def _family_data(name, rng, glob, u):
    n = N_ROWS
    if name.startswith("contact_"):
        conn, rows = _contact_rows(rng, glob, name[len("contact_"):], n)
        return conn, rows
    if name.startswith("friction_"):
        return _friction_rows(rng, glob, u, name[len("friction_"):], n)
    if name.startswith("EnergySegmentStrain"):
        conn, rows = _segment_rows(rng, glob, n)
    elif name.startswith("EnergyTetStrain"):
        conn, rows = _tet_rows(rng, glob, n)
    elif name.startswith("EnergyTriangleStrain"):
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
    elif name == "EnergyDiscreteShells":
        conn, rows = _shell_rows(rng, glob, n)
    elif name.startswith("rb_constraint_") and name not in (
            "rb_constraint_global_points", "rb_constraint_global_directions"):
        conn, rows = _joint_rows(name, rng, glob, u, n)
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
    conn, rows = _family_data(name, rng, glob, u)
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
    "contact_pt_rr", "contact_ee_dd", "contact_ee_dr", "contact_ee_rr",
    "EnergySegmentStrain", "EnergySegmentStrain_ElasticityOnly", "EnergyTetStrain",
    "EnergyTetStrain_ElasticityOnly", "friction_pt_dd", "friction_pt_dr", "friction_pt_rd",
    "friction_pt_rr", "friction_ee_dd", "friction_ee_dr", "friction_ee_rr",
    "rb_constraint_points", "rb_constraint_point_on_axis", "rb_constraint_distances",
    "rb_constraint_distance_limits", "rb_constraint_directions", "rb_constraint_angle_limits",
    "rb_constraint_damped_spring", "rb_constraint_linear_velocity",
    "rb_constraint_angular_velocity", "EnergyDiscreteShells")


def port_families(barrier: str = "Cubic", friction: str = "C0"):
    """The port's registered families by name (a CPU Simulation; their
    kernel launchers take tensors on any card), with the barrier and
    friction types set."""
    from stark_tpu_torch import Settings, Simulation

    s = Settings()
    s.output.enable_output = False
    s.device.device = "cpu"
    sim = Simulation(s)
    sim.interactions.contact.ipc_barrier_type = barrier
    sim.interactions.contact.ipc_friction_type = friction
    return {f.name: f for f in sim.stark.global_potential.families}


def f64_spread(energy_fn, u64, conn, rows64, glob64, draws: int = 3, seed: int = 0,
               eps: float = float(torch.finfo(torch.float32).eps)):
    """Per element, how far the float64 twin's e, g and H move when the
    positions and rotations move by what rounding them alone may do at
    relative precision `eps` (float32's by default): every soft point and
    body origin by +-eps X (X the largest |coordinate| of a point: of x0,
    and of a body's origin plus its farthest local point in the rows),
    every body's rotation by +-4 eps radians per axis (its matrix is built
    from the quaternion in about four roundings per entry); random signs,
    `draws` draws, the largest move kept. The DOF blocks are the soft
    nodes', then each body's v and w. Returns (e, g, H) spreads, each (E,)."""
    from ..ops import egh

    dt = float(glob64["dt"])
    x0 = glob64.get("x0")
    X = float(x0.abs().max()) if x0 is not None and x0.numel() else 0.0
    if "rb_t0" in glob64 and glob64["rb_t0"].numel():
        locs = [float(v.abs().max()) for k, v in rows64.items()
                if k.endswith("_loc") and v.numel()]
        X = max(X, float(glob64["rb_t0"].abs().max()) + max(locs, default=0.0))
    X = X or 1.0
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


def dihedral_spread(energy_fn, u, conn, rows, glob, ulps: int = 4):
    """Per element, how far the twin's e, g and H move when every dihedral
    angle's cosine c = n0^ . n1^ moves by `ulps` units in the last place
    below 1 (both signs; maths.dihedral_angle's factor 1 - 100 eps shifted
    by as much): c is known to a few ulps whatever the order of its
    roundings (the twin's torch ops and kernel V's order part by up to 4 on
    a cloth's stencils), and near a flat edge acos magnifies that by 1 /
    (1 - c). Returns (e, g, H) spreads, each (E,)."""
    from .. import maths
    from ..ops import egh

    eps = float(torch.finfo(u.dtype).eps)
    ref = egh.plain(energy_fn, u, conn, rows, glob)
    n = conn.shape[0]
    out = [torch.zeros(n, dtype=torch.float64, device=u.device) for _ in ref]
    orig = maths.dihedral_angle
    for sign in (-1.0, 1.0):
        shifted = 100.0 * eps + sign * ulps * eps / 2.0
        maths.dihedral_angle = lambda x0, x1, x2, x3, eps=None: orig(x0, x1, x2, x3, shifted)
        try:
            moved = egh.plain(energy_fn, u, conn, rows, glob)
        finally:
            maths.dihedral_angle = orig
        for k, (a, b) in enumerate(zip(moved, ref)):
            out[k] = torch.maximum(out[k], (a - b).reshape(n, -1).abs().amax(dim=1).double()
                                   if n else out[k])
    return tuple(out)


def f64_ratio(out64, twin64, part: str, spread, tol: float = 1e-10) -> tuple:
    """A float64 kernel result against its float64 twin, element by
    element, as f32_ratio judges float32: (the worst ratio of an element's
    error to its tolerance, <= 1 passes; the number of elements held by the
    second rule). An element passes within `tol` of its largest |entry| (for
    `part` "e": of the family's largest |e|); where rounding the positions
    at float64 precision moves the twin itself farther (`spread`,
    f64_spread's with float64's eps), no float64 evaluation can come that
    close, and the element may instead lie within twice that move. Full
    DiscreteShells at a nearly flat edge is such a case: acos at 1 - 100 eps
    + (1 - c) amplifies c's last bit by 1 / (1 - c), and its `spread` is
    the larger of f64_spread's and dihedral_spread's."""
    n = out64.shape[0]
    if n == 0:
        return 0.0, 0
    o = out64.double().reshape(n, -1)
    t = twin64.double().reshape(n, -1).to(o.device)
    tiny = torch.finfo(torch.float64).tiny
    scale = t.abs().amax(dim=1)
    if part == "e":
        scale = torch.full_like(scale, float(t.abs().max()))
    bound = tol * scale + tiny
    err = (o - t).abs().amax(dim=1)
    ratio = err / bound
    floor = spread.to(o.device)
    by_floor = err / (2.0 * floor + tiny)
    wide = (floor > bound) & (by_floor < ratio)
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
