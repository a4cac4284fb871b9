"""Seeded pair grids where kernel I's box cull margin matters, for the CPU
test of its host build (tests/test_torch_pair_lists_host.py) and the card
tests (tests/test_torch_cuda.py).

`grid(kind, dtype, seed)` mixes, in both kinds (PT, EE):
- long edges (2-3 m) far from the origin (|x| up to 60 m), with points
  or edges beside them at a few millimetres, half of them axis-aligned so
  that the boxes' separation is the true distance, and their difference
  of squares cancels ~eps |ap|^2 (ROADMAP Queue 3 item 3);
- thin (sliver) and collapsed triangles, parallel, nearly parallel and
  collinear edge pairs, a zero-length edge (the classifier's guarded
  branches);
- per partnered query row, dhat set from its partner's float64 distance
  d64 as d64 (1 - r), r from -1e-3 (kept) through the cull's margin (1e-7
  .. 1e-2) to 5e-2, so that the f32 exact test keeps pairs whose f64
  distance lies above dhat;
- random background pairs, far and near.
Every primitive is its own mesh and the targets' thickness is 0; some mesh
pairs have mu = 0.
"""
import numpy as np
import torch

from ..collision import narrow_phase as nph

R_STEPS = np.array([-1e-3, 0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 5e-2])


def _far(rng, n, scale=60.0):
    return rng.uniform(-scale, scale, (n, 3))


def _axes(rng, k):
    """An orthonormal frame: axis-aligned (a signed permutation of the axes,
    so that a box's separation is the true distance) for even k, random
    for odd k."""
    if k % 2 == 0:
        m = np.eye(3)[rng.permutation(3)] * rng.choice([-1.0, 1.0], size=(3, 1))
        return m[0], m[1], m[2]
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return q[0], q[1], q[2]


def _pt_geometry(rng):
    """(points (Np, 3), triangle vertices (Nt, 3, 3), partner (Np,) or -1)."""
    pts, tris, partner = [], [], []
    # long edges far from the origin, a point beside each at 1-5 mm: in the
    # triangle's plane beyond the long edge (the point-edge difference of
    # squares), or above the face
    for k in range(64):
        o = _far(rng, 1)[0]
        a, b, n = _axes(rng, k)
        L = rng.uniform(2.0, 3.0)
        t0, t1 = o - 0.5 * L * a, o + 0.5 * L * a
        t2 = o + rng.uniform(0.05, 1.0) * b
        g = rng.uniform(1e-3, 5e-3)
        if k % 4 < 2:
            p = o + rng.uniform(-0.45, 0.45) * L * a - g * b
        else:
            p = o + rng.uniform(-0.2, 0.2) * L * a + 0.01 * b + g * n
        tris.append([t0, t1, t2])
        pts.append(p)
        partner.append(len(tris) - 1)
    # sliver triangles (nearly collinear vertices) and near points
    for k in range(16):
        o = rng.uniform(-2, 2, 3)
        a, b, n = _axes(rng, k)
        t0, t1 = o - a, o + a
        t2 = o + b * 10.0 ** rng.uniform(-9, -5) + rng.uniform(-1, 1) * a
        tris.append([t0, t1, t2])
        pts.append(o + rng.uniform(-1.2, 1.2) * a + n * rng.uniform(1e-3, 5e-3))
        partner.append(len(tris) - 1)
    # two collapsed triangles (every allowed point keeps them, at the
    # distance's floor) and a degenerate segment-like one
    c = rng.uniform(-2, 2, 3)
    tris.append([c, c, c])
    tris.append([c + 1.0, c + 1.0, c + 1.0])
    tris.append([c, c + np.array([1.0, 0, 0]), c + np.array([2.0, 0, 0])])
    # background: triangles and points in a 4 m box and far away
    for k in range(60):
        o = rng.uniform(-2, 2, 3) if k % 3 else _far(rng, 1)[0]
        tris.append(o + 0.05 * rng.normal(size=(3, 3)))
    for k in range(120):
        pts.append(rng.uniform(-2, 2, 3) if k % 3 else _far(rng, 1)[0])
        partner.append(-1)
    return np.array(pts), np.array(tris), np.array(partner)


def _ee_geometry(rng):
    """(query edges (Nq, 2, 3), target edges (Nt, 2, 3), partner (Nq,))."""
    qs, ts, partner = [], [], []
    for k in range(96):
        o = _far(rng, 1)[0] if k % 6 else rng.uniform(-2, 2, 3)
        a, b, n = _axes(rng, k // 4)
        L = rng.uniform(2.0, 3.0)
        g = rng.uniform(1e-3, 5e-3)
        kind = k % 4
        if kind == 0:     # crossing at a small gap (line-line)
            qa = [o - 0.5 * L * a, o + 0.5 * L * a]
            tb = [o - 0.4 * L * b + g * n, o + 0.4 * L * b + g * n]
        elif kind == 1:   # parallel or nearly so (sin^2 0 or ~1e-6 .. 1e-3), side by side
            s = 0.0 if k % 8 == 1 else 10.0 ** rng.uniform(-3, -1.5)
            qa = [o - 0.5 * L * a, o + 0.5 * L * a]
            tb = [o - 0.3 * L * (a + s * b) + g * n, o + 0.3 * L * (a - s * b) + g * n]
        elif kind == 2:   # collinear, end to end at a small gap
            qa = [o - L * a, o]
            tb = [o + g * a, o + (g + L) * a]
        else:             # an end beside a long edge's interior
            qa = [o - 0.5 * L * a, o + 0.5 * L * a]
            tb = [o + 0.1 * L * a + g * b, o + 0.1 * L * a + 0.5 * b]
        qs.append(qa)
        ts.append(tb)
        partner.append(len(ts) - 1)
    # a zero-length target edge and a tiny one
    c = rng.uniform(-2, 2, 3)
    ts.append([c, c])
    ts.append([c, c + 1e-12])
    for k in range(80):
        o = rng.uniform(-2, 2, 3) if k % 3 else _far(rng, 1)[0]
        ts.append(o + 0.05 * rng.normal(size=(2, 3)))
    for k in range(80):
        o = rng.uniform(-2, 2, 3) if k % 3 else _far(rng, 1)[0]
        qs.append(o + 0.3 * rng.normal(size=(2, 3)))
        partner.append(-1)
    return np.array(qs), np.array(ts), np.array(partner)


def grid(kind, dtype, seed):
    """(V, table, allowed, meshes, mu, th, scale): every primitive its own
    mesh, targets' thickness 0, each partnered row's dhat set from its
    partner's f64 distance by R_STEPS, the others' at random."""
    rng = np.random.default_rng(seed)
    if kind == "pt":
        pts, tris, partner = _pt_geometry(rng)
        nq, nt = len(pts), len(tris)
        V64 = np.concatenate([pts, tris.reshape(-1, 3)])
        table = (nq + np.arange(3 * nt)).reshape(nt, 3)
    else:
        qs, ts, partner = _ee_geometry(rng)
        nq, nt = len(qs), len(ts)
        V64 = np.concatenate([qs.reshape(-1, 3), ts.reshape(-1, 3)])
        table = np.arange(2 * (nq + nt)).reshape(nq + nt, 2)
    V = torch.as_tensor(V64, dtype=dtype)
    V64t = torch.as_tensor(V64, dtype=torch.float64)
    tq = torch.as_tensor(table, dtype=torch.long)
    if kind == "pt":
        # every vertex is a query row; the triangles' own vertices allow nothing
        nv = V64.shape[0]
        allowed = torch.zeros((nv, nt), dtype=torch.bool)
        allowed[:nq] = torch.as_tensor(rng.random((nq, nt)) < 0.85)
        d64 = nph.point_triangle_distance(V64t[:, None], *(V64t[tq[:, k]][None]
                                                           for k in range(3)))
        meshes = (torch.arange(nv, dtype=torch.int32),
                  torch.arange(nv, nv + nt, dtype=torch.int32))
        M = nv + nt
    else:
        ne = nq + nt
        allowed = torch.zeros((ne, ne), dtype=torch.bool)
        allowed[:nq, nq:] = torch.as_tensor(rng.random((nq, nt)) < 0.85)
        d64 = torch.full((ne, ne), float("inf"), dtype=torch.float64)
        d64[:nq, nq:] = nph.edge_edge_distance(
            V64t[tq[:nq, 0]][:, None], V64t[tq[:nq, 1]][:, None],
            V64t[tq[nq:, 0]][None], V64t[tq[nq:, 1]][None])
        meshes = (torch.arange(ne, dtype=torch.int32),)
        M = ne
        partner = np.where(partner >= 0, partner + nq, -1)
    rows = np.nonzero(partner >= 0)[0]
    allowed[rows, partner[rows]] = True
    th = torch.zeros(M, dtype=torch.float64)
    r = R_STEPS[rng.integers(0, len(R_STEPS), rows.size)]
    th[rows] = d64[rows, partner[rows]] * torch.as_tensor(1.0 - r)
    free = np.nonzero(partner < 0)[0]
    th[free] = torch.as_tensor(rng.uniform(0.0, 0.3, free.size))
    mu = torch.ones((M, M), dtype=dtype)
    mu[3] = mu[:, 3] = 0.0
    mu[rows[1::7]] = 0.0
    scale = 1.0 + float(V64t.abs().max())
    return (V, torch.as_tensor(table, dtype=torch.int32), allowed.to(torch.uint8), meshes,
            mu, th.to(dtype), scale)


def keys(out, nt):
    """The listed pairs' keys q * nt + t, in list order."""
    n = min(int(out[4]), out[0].shape[0])
    return (out[0][:n].long() * nt + out[1][:n].long()).tolist()


def rounding_decided(kind, V, table, meshes, th, ks, nt, scale):
    """Per key, whether |d64 - dhat64| <= 64 eps_f32 of the scale: the
    pair's f32 verdict is rounding's."""
    V64, th64, tl = V.double(), th.double(), table.long()
    i = torch.tensor([k // nt for k in ks], dtype=torch.long)
    j = torch.tensor([k % nt for k in ks], dtype=torch.long)
    if kind == "pt":
        d = nph.point_triangle_distance(V64[i], *(V64[tl[j, k]] for k in range(3)))
    else:
        d = nph.edge_edge_distance(V64[tl[i, 0]], V64[tl[i, 1]], V64[tl[j, 0]],
                                   V64[tl[j, 1]])
    dh = th64[meshes[0].long()[i]] + th64[meshes[-1].long()[j]]
    return ((d - dh).abs() <= 64 * torch.finfo(torch.float32).eps * scale).tolist()
