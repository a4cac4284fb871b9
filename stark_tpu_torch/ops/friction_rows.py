"""Kernel J: the per-row lagged-friction anchors (csrc/friction_rows.cu), and
their twins.

Replaces the per-stem row pass of stark_tpu/models/interactions/
contact_engine.py `friction_tables` (:1588-1630): for each friction pair
row, its distance region, the closest-point weights (PT: barycentric
`point_triangle_bary`, narrow_phase.py:172; EE: line parameters
`edge_edge_params`, :333), the 2x3 tangent basis (`point_triangle_T` :238,
`edge_edge_T` :367), Coulomb mu of the two meshes, and the normal force
fn = barrier_force(d, dhat, k) (contact_energies.py:85). JAX evaluates every
region's candidate and selects one-hot; the kernel evaluates the row's own
region only.

Rows at or past min(count, R) are inactive: every output is 0 there and the
region is -1. The count stays on the device.
"""
from __future__ import annotations

import torch

from ..collision import narrow_phase as nph
from ..models.interactions.contact_energies import barrier_force
from . import build

_BARRIER = {"Cubic": 0, "Log": 1}


def _active(R, count, dev):
    return torch.arange(R, device=dev) < torch.clamp_max(count.to(dev), R)


def _masked(act, *xs):
    out = []
    for x in xs:
        m = act.reshape(act.shape + (1,) * (x.dim() - 1))
        out.append(torch.where(m, x, torch.zeros_like(x)))
    return out


def friction_rows_pt_plain(V, tris, q, t, count, d, dhat, p_mesh, t_mesh, mu_mat, k,
                           barrier: str):
    """Plain PyTorch twin: (region (R,) int32, bary (R, 3), T (R, 2, 3),
    mu (R,), fn (R,))."""
    R = q.shape[0]
    act = _active(R, count, V.device)
    tq = tris[t.long()].long()
    p, t0, t1, t2 = V[q.long()], V[tq[:, 0]], V[tq[:, 1]], V[tq[:, 2]]
    region = nph.point_triangle_region(p, t0, t1, t2)
    bary = nph.point_triangle_bary(p, t0, t1, t2, region)
    T = nph.point_triangle_T(p, t0, t1, t2, region)
    mu = mu_mat[p_mesh[q.long()].long(), t_mesh[t.long()].long()]
    fn = barrier_force(d, dhat, k, barrier)
    bary, T, mu, fn = _masked(act, bary, T, mu, fn)
    region = torch.where(act, region, torch.full_like(region, -1)).to(torch.int32)
    return region, bary, T, mu, fn


def friction_rows_ee_plain(V, edges, a, b, count, d, dhat, e_mesh, mu_mat, k,
                           barrier: str, ptol=None):
    """Plain PyTorch twin: (region (R,) int32, st (R, 2) = (s, t),
    T (R, 2, 3), mu (R,), fn (R,)) for edge a against edge b."""
    R = a.shape[0]
    act = _active(R, count, V.device)
    ea, eb = edges[a.long()].long(), edges[b.long()].long()
    a0, a1, b0, b1 = V[ea[:, 0]], V[ea[:, 1]], V[eb[:, 0]], V[eb[:, 1]]
    region = nph.edge_edge_region(a0, a1, b0, b1, ptol)
    s, tt = nph.edge_edge_params(a0, a1, b0, b1, region)
    T = nph.edge_edge_T(a0, a1, b0, b1, region)
    mu = mu_mat[e_mesh[a.long()].long(), e_mesh[b.long()].long()]
    fn = barrier_force(d, dhat, k, barrier)
    st, T, mu, fn = _masked(act, torch.stack([s, tt], -1), T, mu, fn)
    region = torch.where(act, region, torch.full_like(region, -1)).to(torch.int32)
    return region, st, T, mu, fn


def _outputs(R, width, dtype, dev):
    f = dict(dtype=dtype, device=dev)
    return (torch.empty((R,), dtype=torch.int32, device=dev),
            torch.empty((R, width), **f), torch.empty((R, 2, 3), **f),
            torch.empty((R,), **f), torch.empty((R,), **f))


def _prep(name, V, table, rows, count, d, dhat, meshes, mu_mat, k):
    V, d, dhat, mu_mat = (x.contiguous() for x in (V, d, dhat, mu_mat))
    k = torch.as_tensor(k, dtype=V.dtype, device=V.device).reshape(()).contiguous()
    rows = [r.to(torch.int32).contiguous() for r in rows]
    build.require_cuda(name, V, table, *rows, count, d, dhat, *meshes, mu_mat, k)
    if table.dtype != torch.int32 or count.dtype != torch.int32 \
            or any(m.dtype != torch.int32 for m in meshes):
        raise TypeError(f"{name}: tables, mesh ids and the count must be int32")
    if any(x.dtype != V.dtype for x in (d, dhat, mu_mat)):
        raise TypeError(f"{name}: d, dhat and mu_mat must have the vertices' dtype")
    return V, rows, d, dhat, mu_mat, k


def friction_rows_pt(V, tris, q, t, count, d, dhat, p_mesh, t_mesh, mu_mat, k,
                     barrier: str):
    """Per PT friction row (point q against triangle t of tris over V, d and
    dhat from kernel I): (region, bary, T, mu, fn) as the twin. k is the
    barrier stiffness (a 0-d tensor, read on the device)."""
    if V.device.type == "cpu":
        return friction_rows_pt_plain(V, tris, q, t, count, d, dhat, p_mesh, t_mesh,
                                      mu_mat, k, barrier)
    V, (q, t), d, dhat, mu_mat, k = _prep("friction_rows_pt", V, tris, (q, t), count,
                                          d, dhat, (p_mesh, t_mesh), mu_mat, k)
    R = q.shape[0]
    region, bary, T, mu, fn = _outputs(R, 3, V.dtype, V.device)
    rc = build.entry("stk_friction_rows_pt", V.dtype)(
        V.data_ptr(), tris.data_ptr(), q.data_ptr(), t.data_ptr(), R, count.data_ptr(),
        d.data_ptr(), dhat.data_ptr(), p_mesh.data_ptr(), t_mesh.data_ptr(),
        mu_mat.data_ptr(), mu_mat.shape[0], k.data_ptr(), _BARRIER[barrier],
        region.data_ptr(), bary.data_ptr(), T.data_ptr(), mu.data_ptr(), fn.data_ptr(),
        build.stream_ptr(V.device))
    build.check_status("friction_rows_pt", rc)
    build.count_launch("friction_rows[pt]")
    return region, bary, T, mu, fn


def friction_rows_ee(V, edges, a, b, count, d, dhat, e_mesh, mu_mat, k, barrier: str,
                     ptol=None):
    """Per EE friction row (edge a against edge b of edges over V): (region,
    st = (s, t), T, mu, fn) as the twin; `ptol` is the region classifier's
    relative parallel cutoff (None: the dtype default)."""
    if V.device.type == "cpu":
        return friction_rows_ee_plain(V, edges, a, b, count, d, dhat, e_mesh, mu_mat,
                                      k, barrier, ptol)
    V, (a, b), d, dhat, mu_mat, k = _prep("friction_rows_ee", V, edges, (a, b), count,
                                          d, dhat, (e_mesh,), mu_mat, k)
    if ptol is None:
        ptol = nph._parallel_tol(V.dtype)
    R = a.shape[0]
    region, st, T, mu, fn = _outputs(R, 2, V.dtype, V.device)
    rc = build.entry("stk_friction_rows_ee", V.dtype)(
        V.data_ptr(), edges.data_ptr(), a.data_ptr(), b.data_ptr(), R, count.data_ptr(),
        d.data_ptr(), dhat.data_ptr(), e_mesh.data_ptr(), mu_mat.data_ptr(),
        mu_mat.shape[0], k.data_ptr(), _BARRIER[barrier], float(ptol),
        region.data_ptr(), st.data_ptr(), T.data_ptr(), mu.data_ptr(), fn.data_ptr(),
        build.stream_ptr(V.device))
    build.check_status("friction_rows_ee", rc)
    build.count_launch("friction_rows[ee]")
    return region, st, T, mu, fn
