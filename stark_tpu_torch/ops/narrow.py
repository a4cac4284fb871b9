"""Kernel G: exact PT / EE distances over flat candidate rows
(csrc/pt_ee_distance.cu), and their twins.

Replaces the vmapped `point_triangle_distance` (stark_tpu/collision/
narrow_phase.py:162) and `edge_edge_distance` (:328) over the contact
engine's flat candidate lists. Each entry returns the distance per row and,
when a per-row `bound` is given, keep = act & (d - off <= bound), the mask
kernel E then compacts. Rows with act = 0 are padding: their distance is
0 (the kernel does not compute it).
"""
from __future__ import annotations

import torch

from ..collision import narrow_phase as nph
from . import build


def _padded(d, act):
    return d if act is None else torch.where(act.to(torch.bool), d,
                                             torch.zeros_like(d))


def _keep(d, act, off, bound):
    if bound is None:
        return None
    lhs = d if off is None else d - off
    k = lhs <= bound
    return k if act is None else k & act.to(torch.bool)


def pt_distance_plain(P, V, tris, q, t, act=None, off=None, bound=None):
    tq = tris[t.long()].long()
    d = _padded(nph.point_triangle_distance(P[q.long()], V[tq[:, 0]], V[tq[:, 1]],
                                            V[tq[:, 2]]), act)
    return d, _keep(d, act, off, bound)


def ee_distance_plain(V, edges, a, b, ptol=None, act=None, bound=None):
    ea, eb = edges[a.long()].long(), edges[b.long()].long()
    d = _padded(nph.edge_edge_distance(V[ea[:, 0]], V[ea[:, 1]], V[eb[:, 0]],
                                       V[eb[:, 1]], parallel_tol=ptol), act)
    return d, _keep(d, act, None, bound)


def ee_near_cutoff(V, edges, a, b, ptol=None, factor=16.0):
    """(R,) bool: the rows whose relative cross-norm^2 lies within `factor`
    of the parallel cutoff on either side. There the classifier's branch and
    the line-line formula's cancellation make the distance ill-conditioned,
    so a check holds them to a looser bound than the other rows."""
    ea, eb = edges[a.long()].long(), edges[b.long()].long()
    u = V[ea[:, 1]] - V[ea[:, 0]]
    v = V[eb[:, 1]] - V[eb[:, 0]]
    cuv = torch.linalg.cross(u, v, dim=-1)
    cross_sq = (cuv * cuv).sum(-1)
    lim = (nph._parallel_tol(V.dtype) if ptol is None else ptol) \
        * (u * u).sum(-1) * (v * v).sum(-1)
    return (cross_sq >= lim / factor) & (cross_sq < lim * factor)


def _u8(x):
    return None if x is None else x.to(torch.uint8).contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def pt_distance(P, V, tris, q, t, act=None, off=None, bound=None):
    """d (R,) = dist(P[q], V[tris[t]]); keep (R,) bool or None. tris (Nt, 3)
    int32; q, t (R,) int32; act (R,) bool; off, bound (R,)."""
    if P.device.type == "cpu":
        return pt_distance_plain(P, V, tris, q, t, act, off, bound)
    P, V = P.contiguous(), V.contiguous()
    act8 = _u8(act)
    off = None if off is None else off.to(P.dtype).contiguous()
    bound = None if bound is None else bound.to(P.dtype).contiguous()
    ts = [x for x in (P, V, tris, q, t, act8, off, bound) if x is not None]
    build.require_cuda("pt_distance", *ts)
    if tris.dtype != torch.int32 or q.dtype != torch.int32 or t.dtype != torch.int32:
        raise TypeError("pt_distance: index tensors must be int32")
    R = q.shape[0]
    d = torch.empty((R,), dtype=P.dtype, device=P.device)
    keep = None if bound is None else torch.empty((R,), dtype=torch.uint8,
                                                  device=P.device)
    rc = build.entry("stk_pt_distance", P.dtype)(
        P.data_ptr(), V.data_ptr(), tris.data_ptr(), q.data_ptr(), t.data_ptr(),
        R, _ptr(act8), _ptr(off), _ptr(bound), d.data_ptr(), _ptr(keep),
        build.stream_ptr(P.device))
    build.check_status("pt_distance", rc)
    build.count_launch("pt_ee_distance[pt]")
    return d, (None if keep is None else keep.to(torch.bool))


def ee_distance(V, edges, a, b, ptol=None, act=None, bound=None):
    """d (R,) = dist(edge a, edge b) of V[edges]; keep as pt_distance.
    `ptol` is the classifier's relative parallel cutoff (None: the dtype
    default)."""
    if V.device.type == "cpu":
        return ee_distance_plain(V, edges, a, b, ptol, act, bound)
    V = V.contiguous()
    act8 = _u8(act)
    bound = None if bound is None else bound.to(V.dtype).contiguous()
    ts = [x for x in (V, edges, a, b, act8, bound) if x is not None]
    build.require_cuda("ee_distance", *ts)
    if edges.dtype != torch.int32 or a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("ee_distance: index tensors must be int32")
    if ptol is None:
        ptol = nph._parallel_tol(V.dtype)
    R = a.shape[0]
    d = torch.empty((R,), dtype=V.dtype, device=V.device)
    keep = None if bound is None else torch.empty((R,), dtype=torch.uint8,
                                                  device=V.device)
    rc = build.entry("stk_ee_distance", V.dtype)(
        V.data_ptr(), edges.data_ptr(), a.data_ptr(), b.data_ptr(), R,
        float(ptol), _ptr(act8), _ptr(bound), d.data_ptr(), _ptr(keep),
        build.stream_ptr(V.device))
    build.check_status("ee_distance", rc)
    build.count_launch("pt_ee_distance[ee]")
    return d, (None if keep is None else keep.to(torch.bool))
