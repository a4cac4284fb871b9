"""Kernel I: the lagged-friction pair lists over the dense candidate grids
(csrc/friction_pairs.cu), its contact mode, and their twins.

Replaces the dense branch of stark_tpu/models/interactions/contact_engine.py
`friction_tables` (:1549-1577, with `_pt_dense_d` :1019 and `_ee_dense_d`
:1031): the exact distance of every allowed primitive pair whose meshes have
a nonzero Coulomb mu, kept where d <= dhat = th[mesh_q] + th[mesh_t], listed
in row-major (q, t) order with capacity cap, and the exact total count (it
may exceed cap). JAX evaluates the full (N, M) distance matrix, lifts mu to
it with one-hot matmuls and compacts the mask; the kernel writes no matrix.

The contact mode (`contact_pairs_pt`/`_ee`, launch names contact_pairs[pt]
and [ee]) is the same pass without the mu predicate: the dense branch of
`_contacts_fn` (:1192-1222), every allowed pair with d <= dhat, listed in
row-major order for the staged solver's per-evaluation contact refresh.

Rows past the count hold zeros. The count stays on the device.
"""
from __future__ import annotations

import torch

from ..collision import narrow_phase as nph
from . import build
from .compact import compact_plain

_CHUNK = 1 << 20    # candidate rows per distance evaluation of the twins


def _mu_ok(mu_mat, mesh_q, mesh_t):
    return mu_mat[mesh_q.long()][:, mesh_t.long()] != 0.0


def _emit_plain(qi, ti, dist_fn, dhat_fn, cap):
    """The kept candidates of the allowed (qi, ti) rows, in their order, as
    zero-padded (cap,) lists and the total count."""
    ds, dhs = [], []
    for s in range(0, qi.shape[0], _CHUNK):
        q, t = qi[s:s + _CHUNK], ti[s:s + _CHUNK]
        ds.append(dist_fn(q, t))
        dhs.append(dhat_fn(q, t))
    d = torch.cat(ds) if ds else qi.new_zeros((0,), dtype=torch.float64)
    dhat = torch.cat(dhs) if dhs else d
    sel, cnt = compact_plain(d <= dhat, cap)
    sl = sel.long()
    act = torch.arange(cap, device=qi.device) < torch.clamp_max(cnt, cap)

    def pick(x):
        x = x[sl] if x.numel() else torch.zeros((cap,), dtype=x.dtype, device=x.device)
        return torch.where(act, x, torch.zeros_like(x))

    return (pick(qi).to(torch.int32), pick(ti).to(torch.int32), pick(d),
            pick(dhat), cnt)


def _pt_pairs_plain(V, tris, ok, p_mesh, t_mesh, th, cap: int):
    """The ok entries of the (Np, Nt) grid in row-major order (nonzero),
    their exact distances (in chunks), the d <= dhat filter and its
    compaction."""
    Nt = tris.shape[0]
    idx = torch.nonzero(ok.reshape(-1)).reshape(-1)
    qi, ti = idx // Nt, idx % Nt
    tq = tris.long()

    def dist(q, t):
        tv = tq[t]
        return nph.point_triangle_distance(V[q], V[tv[:, 0]], V[tv[:, 1]], V[tv[:, 2]])

    def dhat(q, t):
        return th[p_mesh[q].long()] + th[t_mesh[t].long()]

    q, t, d, dh, cnt = _emit_plain(qi, ti, dist, dhat, cap)
    return q, t, d.to(V.dtype), dh.to(V.dtype), cnt


def _ee_pairs_plain(V, edges, ok, e_mesh, th, cap: int, ptol):
    """The ok entries of the (Ne, Ne) grid, as _pt_pairs_plain."""
    Ne = edges.shape[0]
    idx = torch.nonzero(ok.reshape(-1)).reshape(-1)
    ai, bi = idx // Ne, idx % Ne
    eq = edges.long()

    def dist(a, b):
        ea, eb = eq[a], eq[b]
        return nph.edge_edge_distance(V[ea[:, 0]], V[ea[:, 1]], V[eb[:, 0]],
                                      V[eb[:, 1]], parallel_tol=ptol)

    def dhat(a, b):
        return th[e_mesh[a].long()] + th[e_mesh[b].long()]

    a, b, d, dh, cnt = _emit_plain(ai, bi, dist, dhat, cap)
    return a, b, d.to(V.dtype), dh.to(V.dtype), cnt


def friction_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh, mu_mat, th, cap: int):
    """Plain PyTorch twin: the allowed & mu != 0 entries of the (Np, Nt)
    grid with d <= dhat, in row-major order."""
    ok = allowed.to(torch.bool) & _mu_ok(mu_mat, p_mesh, t_mesh)
    return _pt_pairs_plain(V, tris, ok, p_mesh, t_mesh, th, cap)


def friction_pairs_ee_plain(V, edges, allowed, e_mesh, mu_mat, th, cap: int, ptol=None):
    """Plain PyTorch twin of the EE grid, as friction_pairs_pt_plain."""
    ok = allowed.to(torch.bool) & _mu_ok(mu_mat, e_mesh, e_mesh)
    return _ee_pairs_plain(V, edges, ok, e_mesh, th, cap, ptol)


def contact_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh, th, cap: int):
    """Plain PyTorch twin of the contact mode: the allowed entries of the
    (Np, Nt) grid with d <= dhat, in row-major order."""
    return _pt_pairs_plain(V, tris, allowed.to(torch.bool), p_mesh, t_mesh, th, cap)


def contact_pairs_ee_plain(V, edges, allowed, e_mesh, th, cap: int, ptol=None):
    """Plain PyTorch twin of the contact mode over the EE grid."""
    return _ee_pairs_plain(V, edges, allowed.to(torch.bool), e_mesh, th, cap, ptol)


def _outputs(cap, dtype, dev):
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.empty((cap,), **i32), torch.empty((cap,), **i32),
            torch.empty((cap,), dtype=dtype, device=dev),
            torch.empty((cap,), dtype=dtype, device=dev),
            torch.empty((), **i32))


def _check(name, V, table, allowed, meshes, mu_mat, th, nq, nt):
    build.require_cuda(name, V, table, allowed, *meshes, th,
                       *(() if mu_mat is None else (mu_mat,)))
    if table.dtype != torch.int32 or any(m.dtype != torch.int32 for m in meshes):
        raise TypeError(f"{name}: the primitive table and mesh ids must be int32")
    if allowed.dtype != torch.uint8 or allowed.shape != (nq, nt):
        raise TypeError(f"{name}: allowed must be a ({nq}, {nt}) uint8 tensor")
    if th.dtype != V.dtype or (mu_mat is not None and mu_mat.dtype != V.dtype):
        raise TypeError(f"{name}: mu_mat and th must have the vertices' dtype")
    if nq * nt >= 2**31:
        raise ValueError(f"{name}: the pair grid exceeds the int32 range")


def friction_pairs_pt(V, tris, allowed, p_mesh, t_mesh, mu_mat, th, cap: int):
    """(q, t (cap,) int32, d, dhat (cap,), count () int32) of the PT grid:
    points V (Np, 3) against triangles tris (Nt, 3) int32 over V; allowed
    (Np, Nt) uint8; p_mesh (Np,), t_mesh (Nt,) int32 mesh ids; mu_mat (M, M)
    and th (M,) in V's dtype."""
    if V.device.type == "cpu":
        return friction_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh, mu_mat, th, cap)
    V, mu_mat, th = V.contiguous(), mu_mat.contiguous(), th.contiguous()
    Np, Nt = V.shape[0], tris.shape[0]
    _check("friction_pairs_pt", V, tris, allowed, (p_mesh, t_mesh), mu_mat, th, Np, Nt)
    q, t, d, dhat, count = _outputs(cap, V.dtype, V.device)
    scratch = torch.empty((2 * max(Np, 1),), dtype=torch.int32, device=V.device)
    rc = build.entry("stk_friction_pairs_pt", V.dtype)(
        V.data_ptr(), tris.data_ptr(), Np, Nt, allowed.data_ptr(), p_mesh.data_ptr(),
        t_mesh.data_ptr(), mu_mat.data_ptr(), th.data_ptr(), mu_mat.shape[0], cap,
        q.data_ptr(), t.data_ptr(), d.data_ptr(), dhat.data_ptr(), count.data_ptr(),
        scratch.data_ptr(), build.stream_ptr(V.device))
    build.check_status("friction_pairs_pt", rc)
    build.count_launch("friction_pairs[pt]")
    return q, t, d, dhat, count


def friction_pairs_ee(V, edges, allowed, e_mesh, mu_mat, th, cap: int, ptol=None):
    """(a, b (cap,) int32, d, dhat (cap,), count () int32) of the EE grid:
    edges (Ne, 2) int32 over V against themselves; allowed (Ne, Ne) uint8
    (the dedup lives in it); e_mesh (Ne,) int32; `ptol` the classifier's
    relative parallel cutoff (None: the dtype default)."""
    if V.device.type == "cpu":
        return friction_pairs_ee_plain(V, edges, allowed, e_mesh, mu_mat, th, cap, ptol)
    V, mu_mat, th = V.contiguous(), mu_mat.contiguous(), th.contiguous()
    Ne = edges.shape[0]
    _check("friction_pairs_ee", V, edges, allowed, (e_mesh,), mu_mat, th, Ne, Ne)
    if ptol is None:
        ptol = nph._parallel_tol(V.dtype)
    a, b, d, dhat, count = _outputs(cap, V.dtype, V.device)
    scratch = torch.empty((2 * max(Ne, 1),), dtype=torch.int32, device=V.device)
    rc = build.entry("stk_friction_pairs_ee", V.dtype)(
        V.data_ptr(), edges.data_ptr(), Ne, allowed.data_ptr(), e_mesh.data_ptr(),
        mu_mat.data_ptr(), th.data_ptr(), mu_mat.shape[0], float(ptol), cap,
        a.data_ptr(), b.data_ptr(), d.data_ptr(), dhat.data_ptr(), count.data_ptr(),
        scratch.data_ptr(), build.stream_ptr(V.device))
    build.check_status("friction_pairs_ee", rc)
    build.count_launch("friction_pairs[ee]")
    return a, b, d, dhat, count


def contact_pairs_pt(V, tris, allowed, p_mesh, t_mesh, th, cap: int):
    """Kernel I's contact mode over the PT grid: (q, t (cap,) int32, d,
    dhat (cap,), count () int32) of every allowed pair with d <= dhat, in
    row-major order; the arguments are friction_pairs_pt's without mu."""
    if V.device.type == "cpu":
        return contact_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh, th, cap)
    V, th = V.contiguous(), th.contiguous()
    Np, Nt = V.shape[0], tris.shape[0]
    _check("contact_pairs_pt", V, tris, allowed, (p_mesh, t_mesh), None, th, Np, Nt)
    q, t, d, dhat, count = _outputs(cap, V.dtype, V.device)
    scratch = torch.empty((2 * max(Np, 1),), dtype=torch.int32, device=V.device)
    rc = build.entry("stk_contact_pairs_pt", V.dtype)(
        V.data_ptr(), tris.data_ptr(), Np, Nt, allowed.data_ptr(), p_mesh.data_ptr(),
        t_mesh.data_ptr(), th.data_ptr(), cap, q.data_ptr(), t.data_ptr(), d.data_ptr(),
        dhat.data_ptr(), count.data_ptr(), scratch.data_ptr(), build.stream_ptr(V.device))
    build.check_status("contact_pairs_pt", rc)
    build.count_launch("contact_pairs[pt]")
    return q, t, d, dhat, count


def contact_pairs_ee(V, edges, allowed, e_mesh, th, cap: int, ptol=None):
    """Kernel I's contact mode over the EE grid (friction_pairs_ee's
    arguments without mu)."""
    if V.device.type == "cpu":
        return contact_pairs_ee_plain(V, edges, allowed, e_mesh, th, cap, ptol)
    V, th = V.contiguous(), th.contiguous()
    Ne = edges.shape[0]
    _check("contact_pairs_ee", V, edges, allowed, (e_mesh,), None, th, Ne, Ne)
    if ptol is None:
        ptol = nph._parallel_tol(V.dtype)
    a, b, d, dhat, count = _outputs(cap, V.dtype, V.device)
    scratch = torch.empty((2 * max(Ne, 1),), dtype=torch.int32, device=V.device)
    rc = build.entry("stk_contact_pairs_ee", V.dtype)(
        V.data_ptr(), edges.data_ptr(), Ne, allowed.data_ptr(), e_mesh.data_ptr(),
        th.data_ptr(), float(ptol), cap, a.data_ptr(), b.data_ptr(), d.data_ptr(),
        dhat.data_ptr(), count.data_ptr(), scratch.data_ptr(), build.stream_ptr(V.device))
    build.check_status("contact_pairs_ee", rc)
    build.count_launch("contact_pairs[ee]")
    return a, b, d, dhat, count
