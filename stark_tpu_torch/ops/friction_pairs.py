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

The kernel (see its source) tests a pair's exact distance only where a
sound box cull cannot reject it. `host_lists` runs the g++ build of the
same source on the CPU (`build.host_pairs_library`), with the cull or
without it, and counts the pairs that reach the exact distance: the tests
hold it against the twins and against itself without the cull.
"""
from __future__ import annotations

import ctypes
import functools

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


def _check(name, V, table, allowed, meshes, mu_mat, th, nq, nt, host):
    if not host:
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


@functools.lru_cache(maxsize=None)
def _scratch_bytes(host: bool, nq: int, nt: int, kind: str, el: int) -> int:
    lib = build.host_pairs_entry if host else build.entry
    return lib("stk_pair_lists_scratch_bytes")(nq, nt, int(kind == "ee"), el)


def _call(mode, kind, V, table, allowed, meshes, mu_mat, th, cap, ptol, host):
    """The entry point's name, its arguments but the last (the stream, or
    the host build's cull switch and count), the outputs, and the tensors
    the arguments point to (kept alive until the call returns)."""
    name = f"{mode}_pairs_{kind}"
    V, th = V.contiguous(), th.contiguous()
    table, allowed = table.contiguous(), allowed.contiguous()
    meshes = [m.contiguous() for m in meshes]
    if mu_mat is not None:
        mu_mat = mu_mat.contiguous()
    nq = V.shape[0] if kind == "pt" else table.shape[0]
    nt = table.shape[0]
    _check(name, V, table, allowed, meshes, mu_mat, th, nq, nt, host)
    scratch = torch.empty((_scratch_bytes(host, nq, nt, kind, V.element_size()),),
                          dtype=torch.uint8, device=V.device)
    outs = _outputs(cap, V.dtype, V.device)
    args = [V.data_ptr(), table.data_ptr()]
    args += [nq, nt] if kind == "pt" else [nt]
    args += [allowed.data_ptr(), *(m.data_ptr() for m in meshes)]
    if mu_mat is not None:
        args += [mu_mat.data_ptr()]
    args += [th.data_ptr()]
    if mu_mat is not None:
        args += [mu_mat.shape[0]]
    if kind == "ee":
        args += [float(nph._parallel_tol(V.dtype) if ptol is None else ptol)]
    args += [cap, *(x.data_ptr() for x in outs), scratch.data_ptr()]
    return name, args, outs, (V, table, allowed, meshes, mu_mat, th, scratch)


def launch(mode: str, kind: str, V, table, allowed, meshes, mu_mat, th, cap: int,
           ptol=None):
    """One launch of kernel I on the card (mode "friction" or "contact", kind
    "pt" or "ee"; mu_mat None in the contact mode): (q, t, d, dhat, count)."""
    name, args, outs, _keep = _call(mode, kind, V, table, allowed, meshes, mu_mat, th,
                                    cap, ptol, False)
    rc = build.entry("stk_" + name, V.dtype)(*args, build.stream_ptr(V.device))
    build.check_status(name, rc)
    build.count_launch(f"{mode}_pairs[{kind}]")
    return outs


def host_lists(mode: str, kind: str, V, table, allowed, meshes, mu_mat, th, cap: int,
               ptol=None, cull: bool = True):
    """The g++ build of kernel I on CPU tensors (launch's arguments):
    (q, t, d, dhat, count) and the number of allowed pairs with a nonzero mu
    that took the exact test (all of them with cull=False)."""
    if any(x.device.type != "cpu" for x in (V, table, allowed, th)):
        raise ValueError(f"{mode}_pairs_{kind}: the host build takes CPU tensors")
    name, args, outs, _keep = _call(mode, kind, V, table, allowed, meshes, mu_mat, th,
                                    cap, ptol, True)
    n_exact = ctypes.c_int(0)
    rc = build.host_pairs_entry("stk_" + name, V.dtype)(*args, int(cull),
                                                         ctypes.byref(n_exact))
    build.check_status(name, rc)
    return outs, n_exact.value


def friction_pairs_pt(V, tris, allowed, p_mesh, t_mesh, mu_mat, th, cap: int):
    """(q, t (cap,) int32, d, dhat (cap,), count () int32) of the PT grid:
    points V (Np, 3) against triangles tris (Nt, 3) int32 over V; allowed
    (Np, Nt) uint8; p_mesh (Np,), t_mesh (Nt,) int32 mesh ids; mu_mat (M, M)
    and th (M,) in V's dtype."""
    if V.device.type == "cpu":
        return friction_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh, mu_mat, th, cap)
    return launch("friction", "pt", V, tris, allowed, (p_mesh, t_mesh), mu_mat, th, cap)


def friction_pairs_ee(V, edges, allowed, e_mesh, mu_mat, th, cap: int, ptol=None):
    """(a, b (cap,) int32, d, dhat (cap,), count () int32) of the EE grid:
    edges (Ne, 2) int32 over V against themselves; allowed (Ne, Ne) uint8
    (the dedup lives in it); e_mesh (Ne,) int32; `ptol` the classifier's
    relative parallel cutoff (None: the dtype default)."""
    if V.device.type == "cpu":
        return friction_pairs_ee_plain(V, edges, allowed, e_mesh, mu_mat, th, cap, ptol)
    return launch("friction", "ee", V, edges, allowed, (e_mesh,), mu_mat, th, cap, ptol)


def contact_pairs_pt(V, tris, allowed, p_mesh, t_mesh, th, cap: int):
    """Kernel I's contact mode over the PT grid: (q, t (cap,) int32, d,
    dhat (cap,), count () int32) of every allowed pair with d <= dhat, in
    row-major order; the arguments are friction_pairs_pt's without mu."""
    if V.device.type == "cpu":
        return contact_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh, th, cap)
    return launch("contact", "pt", V, tris, allowed, (p_mesh, t_mesh), None, th, cap)


def contact_pairs_ee(V, edges, allowed, e_mesh, th, cap: int, ptol=None):
    """Kernel I's contact mode over the EE grid (friction_pairs_ee's
    arguments without mu)."""
    if V.device.type == "cpu":
        return contact_pairs_ee_plain(V, edges, allowed, e_mesh, th, cap, ptol)
    return launch("contact", "ee", V, edges, allowed, (e_mesh,), None, th, cap, ptol)
