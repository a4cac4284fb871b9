"""Kernel L: per-query row-K candidate selection (csrc/rowk_select.cu), and
its twin.

Replaces the query half of stark_tpu/collision/broad_phase.py
`grid_candidates` (:99-119), the sphere prefilter and exclusions of the
contact engine's stage 1 (contact_engine.py `_grid_stage1` :613-634 and the
dense branches of `_pt_stage1` :769-781, `_ee_stage1` :871-885 and
`_isect_stage1` :1746-1751) and `_rowk_topk` (:586-611). For every query row
q it walks its candidates in ascending target id,
  * grid mode: the first min(occ, occ_cap) ids of its own bucket's run
    (kernel K's offsets and sorted ids), a repeat of its predecessor
    dropped;
  * dense mode: the targets 0 .. nt-1;
keeps those that pass the sphere test |qc - tc|^2 <= rhs^2 and the stem's
exclusion predicate, and returns the first K kept ids, padded with nt:
exactly `_rowk_topk`'s K smallest ids in its ascending order. It also
returns the largest kept count of a row (the c_/cf_/i_ capacity check)
and, in grid mode, the largest bucket run a query reads (g_<stem>_occ).
The (Nq, M) mask of the twin is never written.

`Sphere.form` picks JAX's order of sums for rhs, which decides a pair that
sits on the boundary:
  "grid": qa[q] + ta[t]                      (the callers' pre-summed radii)
  "pt":   ((ta[t] + sl) + qa[q]) + tb[t]     (r + sl + th_p + th_t)
  "ee":   (((qa[q] + ta[t]) + sl) + qb[q]) + tb[t]   (ha + hb + sl + th_a + th_b)
  "et":   (qa[q] + sl) + ta[t]               (h + sl + r)
`Pred.code` is the stem's exclusion rule on top of the (M, M) allowed table
(mesh pairs with collisions enabled, and mu != 0 on the friction call):
  "none"; "pt_dd" (same-mesh incident pairs out); "pt_rr" (same mesh out);
  "ee_dd" (tmcd dedup, same-mesh vertex sharing out); "ee_rr" (dedup, same
  mesh out); "et" (vertex sharing out); "et_rr" (and same mesh out).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..collision.broad_phase import grid_query_plain
from . import build

FORMS = {"grid": 0, "pt": 1, "ee": 2, "et": 3}
PREDS = {"none": 0, "pt_dd": 1, "pt_rr": 2, "ee_dd": 3, "ee_rr": 4, "et": 5,
         "et_rr": 6}


class Sphere(NamedTuple):
    form: str
    qa: torch.Tensor
    ta: torch.Tensor
    qb: Optional[torch.Tensor] = None
    tb: Optional[torch.Tensor] = None
    sl: Optional[torch.Tensor] = None     # 0-d, the slack (dense forms)


class Pred(NamedTuple):
    code: str
    qm: torch.Tensor          # (Nq,) int32 mesh ids of the queries
    tm: torch.Tensor          # (nt,) int32 mesh ids of the targets
    allowed: torch.Tensor     # (M * M,) uint8 allowed mesh pairs, row-major
    qidx: Optional[torch.Tensor] = None   # (Nq, 2) int32 query edge vertices
    tidx: Optional[torch.Tensor] = None   # (nt, 2 or 3) int32 target vertices


class GridIndex(NamedTuple):
    offsets: torch.Tensor     # (table_size + 1,) int32, kernel K's
    tid_sorted: torch.Tensor  # (T * ins,) int32, kernel K's
    h: torch.Tensor           # 0-d cell size
    occ_cap: int


# ---------------------------------------------------------------------------
# the twin: JAX's formulation
# ---------------------------------------------------------------------------
def rowk_topk_plain(mask, tids, K: int, nt: int):
    """`_rowk_topk`: the K smallest target ids among the mask's true entries
    of each row (ids ride in the f32 key nt - tid, as in JAX), padded with
    nt; and the largest true count of a row."""
    Nq, M = mask.shape
    dev = mask.device
    if M == 0:
        return (torch.full((Nq, K), nt, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    keyv = torch.where(mask, float(nt) - tids.to(torch.float32),
                       torch.zeros((), dtype=torch.float32, device=dev))
    Ke = max(1, min(K, M))
    v, _ = torch.topk(keyv, Ke, dim=1)
    tid = (float(nt) - v).to(torch.int32)
    if Ke < K:
        tid = torch.cat([tid, torch.full((Nq, K - Ke), nt, dtype=torch.int32,
                                         device=dev)], dim=1)
    if Nq == 0:
        return tid, torch.zeros((), dtype=torch.int32, device=dev)
    return tid, mask.to(torch.int32).sum(dim=1).max().to(torch.int32)


def _rhs(sp: Sphere, qi, ti):
    qa, ta = sp.qa[qi], sp.ta[ti]
    if sp.form == "grid":
        return qa + ta
    if sp.form == "pt":
        return ((ta + sp.sl) + qa) + sp.tb[ti]
    if sp.form == "ee":
        return (((qa + ta) + sp.sl) + sp.qb[qi]) + sp.tb[ti]
    if sp.form == "et":
        return (qa + sp.sl) + ta
    raise ValueError(f"unknown sphere form {sp.form}")


def pred_plain(pr: Pred, qi, ti):
    """The stem's exclusion predicate on broadcast (query, target) index
    tensors: True where the pair may be a candidate."""
    M = int(round(pr.allowed.numel() ** 0.5))
    qm, tm = pr.qm.long()[qi], pr.tm.long()[ti]
    ok = pr.allowed.to(torch.bool)[qm * M + tm]
    c = pr.code
    if c == "pt_dd":
        tri = pr.tidx.long()
        inc = (qi == tri[ti, 0]) | (qi == tri[ti, 1]) | (qi == tri[ti, 2])
        ok = ok & ~((qm == tm) & inc)
    elif c == "pt_rr":
        ok = ok & (qm != tm)
    elif c == "ee_dd":
        ea, eb = pr.qidx.long(), pr.tidx.long()
        approve = (tm > qm) | ((tm == qm) & (ti > qi))
        share = torch.zeros_like(approve)
        for i in range(2):
            for j in range(2):
                share = share | (ea[qi, i] == eb[ti, j])
        ok = ok & approve & ~share
    elif c == "ee_rr":
        ok = ok & (tm > qm)
    elif c in ("et", "et_rr"):
        e, t = pr.qidx.long(), pr.tidx.long()
        share = torch.zeros_like(ok)
        for i in range(2):
            for k in range(3):
                share = share | (e[qi, i] == t[ti, k])
        ok = ok & ~share
        if c == "et_rr":
            ok = ok & (qm != tm)
    elif c != "none":
        raise ValueError(f"unknown predicate {c}")
    return ok


def rowk_select_plain(qc, tc, sphere: Sphere, pred: Pred, K: int,
                      grid: Optional[GridIndex] = None):
    """Plain PyTorch twin: the (Nq, M) candidate mask (grid: JAX's
    grid_candidates query half; dense: every target), then
    `rowk_topk_plain`. Returns (tid (Nq, K) int32, max_row () int32,
    max_occ () int32 in grid mode, else None)."""
    Nq, nt = qc.shape[0], tc.shape[0]
    dev = qc.device
    qi = torch.arange(Nq, device=dev)[:, None]
    if grid is not None:
        tid_grid, valid, max_occ = grid_query_plain(
            grid.offsets, grid.tid_sorted, qc, grid.h, grid.occ_cap,
            grid.offsets.shape[0] - 1, nt)
        ti = torch.clamp(tid_grid.long(), 0, max(nt - 1, 0))
    else:
        ti = torch.arange(nt, device=dev)[None, :].expand(Nq, nt)
        valid, max_occ = torch.ones_like(ti, dtype=torch.bool), None
    d = qc[:, None, :] - tc[ti]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    rhs = _rhs(sphere, qi, ti)
    mask = valid & (d2 <= rhs * rhs) & pred_plain(pred, qi, ti)
    tid, max_row = rowk_topk_plain(mask, ti, K, nt)
    return tid, max_row, max_occ


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------
def _ptr(x):
    return None if x is None else x.data_ptr()


def rowk_select(qc, tc, sphere: Sphere, pred: Pred, K: int,
                grid: Optional[GridIndex] = None):
    """(tid (Nq, K) int32, max_row () int32, max_occ () int32 or None); see
    the module note. qc (Nq, 3), tc (nt, 3); K >= 1."""
    if qc.device.type == "cpu":
        return rowk_select_plain(qc, tc, sphere, pred, K, grid)
    dt = qc.dtype
    qc, tc = qc.contiguous(), tc.contiguous()
    f = [None if x is None else x.to(dt).reshape(-1).contiguous()
         for x in (sphere.qa, sphere.qb, sphere.ta, sphere.tb)]
    sl = (torch.zeros((), dtype=dt, device=qc.device) if sphere.sl is None
          else sphere.sl.reshape(()).to(dt).contiguous())
    ints = [None if x is None else x.contiguous()
            for x in (pred.qm, pred.tm, pred.qidx, pred.tidx)]
    allowed = pred.allowed.contiguous()
    ts = [x for x in [qc, tc, sl, allowed] + f + ints if x is not None]
    if grid is not None:
        h = grid.h.reshape(()).to(dt).contiguous()
        ts += [grid.offsets, grid.tid_sorted, h]
    build.require_cuda("rowk_select", *ts)
    if any(x is not None and x.dtype != torch.int32 for x in ints) \
            or allowed.dtype != torch.uint8:
        raise TypeError("rowk_select: index tables int32, allowed uint8")
    Nq, nt = qc.shape[0], tc.shape[0]
    M = int(round(allowed.numel() ** 0.5))
    if M * M != allowed.numel() or Nq * K >= 2**31:
        raise ValueError("rowk_select: bad allowed table or output size")
    dev = qc.device
    tid = torch.empty((Nq, K), dtype=torch.int32, device=dev)
    maxes = torch.empty((2,), dtype=torch.int32, device=dev)   # max_row, max_occ
    qidx, tidx = ints[2], ints[3]
    rc = build.entry("stk_rowk_select", dt)(
        FORMS[sphere.form], PREDS[pred.code], qc.data_ptr(), Nq, _ptr(f[0]),
        _ptr(f[1]), tc.data_ptr(), nt, _ptr(f[2]), _ptr(f[3]), sl.data_ptr(),
        ints[0].data_ptr(), ints[1].data_ptr(), M, allowed.data_ptr(),
        _ptr(qidx), 0 if qidx is None else qidx.shape[1],
        _ptr(tidx), 0 if tidx is None else tidx.shape[1],
        None if grid is None else grid.offsets.data_ptr(),
        None if grid is None else grid.tid_sorted.data_ptr(),
        0 if grid is None else grid.occ_cap,
        0 if grid is None else grid.offsets.shape[0] - 1,
        None if grid is None else h.data_ptr(),
        K, tid.data_ptr(), maxes.data_ptr(), build.stream_ptr(dev))
    build.check_status("rowk_select", rc)
    build.count_launch("rowk_select")
    return tid, maxes[0], (maxes[1] if grid is not None else None)
