"""Kernel H: any-hit segment-triangle test over a frozen candidate list
(csrc/segment_triangle.cu), and its twin.

Replaces stark_tpu/models/interactions/contact_engine.py `_isect_exact`
(:1782-1800): any(act & segment_triangle_intersects(edge e, tri t)) over the
list's rows, ORed with its overflow flag. The verdict is a 0-d bool tensor
on the device; the caller decides when to read it.
"""
from __future__ import annotations

import torch

from ..collision import narrow_phase as nph
from . import build


def segment_triangle_any_plain(V, edges, tris, e, t, act, overflow):
    ee = edges[e.long()].long()
    tt = tris[t.long()].long()
    hit = nph.segment_triangle_intersects(V[ee[:, 0]], V[ee[:, 1]], V[tt[:, 0]],
                                          V[tt[:, 1]], V[tt[:, 2]])
    return torch.any(hit & act.to(torch.bool)) | overflow.to(torch.bool).reshape(())


def segment_triangle_any(V, edges, tris, e, t, act, overflow):
    """0-d bool: does any active row's segment cross its triangle (or did
    the candidate list overflow)? edges (Ne, 2), tris (Nt, 3), e, t (R,) all
    int32; act (R,) bool; overflow 0-d bool."""
    if V.device.type == "cpu":
        return segment_triangle_any_plain(V, edges, tris, e, t, act, overflow)
    V = V.contiguous()
    act8 = act.to(torch.uint8).contiguous()
    ovf = overflow.reshape(()).to(torch.uint8).contiguous()
    build.require_cuda("segment_triangle_any", V, edges, tris, e, t, act8, ovf)
    if any(x.dtype != torch.int32 for x in (edges, tris, e, t)):
        raise TypeError("segment_triangle_any: index tensors must be int32")
    out = torch.empty((), dtype=torch.uint8, device=V.device)
    rc = build.entry("stk_segment_triangle_any", V.dtype)(
        V.data_ptr(), edges.data_ptr(), tris.data_ptr(), e.data_ptr(),
        t.data_ptr(), e.shape[0], act8.data_ptr(),
        float(nph._parallel_tol(V.dtype)), ovf.data_ptr(), out.data_ptr(),
        build.stream_ptr(V.device))
    build.check_status("segment_triangle_any", rc)
    build.count_launch("segment_triangle_any")
    return out.to(torch.bool)
