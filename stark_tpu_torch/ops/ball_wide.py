"""Kernel F: bounding-ball broad phase fused with its compaction
(csrc/ball_wide.cu), and its twin.

Replaces stark_tpu/models/interactions/contact_engine.py `_ball_wide`
(:1102-1111): the flat list of ball pairs (i, j) with allowed[i, j] and
|a_i|^2 + |b_j|^2 - 2 a_i.b_j <= (ra_i + rb_j + extra)^2, in row-major
order, capacity cap, with the exact total count. The kernel never writes the
(Na, Nb) mask the twin builds.
"""
from __future__ import annotations

import torch

from . import build
from .compact import compact_plain


def _squares(A):
    return A[:, 0] * A[:, 0] + A[:, 1] * A[:, 1] + A[:, 2] * A[:, 2]


def ball_mask_plain(A, ra, B, rb, allowed, extra):
    """The (Na, Nb) validity mask, in the kernel's operation order."""
    a2, b2 = _squares(A), _squares(B)
    ab = (A[:, None, 0] * B[None, :, 0] + A[:, None, 1] * B[None, :, 1]) \
        + A[:, None, 2] * B[None, :, 2]
    m2 = (a2[:, None] + b2[None, :]) - 2.0 * ab
    rhs = (ra[:, None] + rb[None, :]) + extra
    return allowed.to(torch.bool) & (m2 <= rhs * rhs)


def ball_wide_plain(A, ra, B, rb, allowed, extra, cap: int):
    """Plain PyTorch twin: the dense mask, then torch.nonzero."""
    Nb = B.shape[0]
    sel, cnt = compact_plain(ball_mask_plain(A, ra, B, rb, allowed, extra), cap)
    return (sel // Nb).to(torch.int32), (sel % Nb).to(torch.int32), cnt


def ball_wide(A, ra, B, rb, allowed, extra, cap: int):
    """(q (cap,) int32, t (cap,) int32, count () int32). A (Na, 3), ra (Na,),
    B (Nb, 3), rb (Nb,), allowed (Na, Nb) uint8, extra a 0-d tensor."""
    if A.device.type == "cpu":
        return ball_wide_plain(A, ra, B, rb, allowed, extra, cap)
    A, ra, B, rb = (x.contiguous() for x in (A, ra, B, rb))
    extra = extra.reshape(()).to(A.dtype).contiguous()
    a2, b2 = _squares(A).contiguous(), _squares(B).contiguous()
    build.require_cuda("ball_wide", A, ra, B, rb, allowed, extra, a2, b2)
    Na, Nb = A.shape[0], B.shape[0]
    if allowed.dtype != torch.uint8 or allowed.shape != (Na, Nb):
        raise TypeError("ball_wide: allowed must be a (Na, Nb) uint8 tensor")
    if Na * Nb >= 2**31:
        raise ValueError("ball_wide: the pair grid exceeds the int32 range")
    dev = A.device
    q = torch.empty((cap,), dtype=torch.int32, device=dev)
    t = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((2 * max(Na, 1),), dtype=torch.int32, device=dev)
    rc = build.entry("stk_ball_wide", A.dtype)(
        A.data_ptr(), a2.data_ptr(), ra.data_ptr(), B.data_ptr(), b2.data_ptr(),
        rb.data_ptr(), Na, Nb, allowed.data_ptr(), extra.data_ptr(), cap,
        q.data_ptr(), t.data_ptr(), count.data_ptr(), scratch.data_ptr(),
        build.stream_ptr(dev))
    build.check_status("ball_wide", rc)
    build.count_launch("ball_wide")
    return q, t, count
