"""Kernel F: bounding-ball broad phase fused with its compaction
(csrc/ball_wide.cu), and its twin.

Replaces stark_tpu/models/interactions/contact_engine.py `_ball_wide`
(:1102-1111): the flat list of ball pairs (i, j) with allowed[i, j] and
|a_i|^2 + |b_j|^2 - 2 a_i.b_j <= (ra_i + rb_j + extra)^2, in row-major
order, capacity cap, with the exact total count. The kernel never writes the
(Na, Nb) mask the twin builds: it marks each 32-row x 512-column tile once
into bit words and emits the lists from the words (csrc/ball_wide.cu).
"""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _scratch_ints(host: bool, na: int, nb: int) -> int:
    lib = build.host_broad_entry if host else build.entry
    return lib("stk_ball_wide_scratch_ints")(na, nb)


def _call(A, ra, B, rb, allowed, extra, cap: int, host: bool):
    """The outputs, the entry point's arguments but the stream, and the
    tensors they point to (kept alive until the call returns)."""
    A, ra, B, rb = (x.contiguous() for x in (A, ra, B, rb))
    extra = extra.reshape(()).to(A.dtype).contiguous()
    allowed = allowed.contiguous()
    if not host:
        build.require_cuda("ball_wide", A, ra, B, rb, allowed, extra)
    Na, Nb = A.shape[0], B.shape[0]
    if allowed.dtype != torch.uint8 or allowed.shape != (Na, Nb):
        raise TypeError("ball_wide: allowed must be a (Na, Nb) uint8 tensor")
    if Na * Nb >= 2**31:
        raise ValueError("ball_wide: the pair grid exceeds the int32 range")
    dev = A.device
    q = torch.empty((cap,), dtype=torch.int32, device=dev)
    t = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((_scratch_ints(host, Na, Nb),), dtype=torch.int32, device=dev)
    args = [A.data_ptr(), ra.data_ptr(), B.data_ptr(), rb.data_ptr(), Na, Nb,
            allowed.data_ptr(), extra.data_ptr(), cap, q.data_ptr(), t.data_ptr(),
            count.data_ptr(), scratch.data_ptr()]
    return (q, t, count), args, (A, ra, B, rb, allowed, extra, scratch)


def ball_wide(A, ra, B, rb, allowed, extra, cap: int):
    """(q (cap,) int32, t (cap,) int32, count () int32). A (Na, 3), ra (Na,),
    B (Nb, 3), rb (Nb,), allowed (Na, Nb) uint8, extra a 0-d tensor."""
    if A.device.type == "cpu":
        return ball_wide_plain(A, ra, B, rb, allowed, extra, cap)
    outs, args, _keep = _call(A, ra, B, rb, allowed, extra, cap, False)
    rc = build.entry("stk_ball_wide", A.dtype)(*args, build.stream_ptr(A.device))
    build.check_status("ball_wide", rc)
    build.count_launch("ball_wide")
    return outs


def host_ball_wide(A, ra, B, rb, allowed, extra, cap: int):
    """The g++ build of kernel F on CPU tensors (ball_wide's arguments and
    outputs): its tiles, mask words and emit, each round's lanes in turn."""
    if any(x.device.type != "cpu" for x in (A, ra, B, rb, allowed, extra)):
        raise ValueError("ball_wide: the host build takes CPU tensors")
    outs, args, _keep = _call(A, ra, B, rb, allowed, extra, cap, True)
    build.check_status("ball_wide", build.host_broad_entry("stk_ball_wide", A.dtype)(*args))
    return outs
