"""Kernel K: the build half of the spatial-hash broad phase
(csrc/grid_build.cu), and its twin.

Replaces the insertion half of stark_tpu/collision/broad_phase.py
`grid_candidates` (:70-97): each target's covered-cell box, its first
`ins_slots` cells hashed into buckets, the argsort of the int64 key
bucket*(T+1) + tid, and the searchsorted bucket bounds. Output, for
T targets and a table of `table_size` buckets:
  offsets    (table_size + 1,) int32: bucket b's run is
             tid_sorted[offsets[b]:offsets[b + 1]];
  tid_sorted (T * ins_slots,) int32: the inserted target ids, by bucket and
             then by id (copies of a target kept, adjacent), T past the
             last run;
  max_cells  () int32: the true largest covered-cell count (over ins_slots
             means insertions were dropped: the caller bumps the capacity).
Nothing leaves the device.
"""
from __future__ import annotations

import torch

from ..collision.broad_phase import _cell_of, _hash_cells
from . import build


def grid_build_plain(tc, tr, max_qr, h, ins_slots: int, table_size: int):
    """Plain PyTorch twin: JAX's formulation (slots, int64 keys, argsort)."""
    T = tc.shape[0]
    dev = tc.device
    R = tr + max_qr
    lo = _cell_of(tc - R[:, None], h)
    hi = _cell_of(tc + R[:, None], h)
    ext = hi - lo + 1
    n_cells = ext[:, 0] * ext[:, 1] * ext[:, 2]
    max_cells = n_cells.max().to(torch.int32)
    s = torch.arange(ins_slots, dtype=torch.int32, device=dev)
    sx = s[None, :] % ext[:, 0:1]
    rem = torch.div(s[None, :], ext[:, 0:1], rounding_mode="floor")
    sy = rem % ext[:, 1:2]
    sz = torch.div(rem, ext[:, 1:2], rounding_mode="floor")
    slot_valid = s[None, :] < n_cells[:, None]
    cells = torch.stack([lo[:, 0:1] + sx, lo[:, 1:2] + sy, lo[:, 2:3] + sz], dim=-1)
    bucket = torch.where(slot_valid, _hash_cells(cells, table_size),
                         torch.full_like(sx, table_size)).reshape(-1)
    tid = torch.arange(T, dtype=torch.int64, device=dev)[:, None].expand(
        T, ins_slots).reshape(-1)
    order = torch.argsort(bucket.long() * (T + 1) + tid)
    tid_sorted = tid[order].to(torch.int32)
    counts = torch.bincount(bucket.long(), minlength=table_size + 1)[:table_size]
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    tid_sorted[int(offsets[-1]):] = T
    return offsets, tid_sorted, max_cells


def grid_build(tc, tr, max_qr, h, ins_slots: int, table_size: int):
    """(offsets, tid_sorted, max_cells) of the module note. tc (T, 3), tr
    (T,) target spheres; max_qr and h 0-d tensors (the largest query radius,
    the cell size); table_size a power of two."""
    if tc.device.type == "cpu":
        return grid_build_plain(tc, tr, max_qr, h, ins_slots, table_size)
    tc, tr = tc.contiguous(), tr.contiguous()
    max_qr = max_qr.reshape(()).to(tc.dtype).contiguous()
    h = h.reshape(()).to(tc.dtype).contiguous()
    build.require_cuda("grid_build", tc, tr, max_qr, h)
    if table_size & (table_size - 1) or table_size <= 0:
        raise ValueError("grid_build: table_size must be a power of two")
    T = tc.shape[0]
    if T * ins_slots >= 2**31:
        raise ValueError("grid_build: T * ins_slots exceeds the int32 range")
    dev = tc.device
    i32 = torch.int32
    offsets = torch.empty((table_size + 1,), dtype=i32, device=dev)
    tid_sorted = torch.empty((T * ins_slots,), dtype=i32, device=dev)
    max_cells = torch.empty((), dtype=i32, device=dev)
    # slot buckets, then per-bucket counts and fill cursors
    scratch = torch.empty((T * ins_slots + 2 * table_size,), dtype=i32, device=dev)
    rc = build.entry("stk_grid_build", tc.dtype)(
        tc.data_ptr(), tr.data_ptr(), T, max_qr.data_ptr(), h.data_ptr(),
        ins_slots, table_size, offsets.data_ptr(), tid_sorted.data_ptr(),
        max_cells.data_ptr(), scratch.data_ptr(), build.stream_ptr(dev))
    build.check_status("grid_build", rc)
    build.count_launch("grid_build")
    return offsets, tid_sorted, max_cells
