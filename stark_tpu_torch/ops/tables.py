"""Kernel AA: the gather tables (csrc/gather_tables.cu) and their twins.

Replaces stark_tpu/solver/assembly.py `scatter_table` (:214-237),
`scatter_table_rows` (:524-557) and `direct_tables` (:604-624): from a flat
vector of block ids (or the single bucket's block-pair keys), each block's
run in a stable sort of the keys, as an (n_blocks, K) table of payload row
indices (R past a run), a (hot_cap, K2) side table for the hot blocks whose
run exceeds K, or the slot table of the sorted block pairs; int32
throughout, with JAX's overflow signals (max_len, max_deg, hot_n, n_slots)
left on the device. The sort stays a library call, `torch.sort(stable=True)`
(JAX's `jnp.argsort` is XLA's stable sort, so `order` is the same
permutation); the runs, tables and slot keys are the kernel's, and the hot
ids and slot heads are compacted by kernel E (`ops.compact`). The twins
repeat JAX's searchsorted-and-gather form on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .compact import compact


class DirectTables(NamedTuple):
    """direct_tables' outputs, JAX's tuple order: the sort permutation of
    the pair keys, the first row of each slot's run, the pair key of each
    slot (N1^2 - 1 past the count), the slot count (it may exceed the
    capacity) and the run heads."""
    order: torch.Tensor       # (R2,) int32
    starts: torch.Tensor      # (slot_cap,) int32
    pid_start: torch.Tensor   # (slot_cap,) int32
    n_slots: torch.Tensor     # () int32
    is_start: torch.Tensor    # (R2,) bool


def _sorted(keys: torch.Tensor):
    srt = torch.sort(keys, stable=True)
    return srt.values.contiguous(), srt.indices.to(torch.int32).contiguous()


def _runs_plain(keys: torch.Tensor, n_seg: int):
    """(sorted keys, order, starts, lens) of JAX's searchsorted runs."""
    keys_sorted, order = _sorted(keys)
    ids = torch.arange(n_seg, dtype=keys.dtype, device=keys.device)
    starts = torch.searchsorted(keys_sorted, ids, side="left")
    ends = torch.searchsorted(keys_sorted, ids, side="right")
    return keys_sorted, order, starts, (ends - starts).to(torch.int32)


def _take(order, pos, valid, R):
    R_t = torch.full_like(order[:1], R)
    return torch.where(valid, order[torch.clamp(pos, 0, max(R - 1, 0))], R_t).to(torch.int32)


def gather_table_plain(keys: torch.Tensor, n_seg: int, K: int):
    """Twin of scatter_table's core: (entry (n_seg, K) int32, max_len)."""
    R = keys.numel()
    _ks, order, starts, lens = _runs_plain(keys, n_seg)
    k = torch.arange(K, dtype=torch.int64, device=keys.device)
    entry = _take(order, starts[:, None] + k[None, :], k[None, :] < lens[:, None], R)
    return entry, torch.max(lens)


def gather_table_rows_plain(keys: torch.Tensor, n_seg: int, K: int, hot_cap: int, K2: int):
    """Twin of scatter_table_rows: (entry, hot_idx, hot_entry, hot_n,
    max_deg)."""
    from .compact import compact_plain

    R = keys.numel()
    _ks, order, starts, lens = _runs_plain(keys, n_seg)
    k = torch.arange(K, dtype=torch.int64, device=keys.device)
    entry = _take(order, starts[:, None] + k[None, :], k[None, :] < lens[:, None], R)
    hot_idx, hot_n = compact_plain(lens > K, hot_cap)
    hot_valid = torch.arange(hot_cap, device=keys.device) < torch.clamp_max(hot_n, hot_cap)
    hi = hot_idx.to(torch.int64)
    k2 = torch.arange(K2, dtype=torch.int64, device=keys.device)
    valid2 = hot_valid[:, None] & (k2[None, :] < (lens[hi] - K)[:, None])
    hot_entry = _take(order, starts[hi][:, None] + K + k2[None, :], valid2, R)
    return entry, hot_idx, hot_entry, hot_n, torch.max(lens)


def _pair_keys_plain(conn: torch.Tensor, n_blocks: int):
    N1 = n_blocks + 1
    cl = torch.clamp_max(conn.to(torch.int32), n_blocks)
    pid = cl[:, :, None] * N1 + cl[:, None, :]
    dummy = (cl[:, :, None] >= n_blocks) | (cl[:, None, :] >= n_blocks)
    return torch.where(dummy, torch.full_like(pid, N1 * N1 - 1), pid).reshape(-1)


def direct_tables_plain(conn: torch.Tensor, n_blocks: int, slot_cap: int) -> DirectTables:
    """Twin of direct_tables over the single bucket's (E, b) connectivity."""
    from .compact import compact_plain

    N1 = n_blocks + 1
    pid = _pair_keys_plain(conn, n_blocks)
    pid_sorted, order = _sorted(pid)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=pid.device),
                          pid_sorted[1:] != pid_sorted[:-1]])
    starts, n_slots = compact_plain(is_start, slot_cap)
    valid = torch.arange(slot_cap, device=pid.device) < torch.clamp_max(n_slots, slot_cap)
    pid_start = torch.where(valid, pid_sorted[starts.to(torch.int64)],
                            torch.full_like(starts, N1 * N1 - 1)).to(torch.int32)
    return DirectTables(order, starts, pid_start, n_slots, is_start)


def _check_keys(keys, name):
    keys = keys.reshape(-1)
    if keys.numel() >= 2**31:
        raise ValueError(f"{name}: the keys exceed the int32 range")
    return keys.to(torch.int32).contiguous()


def gather_table(keys: torch.Tensor, n_seg: int, K: int):
    """(entry (n_seg, K) int32, max_len () int32) of a flat key vector: the
    level-1 table of scatter_table. Keys >= n_seg (the dummy block) sort
    past every run."""
    if keys.device.type == "cpu":
        return gather_table_plain(keys.reshape(-1), n_seg, K)
    keys = _check_keys(keys, "gather_table")
    build.require_cuda("gather_table", keys)
    keys_sorted, order = _sorted(keys)
    R = keys.numel()
    entry = torch.empty((n_seg, K), dtype=torch.int32, device=keys.device)
    lens = torch.empty((n_seg,), dtype=torch.int32, device=keys.device)
    max_len = torch.zeros((), dtype=torch.int32, device=keys.device)
    rc = build.entry("stk_gather_table")(
        keys_sorted.data_ptr(), order.data_ptr(), R, n_seg, K, entry.data_ptr(),
        lens.data_ptr(), max_len.data_ptr(), None, build.stream_ptr(keys.device))
    build.check_status("gather_table", rc)
    build.count_launch("gather_tables[scatter_table]")
    return entry, max_len


def gather_table_rows(keys: torch.Tensor, n_seg: int, K: int, hot_cap: int, K2: int):
    """scatter_table_rows: (entry, hot_idx, hot_entry, hot_n, max_deg)."""
    if keys.device.type == "cpu":
        return gather_table_rows_plain(keys.reshape(-1), n_seg, K, hot_cap, K2)
    keys = _check_keys(keys, "gather_table_rows")
    build.require_cuda("gather_table_rows", keys)
    dev = keys.device
    keys_sorted, order = _sorted(keys)
    R = keys.numel()
    entry = torch.empty((n_seg, K), dtype=torch.int32, device=dev)
    lens = torch.empty((n_seg,), dtype=torch.int32, device=dev)
    max_deg = torch.zeros((), dtype=torch.int32, device=dev)
    hot = torch.empty((n_seg,), dtype=torch.uint8, device=dev)
    stream = build.stream_ptr(dev)
    rc = build.entry("stk_gather_table")(
        keys_sorted.data_ptr(), order.data_ptr(), R, n_seg, K, entry.data_ptr(),
        lens.data_ptr(), max_deg.data_ptr(), hot.data_ptr(), stream)
    build.check_status("gather_table_rows", rc)
    build.count_launch("gather_tables[scatter_table_rows]")
    hot_idx, hot_n = compact(hot, hot_cap, "hot")
    hot_entry = torch.empty((hot_cap, K2), dtype=torch.int32, device=dev)
    rc = build.entry("stk_gather_hot")(
        keys_sorted.data_ptr(), order.data_ptr(), R, lens.data_ptr(), hot_idx.data_ptr(),
        hot_n.data_ptr(), hot_cap, K, K2, hot_entry.data_ptr(), stream)
    build.check_status("gather_table_rows", rc)
    build.count_launch("gather_tables[scatter_table_rows]")
    return entry, hot_idx, hot_entry, hot_n, max_deg


def direct_tables(conn: torch.Tensor, n_blocks: int, slot_cap: int) -> DirectTables:
    """The sorted block-pair layout of the single bucket's (E, b)
    connectivity (dummy id n_blocks): JAX's direct_tables."""
    if conn.device.type == "cpu":
        return direct_tables_plain(conn, n_blocks, slot_cap)
    if (n_blocks + 1) ** 2 >= 2**31 or conn.numel() * conn.shape[1] >= 2**31:
        raise ValueError("direct_tables: the pair keys exceed the int32 range")
    conn = conn.to(torch.int32).contiguous()
    build.require_cuda("direct_tables", conn)
    dev = conn.device
    E, b = conn.shape
    N1 = n_blocks + 1
    stream = build.stream_ptr(dev)
    pid = torch.empty((E * b * b,), dtype=torch.int32, device=dev)
    rc = build.entry("stk_pair_keys")(conn.data_ptr(), E, b, n_blocks, pid.data_ptr(), stream)
    build.check_status("direct_tables", rc)
    build.count_launch("gather_tables[direct_tables]")
    pid_sorted, order = _sorted(pid)
    R2 = pid.numel()
    head = torch.empty((R2,), dtype=torch.uint8, device=dev)
    rc = build.entry("stk_run_heads")(pid_sorted.data_ptr(), R2, head.data_ptr(), stream)
    build.check_status("direct_tables", rc)
    build.count_launch("gather_tables[direct_tables]")
    starts, n_slots = compact(head, slot_cap, "direct_slots")
    pid_start = torch.empty((slot_cap,), dtype=torch.int32, device=dev)
    rc = build.entry("stk_slot_pids")(pid_sorted.data_ptr(), starts.data_ptr(),
                                      n_slots.data_ptr(), slot_cap, N1 * N1 - 1,
                                      pid_start.data_ptr(), stream)
    build.check_status("direct_tables", rc)
    build.count_launch("gather_tables[direct_tables]")
    return DirectTables(order, starts, pid_start, n_slots, head.bool())
