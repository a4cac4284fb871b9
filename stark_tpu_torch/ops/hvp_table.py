"""Kernel AB: q = H p by the gather table (csrc/hvp_table.cu) and its twin.

Replaces stark_tpu/solver/assembly.py `hvp_table` (:239-249): every
element's q_e = H_e p_e (a dummy block, id n_blocks, gathers zero), then
q[i] = sum_k q_pad[entry[i, k]] over block i's row of kernel AA's
(n_blocks, K) table, q_pad the flat (R, 3) rows of q_e with a zero row R
appended. The kernel takes the single bucket (one (E, b) connectivity and
its (E, 3b, 3b) Hessians); the twin, like JAX's, also takes several arity
groups, whose flat rows follow one another in ascending arity.
"""
from __future__ import annotations

import torch

from . import build


def hvp_table_plain(p: torch.Tensor, groups, entry: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: groups is a list of (conn (E, a), H (E, 3a, 3a))
    in ascending arity."""
    p_pad = torch.cat([p, torch.zeros((1, 3), dtype=p.dtype, device=p.device)])
    qs = []
    for conn, H in groups:
        E, a = conn.shape
        p_e = p_pad[conn.to(torch.int64)].reshape(E, 3 * a)
        qs.append(torch.einsum("eij,ej->ei", H, p_e).reshape(-1, 3))
    q_flat = torch.cat(qs) if len(qs) > 1 else qs[0]
    q_pad = torch.cat([q_flat, torch.zeros((1, 3), dtype=p.dtype, device=p.device)])
    return torch.sum(q_pad[entry.to(torch.int64)], dim=1)


def hvp_table(p: torch.Tensor, groups, entry: torch.Tensor) -> torch.Tensor:
    """q = H p over the gather table `entry` (n_blocks, K) of the flat rows
    of `groups` [(conn, H), ...]; on CUDA the single bucket (one group)."""
    n_blocks = p.shape[0]
    if p.device.type == "cpu":
        return hvp_table_plain(p, groups, entry)
    if len(groups) != 1:
        raise ValueError("hvp_table: the kernel takes the single bucket (one group)")
    conn, H = groups[0]
    E, b = conn.shape
    if H.shape != (E, 3 * b, 3 * b) or p.shape != (n_blocks, 3) \
            or entry.dim() != 2 or entry.shape[0] != n_blocks:
        raise ValueError("hvp_table: inconsistent shapes")
    conn = conn.to(torch.int32).contiguous()
    entry = entry.to(torch.int32).contiguous()
    p = p.contiguous()
    H = H.contiguous()
    build.require_cuda("hvp_table", p, conn, H, entry)
    if H.dtype != p.dtype:
        raise TypeError("hvp_table: H must match p's dtype")
    q = torch.empty_like(p)
    rc = build.entry("stk_hvp_table", p.dtype)(
        H.data_ptr(), conn.data_ptr(), b, p.data_ptr(), n_blocks, entry.data_ptr(),
        entry.shape[1], E * b, q.data_ptr(), build.stream_ptr(p.device))
    build.check_status("hvp_table", rc)
    build.count_launch("hvp_table")
    return q
