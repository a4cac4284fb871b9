"""Kernel C: batched PD projection by parallel-order Jacobi
(csrc/pd_project.cu) and its plain twin.

Replaces stark_tpu/solver/project.py `_jacobi_eigh` (:53-113) and
`project_family_to_pd` (:122-141). The twin keeps the JAX function's
arithmetic: the round-robin schedule of `_round_robin_rounds`, the same
rotation angle and the same sweep count, in a (d, d, E) layout where every
round is two full-tensor passes; `batched_eigh` takes exact `torch.linalg.eigh`
when sweeps == 0 or d <= 3, exactly as `project.batched_eigh` does. On CUDA
every d <= 16 goes through the kernel, and sweeps == 0 raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import build


def _round_robin_rounds(d: int):
    """Parallel Jacobi (round-robin / 'chess tournament') schedule: a list
    of rounds, each a list of DISJOINT (p, q) pairs covering all d*(d-1)/2
    pairs across the rounds. Even d: d-1 rounds of d/2 pairs; odd d: d
    rounds with one index sitting out each round."""
    idx = list(range(d))
    if d % 2 == 1:
        idx.append(-1)          # bye slot
    n = len(idx)
    rounds = []
    for _ in range(n - 1):
        pairs = []
        for i in range(n // 2):
            a, b = idx[i], idx[n - 1 - i]
            if a >= 0 and b >= 0:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _round_tables(d: int):
    """Per-round (p_idx, q_idx, perm, slot, sgn, paired) numpy tables."""
    tables = []
    for pairs in _round_robin_rounds(d):
        perm = list(range(d))
        slot = [0] * d
        sgn = [0.0] * d
        paired = [False] * d
        for k, (p, q) in enumerate(pairs):
            perm[p], perm[q] = q, p
            slot[p] = slot[q] = k
            sgn[p], sgn[q] = -1.0, 1.0
            paired[p] = paired[q] = True
        tables.append((np.asarray([p for p, _ in pairs]),
                       np.asarray([q for _, q in pairs]),
                       np.asarray(perm), np.asarray(slot), np.asarray(sgn),
                       np.asarray(paired)))
    return tables


@functools.lru_cache(maxsize=None)
def _partner_table(d: int, device: torch.device) -> torch.Tensor:
    """(n_rounds, d) int32: the partner of each row per round (itself for a
    bye) — the kernel's copy of the schedule."""
    rows = []
    for pairs in _round_robin_rounds(d):
        partner = list(range(d))
        for p, q in pairs:
            partner[p], partner[q] = q, p
        rows.append(partner)
    return torch.as_tensor(np.asarray(rows, dtype=np.int32).reshape(-1, d),
                           device=device).contiguous()


def _jacobi_eigh(A: torch.Tensor, sweeps: int):
    """Batched parallel-order Jacobi for symmetric (E, d, d) stacks.
    Returns (w, V) with A ~= V @ diag(w) @ V^T. Each round applies
    floor(d/2) disjoint rotations at once as two full-tensor axis updates
    built from a static partner permutation:
        B  = c_row * A + s_row * A[perm, :]        (G^T A)
        A' = c_col * B + s_col * B[:, perm]        (... G)"""
    d = A.shape[-1]
    E = A.shape[0]
    dev = A.device
    A = torch.movedim(A, 0, -1)                      # (d, d, E)
    V = torch.eye(d, dtype=A.dtype, device=dev)[:, :, None].expand(d, d, E)
    tabs = [tuple(torch.as_tensor(x, device=dev) for x in t)
            for t in _round_tables(d)]
    for _ in range(sweeps):
        for p_idx, q_idx, perm, slot, sgn, paired in tabs:
            app = A[p_idx, p_idx]                    # (n_pairs, E)
            aqq = A[q_idx, q_idx]
            apq = A[p_idx, q_idx]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c = torch.cos(theta)
            s = torch.sin(theta)
            # bye rows (odd d) rotate by identity
            cr = torch.where(paired[:, None], c[slot], torch.ones_like(c[slot]))
            sr = sgn.to(A.dtype)[:, None] * s[slot]
            B = cr[:, None, :] * A + sr[:, None, :] * A[perm, :, :]
            A = cr[None, :, :] * B + sr[None, :, :] * B[:, perm, :]
            V = cr[None, :, :] * V + sr[None, :, :] * V[:, perm, :]
    w = torch.diagonal(A, 0, 0, 1)                   # (E, d)
    return w, torch.movedim(V, -1, 0)                # (E, d, d)


def batched_eigh(H: torch.Tensor, jacobi_sweeps: int):
    if jacobi_sweeps and H.shape[-1] > 3:
        return _jacobi_eigh(H, jacobi_sweeps)
    return torch.linalg.eigh(H)


def pd_project_plain(H: torch.Tensor, eps: float, mirroring: bool,
                     elem_mask=None, jacobi_sweeps: int = 0):
    """Plain PyTorch twin of project_family_to_pd: returns (H_out, changed)."""
    w, V = batched_eigh(H, jacobi_sweeps)
    below = w < eps
    w_new = torch.where(below, -w if mirroring else torch.full_like(w, eps), w)
    Hp = torch.einsum("eij,ej,ekj->eik", V, w_new, V)
    changed = torch.any(below, dim=-1)
    if elem_mask is not None:
        changed = changed & elem_mask
    return torch.where(changed[:, None, None], Hp, H), changed


def pd_project(H: torch.Tensor, eps: float, mirroring: bool, elem_mask=None,
               jacobi_sweeps: int = 0):
    """Project a (E, d, d) stack of symmetric matrices to PD. Returns
    (H_projected, changed): changed marks the elements whose eigenvalues
    were modified (and that elem_mask allows); only those are rebuilt."""
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"pd_project: expected (E, d, d), got {tuple(H.shape)}")
    if H.device.type == "cpu":
        return pd_project_plain(H, eps, mirroring, elem_mask, jacobi_sweeps)
    E, d, _ = H.shape
    if not jacobi_sweeps:
        raise ValueError("pd_project: exact eigh (jacobi_sweeps=0) is a CPU "
                         "path; the CUDA kernel needs jacobi_sweeps > 0")
    if d > 16:
        raise ValueError(f"pd_project: d={d} exceeds the kernel's 16")
    build.require_cuda("pd_project", H)
    mask = None
    if elem_mask is not None:
        mask = elem_mask.to(torch.uint8).contiguous()
        build.require_cuda("pd_project", H, mask)
        if mask.shape != (E,):
            raise ValueError("pd_project: elem_mask must be (E,)")
    sched = _partner_table(d, H.device)
    fn = build.entry("stk_pd_project", H.dtype)
    out = torch.empty_like(H)
    changed = torch.empty((E,), dtype=torch.uint8, device=H.device)
    rc = fn(H.data_ptr(), E, d, sched.data_ptr(), sched.shape[0],
            int(jacobi_sweeps), float(eps), int(bool(mirroring)),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            changed.data_ptr(), build.stream_ptr(H.device))
    build.check_status("pd_project", rc)
    build.count_launch("pd_project")
    return out, changed.bool()
