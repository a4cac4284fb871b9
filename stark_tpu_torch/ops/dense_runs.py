"""Kernel AC: the run sums of the dense assembly (csrc/dense_runs.cu) and
their twins.

Replaces stark_tpu/solver/assembly.py `_seg_scan_rows` (:626-640) with
`assemble_dense_perm` (:642-670), and the f64 cumsum run sums of
`direct_solve` (:789-821): the 9 values of each element block pair, in the
sorted block-pair order of kernel AA's `direct_tables`, summed per run and
written into the dense matrix. Two layouts:

  * PERM, `assemble_dense_perm`: the permuted (component-major) (3 N1)^2
    matrix Hp[(a, b1), (c, b2)] = H[(b1, a), (b2, c)] with N1 = n_blocks + 1,
    the dummy block an identity; summed in the input dtype, as JAX's
    segment-local scan;
  * DIRECT, `direct_solve`: the block-major (3n)^2 matrix of the n real
    blocks; summed in float64, as JAX's cumsum, and rounded once.

The twins repeat JAX's arithmetic: the segmented scan of log2(R2) shifted
masked adds, and the float64 cumsum with boundary differences.
"""
from __future__ import annotations

import torch

from . import build

PERM, DIRECT = 0, 1


def pair_values(H: torch.Tensor) -> torch.Tensor:
    """(E b^2, 9) element block values, row (e b + i) b + j = H_e's block
    (i, j), in the pair keys' order."""
    E, d, _ = H.shape
    b = d // 3
    return H.reshape(E, b, 3, b, 3).permute(0, 1, 3, 2, 4).reshape(-1, 9)


def seg_scan_rows(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan of (R, W) rows along axis 0, heads marked by
    `flags` (stark_tpu assembly.py `_seg_scan_rows`): log2(R) shifted masked
    adds, the sums segment-local."""
    R = v.shape[0]
    d = 1
    while d < R:
        vs = torch.cat([torch.zeros((d, v.shape[1]), dtype=v.dtype, device=v.device), v[:-d]])
        fs = torch.cat([torch.ones((d,), dtype=torch.bool, device=v.device), flags[:-d]])
        v = v + torch.where(flags[:, None], torch.zeros_like(vs), vs)
        flags = flags | fs
        d *= 2
    return v


def _bounds(dtab, R2):
    """(lo, hi) rows of each slot's run: JAX's next-run boundary, the last
    valid slot ending at R2."""
    starts = dtab.starts.to(torch.int64)
    slot_cap = starts.shape[0]
    nxt = torch.cat([starts[1:], torch.full((1,), R2, dtype=torch.int64, device=starts.device)])
    has_next = torch.arange(slot_cap, device=starts.device) + 1 \
        < torch.clamp_max(dtab.n_slots.to(torch.int64), slot_cap)
    nxt = torch.where(has_next, nxt, torch.full_like(nxt, R2))
    return starts, torch.clamp(nxt - 1, 0, R2 - 1)


def dense_runs_plain(H: torch.Tensor, dtab, n_blocks: int, layout: int) -> torch.Tensor:
    """Plain twin: JAX's assemble_dense_perm (PERM) or direct_solve's dense
    matrix (DIRECT)."""
    N1 = n_blocks + 1
    vals = pair_values(H)[dtab.order.to(torch.int64)]
    R2 = vals.shape[0]
    starts, hi = _bounds(dtab, R2)
    pid = dtab.pid_start.to(torch.int64)
    D4 = torch.zeros((N1 * N1, 9), dtype=H.dtype, device=H.device)
    if layout == PERM:
        sums = seg_scan_rows(vals, dtab.is_start)[hi]
        D4[pid] = sums
        D4[N1 * N1 - 1] = torch.eye(3, dtype=H.dtype, device=H.device).reshape(9)
        return D4.reshape(N1, N1, 3, 3).permute(2, 0, 3, 1).reshape(3 * N1, 3 * N1)
    csum = torch.cumsum(vals.to(torch.float64), dim=0)
    base = torch.where((starts > 0)[:, None], csum[torch.clamp(starts - 1, 0, R2 - 1)],
                       torch.zeros_like(csum[:1]))
    D4[pid] = (csum[hi] - base).to(H.dtype)
    D4[N1 * N1 - 1] = 0.0
    n = 3 * n_blocks
    D = D4.reshape(N1, N1, 3, 3)[:n_blocks, :n_blocks]
    return D.permute(0, 2, 1, 3).reshape(n, n)


def direct_sum_scales(H: torch.Tensor, dtab, n_blocks: int):
    """The two scales of the sum rule for the DIRECT layout, float64, in
    that layout: each entry's sum |terms|, and the sum |terms| of the
    prefix whose f64 cumsum the twin (JAX's direct_solve) differences at
    that entry's run (the twin's error grows with the prefix, not with the
    run)."""
    N1 = n_blocks + 1
    vals = pair_values(H).abs().to(torch.float64)[dtab.order.to(torch.int64)]
    R2 = vals.shape[0]
    starts, hi = _bounds(dtab, R2)
    csum = torch.cumsum(vals, dim=0)
    base = torch.where((starts > 0)[:, None], csum[torch.clamp(starts - 1, 0, R2 - 1)],
                       torch.zeros_like(csum[:1]))
    pid = dtab.pid_start.to(torch.int64)
    n = 3 * n_blocks
    out = []
    for per_slot in (csum[hi] - base, csum[hi]):
        D4 = torch.zeros((N1 * N1, 9), dtype=torch.float64, device=H.device)
        D4[pid] = per_slot
        D4[N1 * N1 - 1] = 0.0
        out.append(D4.reshape(N1, N1, 3, 3)[:n_blocks, :n_blocks].permute(0, 2, 1, 3)
                   .reshape(n, n))
    return tuple(out)


def dense_runs(H: torch.Tensor, dtab, n_blocks: int, layout: int) -> torch.Tensor:
    """The dense matrix of the single bucket's element Hessians H (E, 3b,
    3b) over kernel AA's tables `dtab` (ops.tables.DirectTables), in
    `layout` (PERM or DIRECT)."""
    if H.device.type == "cpu":
        return dense_runs_plain(H, dtab, n_blocks, layout)
    if layout not in (PERM, DIRECT):
        raise ValueError(f"dense_runs: unknown layout {layout}")
    E, d, _ = H.shape
    H = H.contiguous()
    order = dtab.order.to(torch.int32).contiguous()
    starts = dtab.starts.to(torch.int32).contiguous()
    pid_start = dtab.pid_start.to(torch.int32).contiguous()
    n_slots = dtab.n_slots.to(torch.int32).contiguous()
    build.require_cuda("dense_runs", H, order, starts, pid_start, n_slots)
    n = 3 * (n_blocks + 1) if layout == PERM else 3 * n_blocks
    out = torch.zeros((n, n), dtype=H.dtype, device=H.device)
    rc = build.entry("stk_dense_runs", H.dtype)(
        H.data_ptr(), d // 3, order.data_ptr(), starts.data_ptr(), pid_start.data_ptr(),
        n_slots.data_ptr(), starts.shape[0], order.shape[0], n_blocks, layout,
        out.data_ptr(), build.stream_ptr(H.device))
    build.check_status("dense_runs", rc)
    build.count_launch("dense_runs[perm]" if layout == PERM else "dense_runs[direct]")
    return out
