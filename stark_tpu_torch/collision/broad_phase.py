"""Spatial-hash broad phase: the plain PyTorch forms.

Port of `stark_tpu/collision/broad_phase.py`. Instead of an octree (tmcd's
Octree.cpp:46-90, BroadPhasePTEEBase.cpp:51-100), primitives hash into a
uniform grid:

  * every TARGET primitive, described by its bounding sphere (tc, tr), is
    inserted into every cell that the cube [tc - R, tc + R] overlaps,
    R = tr + max(qr), with `ins_slots` insertion slots per target in
    row-major order over its covered-cell box (x fastest); the true
    covered-cell count is reported for the capacity check;
  * every QUERY primitive (qc, qr) reads the single cell holding qc: any
    target within qr + tr of qc covers that cell, so the read is
    conservative;
  * cells hash into `table_size` buckets (a power of two). A collision only
    adds candidates, which the caller's exact sphere test filters; within a
    bucket the targets are sorted by id, so the copies of a target inserted
    through several cells of one bucket are adjacent and dropped.

`grid_candidates` is JAX's function, split into the build half (kernel K,
`ops/grid_build.py`) and the query half (`grid_query_plain`; on the card
kernel L, `ops/rowk_select.py`, fuses it with the sphere test, the exclusion
predicate and the row-K selection). Composed, the two halves equal JAX's
function. The hash multiplies in int32 with wrap-around, as JAX does; here
the product is taken in int64 and only its low bits, the same as the
wrapped int32 product's, are kept.
"""
from __future__ import annotations

import torch

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # standard spatial-hash primes


def _cell_of(x, h):
    return torch.floor(x / h).to(torch.int32)


def _hash_cells(c, table_size: int):
    c = c.long()
    hx = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (hx & (table_size - 1)).to(torch.int32)


def table_size_for(nt: int) -> int:
    """Buckets for nt targets: the power of two at or above 4 nt, at least
    256 (stark_tpu contact_engine.py:620)."""
    return 1 << max(8, (4 * nt - 1).bit_length())


def _median(x):
    """jnp.median: the mean of the two middle values of an even-length
    input ((lo + hi) * 0.5, JAX's 'midpoint' quantile), NaN if any is."""
    s = torch.sort(x).values
    n = s.shape[0]
    m = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(m, float("nan")), m)


def pick_cell_size(qr, tr):
    """Cell size ~ the typical inflated pair radius: median(tr) +
    median(qr) + 1e-12 (0-d, on the inputs' device)."""
    med_q = _median(qr) if qr.shape[0] else torch.zeros((), dtype=tr.dtype,
                                                        device=tr.device)
    return (_median(tr) + med_q) + 1e-12


def max_query_radius(qr):
    return torch.max(qr) if qr.shape[0] else torch.zeros((), dtype=qr.dtype,
                                                         device=qr.device)


def grid_query_plain(offsets, tid_sorted, qc, h, occ_cap: int, table_size: int,
                     T: int):
    """The query half of `grid_candidates`: each query's bucket run, cut to
    occ_cap, with the repeated ids dropped. Returns (tid_grid (Q, occ_cap)
    int32 with T as the pad, valid (Q, occ_cap) bool, max_occ () int32,
    the true largest run a query reads)."""
    Q = qc.shape[0]
    dev = qc.device
    qb = _hash_cells(_cell_of(qc, h), table_size).long()
    starts = offsets.long()[qb]
    occ = (offsets.long()[qb + 1] - starts).to(torch.int32)
    max_occ = occ.max() if Q else torch.zeros((), dtype=torch.int32, device=dev)
    k = torch.arange(occ_cap, dtype=torch.int64, device=dev)
    pos = starts[:, None] + k[None, :]
    in_run = k[None, :] < torch.clamp_max(occ, occ_cap).long()[:, None]
    pos_c = torch.clamp(pos, 0, max(tid_sorted.shape[0] - 1, 0))
    tid_grid = torch.where(in_run, tid_sorted[pos_c],
                           torch.full_like(pos_c, T, dtype=torch.int32))
    dup = torch.cat([torch.zeros((Q, 1), dtype=torch.bool, device=dev),
                     tid_grid[:, 1:] == tid_grid[:, :-1]], dim=1)
    valid = in_run & ~dup & (tid_grid < T)
    return tid_grid.to(torch.int32), valid, max_occ


def grid_candidates(qc, qr, tc, tr, h, ins_slots: int, occ_cap: int,
                    table_size: int):
    """JAX's grid_candidates: (tid_grid (Q, occ_cap) int32, valid (Q,
    occ_cap) bool, max_cells () int32, max_occ () int32); see the module
    note. The build half goes through kernel K (its twin on the CPU)."""
    from ..ops.grid_build import grid_build

    offsets, tid_sorted, max_cells = grid_build(
        tc, tr, max_query_radius(qr), h, ins_slots, table_size)
    tid_grid, valid, max_occ = grid_query_plain(
        offsets, tid_sorted, qc, h, occ_cap, table_size, tc.shape[0])
    return tid_grid, valid, max_cells, max_occ
