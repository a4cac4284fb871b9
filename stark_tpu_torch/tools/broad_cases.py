"""Inputs for kernels F and L (csrc/ball_wide.cu, csrc/rowk_select.cu) that
reach what their tiles, bit words, query groups and copy checks must get
right, seeded with numpy. tests/test_torch_broad_lists_host.py runs them
through the g++ build at small sizes, tests/test_torch_cuda.py through the
card at larger ones; both hold the outputs exactly against the twins.

- `ball_case`: two ball sets whose column count need not be a multiple of
  16, 32 or 512 (a ragged last tile and lane), rows with no allowed pair, a
  column band with none, radii sized for a few hits per row.
- `rowk_grid_case`: a hand-built bucket index (kernel K's layout: each
  bucket's run ascending, copies adjacent, nt past the runs) where one
  bucket holds many queries and a run longer than several staged tiles
  (RK_TILE of csrc/rowk_select.cu, 1,024 slots) with a copy straddling each
  tile boundary (its target inside every heavy query's sphere), other
  buckets hold one query each or none, and occ_cap cuts the long run
  inside a tile.
- `rowk_dense_case`: queries and targets for the dense forms, with a target
  count past several tiles and a query count off the block's 16.
"""
from __future__ import annotations

import numpy as np
import torch

from ..collision import broad_phase as bp
from ..ops import rowk_select as rk

RK_TILE = 1024


def ball_case(seed: int, na: int, nb: int, dtype, hits_per_row: float = 6.0):
    """(A, ra, B, rb, allowed, extra) of kernel F: centres in the unit cube,
    radii sized for about `hits_per_row` hits per row, allowed at 85% with
    every 7th row and a band of columns disallowed."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    reach = (3.0 * hits_per_row / (4.0 * np.pi * max(nb, 1))) ** (1.0 / 3.0)
    A, B = f(rng.random((na, 3))), f(rng.random((nb, 3)))
    ra = f(0.4 * reach * rng.uniform(0.5, 1.5, na))
    rb = f(0.4 * reach * rng.uniform(0.5, 1.5, nb))
    allowed = rng.random((na, nb)) < 0.85
    allowed[3::7] = False
    allowed[:, nb // 3: nb // 3 + 40] = False
    return (A, ra, B, rb, torch.as_tensor(allowed).to(torch.uint8),
            torch.tensor(0.2 * reach, dtype=dtype))


def _pred(rng, code: str, nq: int, nt: int, M: int = 3, nv: int = 60):
    """A predicate of `code` with mesh ids from M meshes, a random allowed
    table and vertex tables over nv vertices (so shared vertices and
    same-mesh incidence occur)."""
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)
    allowed = torch.as_tensor(rng.random(M * M) < 0.8).to(torch.uint8)
    allowed[0] = 1
    tk = 3 if code in ("pt_dd", "et", "et_rr") else 2
    return rk.Pred(code, i32(rng.integers(0, M, nq)), i32(rng.integers(0, M, nt)), allowed,
                   qidx=i32(rng.integers(0, nv, (nq, 2))),
                   tidx=i32(rng.integers(0, nv, (nt, tk))))


def _sorted_run(rng, n: int, nt: int, tile_copies: bool):
    """n ascending ids in [0, nt) with adjacent copies; with tile_copies the
    ids at walk positions k * RK_TILE - 1 and k * RK_TILE are equal."""
    ids = np.sort(rng.integers(0, nt, n))
    if tile_copies:
        for k in range(RK_TILE, n, RK_TILE):
            ids[k] = ids[k - 1]
    return ids


def rowk_grid_case(seed: int, code: str, dtype, run: int = 2600, heavy: int = 40,
                   light: int = 30, nt: int = 3000, occ_cap: int = 2200,
                   table_size: int = 4096):
    """(qc, tc, Sphere("grid"), Pred, GridIndex) of kernel L's grid mode:
    `heavy` queries in one cell, whose bucket holds a run of `run` ids
    (copies at every tile boundary) cut at occ_cap; `light` queries each in
    a cell of its own bucket, runs of 0 to 60 ids (a third empty)."""
    rng = np.random.default_rng(seed)
    h = 0.05
    # distinct buckets: the heavy cell first, then one cell per light query
    cells, buckets = [], set()
    while len(cells) < 1 + light:
        c = rng.integers(-6, 6, 3)
        b = int(bp._hash_cells(torch.as_tensor(c)[None], table_size)[0])
        if b not in buckets:
            buckets.add(b)
            cells.append(c)
    cells = np.array(cells)
    q_cells = np.concatenate([np.repeat(cells[:1], heavy, 0), cells[1:]])
    qc = (q_cells + rng.uniform(0.1, 0.9, q_cells.shape)) * h
    qc = qc[rng.permutation(len(qc))]        # the heavy bucket's queries spread over ids
    # targets around the heavy cell, reaching many of its queries
    tc = (cells[0] + 0.5 + rng.uniform(-2.0, 2.0, (nt, 3))) * h
    qa = rng.uniform(0.01, 0.03, len(qc))
    ta = rng.uniform(0.01, 0.05, nt)
    runs = {}
    for i, c in enumerate(cells):
        b = int(bp._hash_cells(torch.as_tensor(c)[None], table_size)[0])
        n = run if i == 0 else (0 if i % 3 == 0 else int(rng.integers(1, 60)))
        runs[b] = _sorted_run(rng, n, nt, i == 0)
        if i == 0:
            # the copies at the tile boundaries sit at the heavy cell's
            # centre, inside every heavy query's sphere
            edge = runs[b][RK_TILE - 1::RK_TILE]
            tc[edge] = (c + 0.5) * h
            ta[edge] = 0.05
    counts = np.zeros(table_size, np.int64)
    for b, ids in runs.items():
        counts[b] = len(ids)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    tid_sorted = np.full(int(offsets[-1]) + 64, nt, np.int64)
    for b, ids in runs.items():
        tid_sorted[offsets[b]:offsets[b] + len(ids)] = ids
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)
    grid = rk.GridIndex(i32(offsets), i32(tid_sorted), torch.tensor(h, dtype=dtype), occ_cap)
    return (f(qc), f(tc), rk.Sphere("grid", f(qa), f(ta)),
            _pred(rng, code, len(qc), nt), grid)


def rowk_dense_case(seed: int, form: str, code: str, dtype, nq: int = 37, nt: int = 2600):
    """(qc, tc, Sphere(form), Pred) of kernel L's dense mode: nt past two
    staged tiles and not a multiple of 32, nq off the block's 16 queries."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    qc, tc = f(rng.uniform(-0.2, 0.2, (nq, 3))), f(rng.uniform(-0.2, 0.2, (nt, 3)))
    qa, qb = f(rng.uniform(0.005, 0.03, nq)), f(rng.uniform(0.0, 0.01, nq))
    ta, tb = f(rng.uniform(0.005, 0.05, nt)), f(rng.uniform(0.0, 0.01, nt))
    sph = rk.Sphere(form, qa, ta, qb=qb, tb=tb, sl=torch.tensor(0.004, dtype=dtype))
    return qc, tc, sph, _pred(rng, code, nq, nt)


ROWK_DENSE = [("pt", "pt_dd"), ("pt", "pt_rr"), ("pt", "none"), ("ee", "ee_dd"),
              ("ee", "ee_rr"), ("ee", "none"), ("et", "et"), ("et", "et_rr"), ("et", "none")]
