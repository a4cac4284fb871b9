"""Legacy VTK writer and reader for frame output.

Port of `stark_tpu/utils/vtk.py`. `write_vtk` writes, straight from numpy,
the binary legacy layout of the JAX package's native writer
(repo-root `native/stark_native.cc` sn_write_vtk, the analog of upstream's
vtkio): the same header lines, title included, big-endian float64 points
and int32 cells, so the same arrays give the same bytes. `read_vtk` reads
that layout and the JAX package's ASCII fallback.
"""
from __future__ import annotations

import numpy as np

_CELL_TYPES = {"points": 1, "segments": 3, "triangles": 5, "tets": 10}


def write_vtk(path: str, vertices, conn, kind: str):
    """One cell family per file (upstream's per-group frame files):
    `vertices` (n, 3), `conn` (n_cells, arity) or (n_cells,) for points."""
    vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    conn = np.asarray(conn, dtype=np.int64)
    if conn.ndim == 1:
        conn = conn.reshape(-1, 1)
    n_cells, k = conn.shape
    cells = np.empty((n_cells, k + 1), dtype=">i4")
    cells[:, 0] = k
    cells[:, 1:] = conn
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\nstark_tpu frame\nBINARY\n"
                b"DATASET UNSTRUCTURED_GRID\nPOINTS %d double\n" % len(vertices))
        f.write(vertices.astype(">f8").tobytes())
        f.write(b"\nCELLS %d %d\n" % (n_cells, n_cells * (k + 1)))
        f.write(cells.tobytes())
        f.write(b"\nCELL_TYPES %d\n" % n_cells)
        f.write(np.full(n_cells, _CELL_TYPES[kind], dtype=">i4").tobytes())
        f.write(b"\n")


def read_vtk(path: str):
    """Read back a legacy unstructured grid (vertices, conn), ASCII or BINARY."""
    with open(path, "rb") as f:
        raw = f.read()
    if b"\nBINARY\n" in raw[:64]:
        return _read_vtk_binary(raw)
    lines = raw.decode().split("\n")
    i = 0
    verts = []
    cells = []
    while i < len(lines):
        line = lines[i]
        if line.startswith("POINTS"):
            n = int(line.split()[1])
            vals = []
            i += 1
            while len(vals) < 3 * n:
                vals += [float(x) for x in lines[i].split()]
                i += 1
            verts = np.asarray(vals).reshape(n, 3)
            continue
        if line.startswith("CELLS"):
            n = int(line.split()[1])
            for j in range(n):
                i += 1
                parts = [int(x) for x in lines[i].split()]
                cells.append(parts[1:])
        i += 1
    return np.asarray(verts), np.asarray(cells, dtype=np.int64)


def _read_vtk_binary(raw: bytes):
    """Parse the binary legacy layout (big-endian payloads)."""
    pos = raw.index(b"POINTS")
    hdr_end = raw.index(b"\n", pos)
    n_pts = int(raw[pos:hdr_end].split()[1])
    start = hdr_end + 1
    verts = np.frombuffer(raw, dtype=">f8", count=3 * n_pts,
                          offset=start).reshape(n_pts, 3).astype(np.float64)
    pos = raw.index(b"CELLS", start + 24 * n_pts)
    hdr_end = raw.index(b"\n", pos)
    parts = raw[pos:hdr_end].split()
    n_cells, n_ints = int(parts[1]), int(parts[2])
    start = hdr_end + 1
    flat = np.frombuffer(raw, dtype=">i4", count=n_ints, offset=start)
    arity = int(flat[0]) if n_ints else 0
    cells = flat.reshape(n_cells, arity + 1)[:, 1:].astype(np.int64)
    return verts, cells
