"""Parametric mesh generators (host-side numpy).

Reference: stark/src/utils/mesh_generators.{h,cpp} — grids,
lines, and par_shapes-derived primitives (sphere/box/cylinder/torus). The
primitives here are original parametric constructions with the same API
surface; exact vertex layouts differ (only topology/shape semantics matter).
Returns (vertices (n,3) float64, connectivity (m,k) int64) tuples.
"""
from __future__ import annotations

import math

import numpy as np


def generate_triangle_grid(center, dimensions, n_quads_per_dim, z: float = 0.0):
    """Regular triangulated rectangle in the XY plane, bit-exact replica of
    the reference generator (mesh_generators.cpp:100-167): y-fastest vertex
    order (idx = ny*i + j), per-quad diagonal alternated by ei%2 == ej%2 —
    identical ordering and topology are required by the golden-trajectory
    parity tests (tests/test_trajectory_parity.py compares BY INDEX)."""
    cx, cy = center
    dx, dy = dimensions
    nqx, nqy = n_quads_per_dim
    nx, ny = nqx + 1, nqy + 1
    bx, by = cx - dx / 2.0, cy - dy / 2.0
    sx, sy = dx / nqx, dy / nqy
    V = np.empty((nx * ny, 3), dtype=np.float64)
    for i in range(nx):
        for j in range(ny):
            V[ny * i + j] = (bx + i * sx, by + j * sy, z)
    tris = []
    for ei in range(nqx):
        for ej in range(nqy):
            n0 = ny * ei + ej
            n1 = ny * ei + ej + 1
            n2 = ny * (ei + 1) + ej
            n3 = ny * (ei + 1) + ej + 1
            if ei % 2 == ej % 2:
                tris += [[n0, n2, n3], [n0, n3, n1]]
            else:
                tris += [[n0, n2, n1], [n2, n3, n1]]
    return V, np.asarray(tris, dtype=np.int64)


def generate_segment_line(begin, end, n_segments: int):
    begin = np.asarray(begin, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    t = np.linspace(0.0, 1.0, n_segments + 1)[:, None]
    V = begin[None, :] * (1 - t) + end[None, :] * t
    E = np.stack([np.arange(n_segments), np.arange(1, n_segments + 1)], axis=1)
    return V, E.astype(np.int64)


def generate_tet_grid(center, dimensions, n_quads_per_dim):
    """Regular box tetrahedralization: each cell split into 5 tets with
    alternating parity for conformity (mesh_generators.cpp:264-380)."""
    c = np.asarray(center, dtype=np.float64)
    d = np.asarray(dimensions, dtype=np.float64)
    n = np.asarray(n_quads_per_dim, dtype=np.int64)
    axes = [np.linspace(c[k] - d[k] / 2, c[k] + d[k] / 2, n[k] + 1) for k in range(3)]
    nxv, nyv, nzv = n[0] + 1, n[1] + 1, n[2] + 1
    V = np.array([[x, y, z] for z in axes[2] for y in axes[1] for x in axes[0]])

    def vid(i, j, k):
        return (k * nyv + j) * nxv + i

    tets = []
    for k in range(n[2]):
        for j in range(n[1]):
            for i in range(n[0]):
                v = [vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k), vid(i + 1, j + 1, k),
                     vid(i, j, k + 1), vid(i + 1, j, k + 1), vid(i, j + 1, k + 1),
                     vid(i + 1, j + 1, k + 1)]
                if (i + j + k) % 2 == 0:
                    cells = [(0, 1, 3, 5), (0, 3, 2, 6), (0, 5, 6, 4), (3, 6, 5, 7), (0, 3, 6, 5)]
                else:
                    cells = [(1, 2, 0, 4), (1, 7, 3, 2), (1, 4, 7, 5), (2, 7, 4, 6), (1, 2, 7, 4)]
                for t in cells:
                    tets.append([v[t[0]], v[t[1]], v[t[2]], v[t[3]]])
    tets = np.asarray(tets, dtype=np.int64)
    # fix orientation: positive signed volume
    p = V[tets]
    vol = np.einsum("ij,ij->i", np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), p[:, 3] - p[:, 0])
    flip = vol < 0
    tets[flip, 0], tets[flip, 1] = tets[flip, 1].copy(), tets[flip, 0].copy()
    return V, tets


def make_box(size, lid: bool = True):
    """Triangulated box surface (mesh_generators.cpp:34-61)."""
    if np.isscalar(size):
        size = (size, size, size)
    sx, sy, sz = (s / 2 for s in size)
    V = np.array([
        [-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
        [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz],
    ])
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6), (1, 2, 6, 5)]
    if lid:
        quads.append((3, 0, 4, 7))
    tris = []
    for a, b, c, d in quads:
        tris += [[a, b, c], [a, c, d]]
    return V, np.asarray(tris, dtype=np.int64)


def make_sphere(radius: float, subdivisions: int = 2):
    """Icosphere (reference uses par_shapes_create_subdivided_sphere)."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    V = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float64)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    F = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdivisions):
        mid_cache = {}
        verts = list(V)
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid_cache:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                mid_cache[key] = len(verts)
                verts.append(m)
            return mid_cache[key]

        for a, b, c in F:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        V = np.asarray(verts)
        F = np.asarray(new_faces, dtype=np.int64)
    return V * radius, F


def make_cylinder(radius: float, full_height: float, slices: int = 16, stacks: int = 1):
    """Closed triangulated cylinder along Z, centered at origin."""
    angles = np.linspace(0, 2 * math.pi, slices, endpoint=False)
    zs = np.linspace(-full_height / 2, full_height / 2, stacks + 1)
    ring = np.stack([radius * np.cos(angles), radius * np.sin(angles)], axis=1)
    verts = [np.array([0.0, 0.0, zs[0]]), np.array([0.0, 0.0, zs[-1]])]
    for z in zs:
        for xy in ring:
            verts.append(np.array([xy[0], xy[1], z]))
    V = np.asarray(verts)
    tris = []

    def rid(s, i):
        return 2 + s * slices + (i % slices)

    for i in range(slices):  # caps
        tris.append([0, rid(0, i + 1), rid(0, i)])
        tris.append([1, rid(stacks, i), rid(stacks, i + 1)])
    for s in range(stacks):  # side
        for i in range(slices):
            a, b = rid(s, i), rid(s, i + 1)
            c, d = rid(s + 1, i), rid(s + 1, i + 1)
            tris += [[a, b, d], [a, d, c]]
    return V, np.asarray(tris, dtype=np.int64)


def make_torus(outer_radius: float, inner_radius: float, slices: int = 32, stacks: int = 8):
    """Torus around the Z axis: ring radius = outer, tube radius = inner."""
    verts = []
    for i in range(slices):
        u = 2 * math.pi * i / slices
        for j in range(stacks):
            v = 2 * math.pi * j / stacks
            x = (outer_radius + inner_radius * math.cos(v)) * math.cos(u)
            y = (outer_radius + inner_radius * math.cos(v)) * math.sin(u)
            z = inner_radius * math.sin(v)
            verts.append([x, y, z])
    V = np.asarray(verts)
    tris = []
    for i in range(slices):
        for j in range(stacks):
            a = i * stacks + j
            b = i * stacks + (j + 1) % stacks
            c = ((i + 1) % slices) * stacks + j
            d = ((i + 1) % slices) * stacks + (j + 1) % stacks
            tris += [[a, b, d], [a, d, c]]
    return V, np.asarray(tris, dtype=np.int64)


def make_knot(size: float, inner_radius: float, slices: int = 32, stacks: int = 8):
    """Trefoil knot tube mesh (reference make_knot via par_shapes)."""
    centers = []
    n = slices * 4
    for i in range(n):
        t = 2 * math.pi * i / n
        x = math.sin(t) + 2 * math.sin(2 * t)
        y = math.cos(t) - 2 * math.cos(2 * t)
        z = -math.sin(3 * t)
        centers.append(np.array([x, y, z]) * size / 3.0)
    centers = np.asarray(centers)
    verts = []
    for i in range(n):
        t0 = centers[i]
        tangent = centers[(i + 1) % n] - centers[i - 1]
        tangent /= np.linalg.norm(tangent)
        ref = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(ref, tangent)) > 0.9:
            ref = np.array([1.0, 0.0, 0.0])
        b1 = np.cross(tangent, ref)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(tangent, b1)
        for j in range(stacks):
            a = 2 * math.pi * j / stacks
            verts.append(t0 + inner_radius * (math.cos(a) * b1 + math.sin(a) * b2))
    V = np.asarray(verts)
    tris = []
    for i in range(n):
        for j in range(stacks):
            a = i * stacks + j
            b = i * stacks + (j + 1) % stacks
            c = ((i + 1) % n) * stacks + j
            d = ((i + 1) % n) * stacks + (j + 1) % stacks
            tris += [[a, b, d], [a, d, c]]
    return V, np.asarray(tris, dtype=np.int64)


def generate_cylindrical_triangle_mesh(radius: float, height: float, n_quads_per_dim):
    """Open cylindrical shell grid (mesh_generators.cpp:174-256)."""
    n_around, n_up = n_quads_per_dim
    angles = np.linspace(0, 2 * math.pi, n_around, endpoint=False)
    zs = np.linspace(0.0, height, n_up + 1)
    V = np.array([[radius * math.cos(a), radius * math.sin(a), z] for z in zs for a in angles])
    tris = []
    for s in range(n_up):
        for i in range(n_around):
            a = s * n_around + i
            b = s * n_around + (i + 1) % n_around
            c = (s + 1) * n_around + i
            d = (s + 1) * n_around + (i + 1) % n_around
            tris += [[a, b, d], [a, d, c]]
    return V, np.asarray(tris, dtype=np.int64)
