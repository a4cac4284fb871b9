"""Host-side mesh topology and transformation utilities (numpy).

Reference: stark/src/utils/mesh_utils.{h,cpp} — edge
extraction, internal-angle (dihedral) discovery, perimeter edges, tet surface
extraction, connectivity reduction, and point-cloud transformations.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np


def deg2rad(deg: float) -> float:
    return deg * math.pi / 180.0


def rad2deg(rad: float) -> float:
    return rad * 180.0 / math.pi


def find_edges_from_simplices(simplices, n_nodes: int) -> np.ndarray:
    """Unique sorted edges of a simplex mesh in first-occurrence order
    (mesh_utils.h find_edges_from_simplices; the same order as the JAX
    package's native `sn_find_edges`)."""
    simplices = np.asarray(simplices, dtype=np.int64)
    if simplices.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    k = simplices.shape[1]
    seen = set()
    out = []
    for s in simplices.tolist():
        for i in range(k):
            for j in range(i + 1, k):
                e = (min(s[i], s[j]), max(s[i], s[j]))
                if e not in seen:
                    seen.add(e)
                    out.append(e)
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def find_internal_angles(triangles, n_nodes: int) -> np.ndarray:
    """Internal edges with their two wing vertices [lo, hi, wing_a, wing_b]
    (mesh_utils.cpp:217-253), one row per edge in the order its SECOND
    incident triangle is visited; wing_a comes from the first triangle. This
    is the row order of the JAX package's native `sn_find_internal_edges`, so
    both packages build identical bending tables."""
    triangles = np.asarray(triangles, dtype=np.int64)
    if triangles.size == 0:
        return np.zeros((0, 4), dtype=np.int64)
    first = {}
    out = []
    for v in triangles.tolist():
        for i in range(3):
            a, b, w = v[i], v[(i + 1) % 3], v[(i + 2) % 3]
            key = (min(a, b), max(a, b))
            if key in first:
                out.append([key[0], key[1], first[key], w])
            else:
                first[key] = w
    return np.asarray(out, dtype=np.int64).reshape(-1, 4)


def reduce_connectivity(conn, n_nodes: int):
    """Renumber referenced nodes compactly; returns (new_conn, new_to_old_map)
    (mesh_utils.h reduce_connectivity)."""
    conn = np.asarray(conn, dtype=np.int64)
    old_to_new = -np.ones(n_nodes, dtype=np.int64)
    new_to_old = []
    new_conn = np.empty_like(conn)
    for e_i, elem in enumerate(conn):
        for k, v in enumerate(elem):
            if old_to_new[v] == -1:
                old_to_new[v] = len(new_to_old)
                new_to_old.append(int(v))
            new_conn[e_i, k] = old_to_new[v]
    return new_conn, np.asarray(new_to_old, dtype=np.int64)


def apply_map(conn, node_map):
    conn = np.asarray(conn, dtype=np.int64)
    node_map = np.asarray(node_map, dtype=np.int64)
    return node_map[conn]


def find_perimeter_edges(triangles, n_nodes: int):
    """Edges incident to exactly one triangle (mesh_utils.cpp:254-276);
    returns (edges_in_reduced_numbering, edge_to_triangle_node_map)."""
    triangles = np.asarray(triangles, dtype=np.int64)
    count = defaultdict(int)
    for t in triangles:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            count[(min(t[a], t[b]), max(t[a], t[b]))] += 1
    per = np.asarray([e for e, c in count.items() if c == 1], dtype=np.int64).reshape(-1, 2)
    return reduce_connectivity(per, n_nodes)


def gather(data, indices):
    return np.asarray(data)[np.asarray(indices, dtype=np.int64)]


def find_sharp_edges(vertices, triangles, angle_deg_threshold: float):
    """Edges whose incident triangles' dihedral angle deviates from flat by
    more than the threshold (mesh_utils.cpp find_sharp_edges). Returns
    (edges_in_reduced_numbering, new_to_old_map)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    internal = find_internal_angles(triangles, len(vertices))
    sharp = []
    thr = math.cos(deg2rad(angle_deg_threshold))
    for i, j, k, l in internal:
        e0 = vertices[j] - vertices[i]
        n0 = np.cross(e0, vertices[k] - vertices[i])
        n1 = -np.cross(e0, vertices[l] - vertices[i])
        c = np.dot(n0, n1) / max(np.linalg.norm(n0) * np.linalg.norm(n1), 1e-300)
        # angle between normals > threshold -> crease
        if c < thr:
            sharp.append([i, j])
    # boundary (perimeter) edges are sharp too
    count = defaultdict(int)
    for t in triangles:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            count[(min(t[a], t[b]), max(t[a], t[b]))] += 1
    for e, c in count.items():
        if c == 1:
            sharp.append(list(e))
    sharp = np.asarray(sharp, dtype=np.int64).reshape(-1, 2)
    return reduce_connectivity(sharp, len(vertices))


def triangle_normal(p0, p1, p2):
    n = np.cross(p1 - p0, p2 - p0)
    return n / np.linalg.norm(n)


def triangle_area(p0, p1, p2) -> float:
    return 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0))


def signed_tetra_volume(p0, p1, p2, p3) -> float:
    return float(np.dot(np.cross(p1 - p0, p2 - p0), p3 - p0)) / 6.0


def unsigned_tetra_volume(p0, p1, p2, p3) -> float:
    return abs(signed_tetra_volume(p0, p1, p2, p3))


def total_volume(vertices, tets) -> float:
    vertices = np.asarray(vertices)
    tets = np.asarray(tets, dtype=np.int64)
    v = vertices[tets]
    return float(np.abs(np.einsum(
        "ij,ij->i", np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), v[:, 3] - v[:, 0])).sum() / 6.0)


def find_surface(vertices, tets):
    """Boundary triangles of a tet mesh, outward winding, reduced numbering
    (mesh_utils.cpp:278-327). Returns (triangles, triangle_to_tet_node_map)."""
    vertices = np.asarray(vertices)
    tets = np.asarray(tets, dtype=np.int64)
    face_map = {}
    for tet_i, tet in enumerate(tets):
        for face in ((tet[0], tet[1], tet[2]), (tet[0], tet[1], tet[3]),
                     (tet[0], tet[2], tet[3]), (tet[1], tet[2], tet[3])):
            key = tuple(sorted(int(x) for x in face))
            if key in face_map:
                del face_map[key]
            else:
                face_map[key] = tet_i
    unique_triangles = []
    for face, tet_i in face_map.items():
        face = list(face)
        tet = tets[tet_i]
        center = vertices[tet].mean(axis=0)
        n = np.cross(vertices[face[1]] - vertices[face[0]],
                     vertices[face[2]] - vertices[face[0]])
        # flip so the normal points away from the tet center
        if np.dot(n, center - vertices[face[0]]) > 0.0:
            face[0], face[1] = face[1], face[0]
        unique_triangles.append(face)
    unique_triangles = np.asarray(unique_triangles, dtype=np.int64).reshape(-1, 3)
    return reduce_connectivity(unique_triangles, len(vertices))


def clean_triangle_mesh(vertices, triangles, merge_by_distance: float = 0.0):
    """Merge near-duplicate vertices and drop degenerate triangles
    (mesh_utils.cpp clean_triangle_mesh)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    if merge_by_distance > 0.0 and len(vertices) > 0:
        keys = np.round(vertices / merge_by_distance).astype(np.int64)
        _, first_idx, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
        new_vertices = vertices[first_idx]
        triangles = inv[triangles]
        vertices = new_vertices
    ok = ((triangles[:, 0] != triangles[:, 1]) & (triangles[:, 1] != triangles[:, 2])
          & (triangles[:, 0] != triangles[:, 2]))
    triangles = triangles[ok]
    conn, new_to_old = reduce_connectivity(triangles, len(vertices))
    return vertices[new_to_old], conn


def compute_node_normals(vertices, triangles):
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles, dtype=np.int64)
    normals = np.zeros_like(vertices)
    fn = np.cross(vertices[triangles[:, 1]] - vertices[triangles[:, 0]],
                  vertices[triangles[:, 2]] - vertices[triangles[:, 0]])
    for k in range(3):
        np.add.at(normals, triangles[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens[lens == 0] = 1.0
    return normals / lens


# -- point cloud transformations (mesh_utils.cpp Transformations) --

def center(points):
    points = np.asarray(points, dtype=np.float64)
    return points - 0.5 * (points.min(axis=0) + points.max(axis=0))


def normalize_size(points, length: float = 1.0):
    points = center(points)
    extent = (points.max(axis=0) - points.min(axis=0)).max()
    return points * (length / extent)


def move(points, translation):
    return np.asarray(points, dtype=np.float64) + np.asarray(translation)


def rotate_deg(points, angle: float, axis, pivot=None):
    from ..maths import axis_angle_rotation

    R = axis_angle_rotation(deg2rad(angle), axis)
    points = np.asarray(points, dtype=np.float64)
    if pivot is None:
        return points @ R.T
    pivot = np.asarray(pivot)
    return (points - pivot) @ R.T + pivot


def scale(points, s):
    return np.asarray(points, dtype=np.float64) * np.asarray(s)


def mirror(points, dim: int, pivot: float = 0.0):
    points = np.asarray(points, dtype=np.float64).copy()
    points[:, dim] = 2.0 * pivot - points[:, dim]
    return points


def rcm_order(edges, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new -> old) of an undirected edge
    list (symx mesh_ordering.h:5-33). Seeds and neighbours are visited by
    ascending degree with ties kept in index/adjacency order (a stable
    sort), which is what the JAX package's native sn_rcm_order produces for
    the small rigid meshes it orders (std::sort is an insertion sort below
    17 elements)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    adj = [[] for _ in range(n_nodes)]
    for a, b in edges.tolist():
        if a == b:
            continue
        adj[a].append(b)
        adj[b].append(a)
    degree = [len(x) for x in adj]
    visited = [False] * n_nodes
    order = []
    by_degree = sorted(range(n_nodes), key=lambda i: degree[i])
    seed_pos = 0
    while len(order) < n_nodes:
        while seed_pos < n_nodes and visited[by_degree[seed_pos]]:
            seed_pos += 1
        if seed_pos >= n_nodes:
            break
        seed = by_degree[seed_pos]
        visited[seed] = True
        head = len(order)
        order.append(seed)
        while head < len(order):
            u = order[head]
            head += 1
            for v in sorted((v for v in adj[u] if not visited[v]),
                            key=lambda i: degree[i]):
                if not visited[v]:
                    visited[v] = True
                    order.append(v)
    return np.asarray(order[::-1], dtype=np.int64)
