"""Minimal OBJ mesh load/save: a copy of `stark_tpu/utils/obj.py` (upstream
bundles tinyobjloader; mesh_utils.h load_obj). The same numbers give the
same bytes as the JAX package's `save_obj`."""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns a list of (vertices, triangles) per object in the file.
    Polygons are fan-triangulated; only v/f records are used."""
    meshes = []
    verts = []
    faces = []

    def flush():
        if faces:
            V = np.asarray(verts, dtype=np.float64)
            F = np.asarray(faces, dtype=np.int64)
            used = np.unique(F.reshape(-1))
            remap = -np.ones(len(V), dtype=np.int64)
            remap[used] = np.arange(len(used))
            meshes.append((V[used], remap[F]))

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "o" or parts[0] == "g":
                flush()
                faces = []
            elif parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    flush()
    return meshes


def save_obj(path: str, vertices, triangles):
    vertices = np.asarray(vertices, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in triangles:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
