"""Deformable mesh frame output.

Port of `stark_tpu/models/deformables/output.py`
(DeformablesMeshOutput.cpp:6-67): registered point, segment, triangle and
tet output groups, written as VTK files named
`{output_dir}/{sim}_{label}_{frame}.vtk` on the write_frame callback, from
one host copy of the positions per frame.
"""
from __future__ import annotations

import numpy as np

from ...utils import vtk


class DeformablesMeshOutput:
    def __init__(self, stark, dyn):
        self.stark = stark
        self.dyn = dyn
        self.groups = []  # (label, kind, global_conn)
        stark.callbacks.add_write_frame(self._write_frame)

    def _add(self, label, kind, set_, conn, point_set_map=None):
        conn = np.asarray(conn, dtype=np.int64)
        if point_set_map is not None:
            conn = np.asarray(point_set_map, dtype=np.int64)[conn]
        gconn = set_.get_global_indices(conn) if conn.size else conn
        self.groups.append((label, kind, gconn))

    def add_point_set(self, label, set_, points=None):
        idx = np.arange(set_.size()) if points is None else np.asarray(points)
        self._add(label, "points", set_, idx.reshape(-1, 1))

    def add_segment_mesh(self, label, set_, segments, point_set_map=None):
        self._add(label, "segments", set_, segments, point_set_map)

    def add_triangle_mesh(self, label, set_, triangles, point_set_map=None):
        self._add(label, "triangles", set_, triangles, point_set_map)

    def add_tet_mesh(self, label, set_, tets, point_set_map=None):
        self._add(label, "tets", set_, tets, point_set_map)

    def _write_frame(self):
        if not self.groups or not self.stark.settings.output.output_directory:
            return
        x = self.dyn.host_x_all()
        for label, kind, gconn in self.groups:
            path = self.stark.get_frame_path(label) + ".vtk"
            verts_idx, local = np.unique(gconn.reshape(-1), return_inverse=True)
            vtk.write_vtk(path, x[verts_idx], local.reshape(gconn.shape), kind)
