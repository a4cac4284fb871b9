"""Analytic local inertia tensors for primitive shapes.

A copy of `stark_tpu/models/rigidbodies/inertia_tensors.py` (pure numpy;
the reference's inertia_tensors.h).
"""
from __future__ import annotations

import numpy as np


def inertia_tensor_box(mass: float, size) -> np.ndarray:
    if np.isscalar(size):
        size = (size, size, size)
    sx, sy, sz = size
    return np.diag([
        mass / 12.0 * (sy * sy + sz * sz),
        mass / 12.0 * (sx * sx + sz * sz),
        mass / 12.0 * (sx * sx + sy * sy),
    ])


def inertia_tensor_sphere(mass: float, radius: float) -> np.ndarray:
    return np.eye(3) * (2.0 / 5.0 * mass * radius * radius)


def inertia_tensor_cylinder(mass: float, radius: float, full_height: float) -> np.ndarray:
    # axis along z
    ixy = mass / 12.0 * (3.0 * radius * radius + full_height * full_height)
    iz = 0.5 * mass * radius * radius
    return np.diag([ixy, ixy, iz])


def inertia_tensor_torus(mass: float, outer_radius: float, inner_radius: float) -> np.ndarray:
    # ring around z; R = outer (ring) radius, r = inner (tube) radius
    R, r = outer_radius, inner_radius
    ixy = mass * (4.0 * R * R + 5.0 * r * r) / 8.0
    iz = mass * (R * R + 3.0 / 4.0 * r * r)
    return np.diag([ixy, ixy, iz])


def inertia_tensor_from_triangle_mesh(vertices, triangles, mass: float):
    """Inertia tensor of a closed triangle mesh (uniform density, scaled to
    `mass`), plus center of mass and volume. Divergence-theorem accumulation
    as in the reference's RigidBodyPresets mesh path."""
    V = np.asarray(vertices, dtype=np.float64)
    T = np.asarray(triangles, dtype=np.int64)
    a, b, c = V[T[:, 0]], V[T[:, 1]], V[T[:, 2]]
    det = np.einsum("ij,ij->i", np.cross(a, b), c)  # 6*signed tet volume w/ origin
    vol = det.sum() / 6.0
    com = ((a + b + c + 0.0) / 4.0 * det[:, None]).sum(axis=0) / (24.0 * vol / 4.0) \
        if vol != 0 else np.zeros(3)
    com = (det[:, None] * (a + b + c) / 4.0).sum(axis=0) / (6.0 * vol)

    # canonical tetrahedron covariance trick
    Ccov = np.zeros((3, 3))
    for i in range(len(T)):
        v = np.stack([a[i], b[i], c[i]])
        Acov = (v.T @ v + np.outer(v.sum(0), v.sum(0))) / 20.0
        Ccov += det[i] * Acov
    Ccov /= 6.0
    density = mass / vol
    Ccov *= density
    # shift to center of mass
    Ccov -= mass * np.outer(com, com)
    I = np.eye(3) * np.trace(Ccov) - Ccov
    return I, com, vol
