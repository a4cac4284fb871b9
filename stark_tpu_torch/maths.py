"""Small differentiable math helpers used by the deformable energy models.

Port of `stark_tpu/maths.py`, limited to what the lumped-inertia,
prescribed-positions, triangle-strain and discrete-shells families use.

NaN-safety conventions: `torch.where` evaluates BOTH branches, and under
`torch.func` the gradient of an unselected NaN/Inf branch poisons the result
(0*NaN=NaN), exactly as with JAX. Every potentially-singular expression
therefore keeps the "double where" / clamped-argument guards of the JAX
package so that both value and all derivative orders stay finite.
"""
from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-12


def safe_sqrt(x, eps: float = EPSILON):
    """sqrt with finite gradient at 0 (clamps the argument away from 0)."""
    return torch.sqrt(torch.clamp_min(x, eps))


def safe_norm(v, eps: float = EPSILON):
    """Euclidean norm with finite gradients at v=0."""
    return safe_sqrt(torch.sum(v * v), eps)


def normalized(v, eps: float = EPSILON):
    return v / safe_norm(v, eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def dot(a, b):
    return torch.sum(a * b)


def cubic_one_sided(x, stiffness):
    """One-sided cubic penalty: stiffness*x^3/3 for x>0, else 0.
    Polynomial, so both branches are smooth -> plain where is
    derivative-safe."""
    return torch.where(x > 0.0, stiffness * x * x * x / 3.0, torch.zeros_like(x))


def dihedral_angle(x0, x1, x2, x3, eps: float = None):
    """Dihedral angle across edge (x0,x1) with wing vertices x2, x3:
    acos((1-eps) * n0.hat . n1.hat) with n0 = e0 x e1, n1 = -e0 x e2. The
    (1-eps) factor keeps acos differentiable at +-1; eps is dtype-aware
    because the f64 1e-12 rounds (1-eps) to exactly 1.0 in float32."""
    e0 = x1 - x0
    e1 = x2 - x0
    e2 = x3 - x0
    n0 = cross(e0, e1)
    n1 = -cross(e0, e2)
    c = dot(normalized(n0), normalized(n1))
    if eps is None:
        eps = 100.0 * float(torch.finfo(c.dtype).eps)
    return torch.arccos((1.0 - eps) * c)


def axis_angle_rotation(angle_rad, axis):
    """Host-side Rodrigues rotation matrix (numpy)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(angle_rad) * K + (1 - np.cos(angle_rad)) * (K @ K)


def eigenvalues_sym_2x2(M):
    """Closed-form eigenvalues of a symmetric 2x2 (triangle strain limiting)."""
    a, b, d = M[0, 0], M[0, 1], M[1, 1]
    mean = 0.5 * (a + d)
    disc = safe_sqrt(0.25 * (a - d) * (a - d) + b * b)
    return mean - disc, mean + disc
