"""Small differentiable math helpers used by the energy models.

Port of `stark_tpu/maths.py`, limited to what the deformable families, the
rigid-body inertia and constraint families and the contact families use
(the quaternion kinematics of rigid bodies included), and the scalar
easing of scripted scenes (`blend`).

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
    """One-sided cubic penalty: stiffness*x^3/3 for x>0, else 0. The cubic
    reads x clamped at 0 (the "double where"): with the providers' "no
    limit" of 1e30 the unselected branch's float32 derivative is inf, and
    0 * inf would make the gradient NaN (JAX's single where does that); the
    values and every derivative are otherwise the same."""
    pos = x > 0.0
    xp = torch.where(pos, x, torch.zeros_like(x))
    return torch.where(pos, stiffness * xp * xp * xp / 3.0, torch.zeros_like(x))


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


def sq_norm(v):
    return torch.sum(v * v)


# ----------------------------------------------------------------------------
# Quaternions (w, x, y, z): rigid-body kinematics
# (rigidbody_transformations.cpp; stark_tpu/maths.py:89-142)
# ----------------------------------------------------------------------------
def quat_mul(q1, q2):
    """Hamilton product, (w, x, y, z), as L(q1) @ q2: the same products as
    the component formula summed in another order. Under torch.func's
    hessian of a vmapped energy the component form (16 products of 0-d
    selects) costs 2-4x more host time than one 4x4 matvec."""
    a, b, c, d = torch.unbind(q1)
    L = torch.stack([torch.stack([a, -b, -c, -d]), torch.stack([b, a, -d, c]),
                     torch.stack([c, d, a, -b]), torch.stack([d, -c, b, a])])
    return L @ q2


def quat_to_rotation(q):
    """Rotation matrix of a unit quaternion."""
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    # x + x == 2x exactly; torch.func's hessian of `2.0 * x` on a 0-d
    # float32 tensor yields a float64 tangent (torch 2.x)
    tx, ty, tz = qx + qx, qy + qy, qz + qz
    twx, twy, twz = tx * qw, ty * qw, tz * qw
    txx, txy, txz = tx * qx, ty * qx, tz * qx
    tyy, tyz = ty * qy, tz * qy
    tzz = tz * qz
    return torch.stack([
        torch.stack([1.0 - (tyy + tzz), txy - twz, txz + twy]),
        torch.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx]),
        torch.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)]),
    ])


def quat_time_integration(q0, w_glob, dt):
    """q1 = normalize(q0 + 0.5*dt*(w*q0)): the first-order quaternion update,
    differentiable with respect to w_glob."""
    w_ = torch.stack([torch.zeros_like(w_glob[0]), w_glob[0], w_glob[1], w_glob[2]])
    q1 = q0 + 0.5 * dt * quat_mul(w_, q0)
    return q1 / safe_norm(q1)


def quat_integration_rotation(q0, w_glob, dt):
    """R1 = R(quat_time_integration(q0, w1, dt))."""
    return quat_to_rotation(quat_time_integration(q0, w_glob, dt))


def integrate_loc_point(p_loc, t0, q0, v1, w1, dt):
    """x1 of a body-local point under next-step velocities."""
    return t0 + dt * v1 + quat_integration_rotation(q0, w1, dt) @ p_loc


def integrate_loc_direction(d_loc, q0, w1, dt):
    """d1 of a body-local direction under next-step angular velocity."""
    return quat_integration_rotation(q0, w1, dt) @ d_loc


def np_quat_mul(q1, q2):
    """Hamilton product on the host, batched (..., 4)."""
    a, b, c, d = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    e, f, g, h = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        a * e - b * f - c * g - d * h,
        b * e + a * f + c * h - d * g,
        a * g - b * h + c * e + d * f,
        a * h + b * g - c * f + d * e,
    ], axis=-1)


def np_quat_to_rotation(q):
    """Rotation matrices of unit quaternions on the host, (..., 4) ->
    (..., 3, 3)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2.0 * qx, 2.0 * qy, 2.0 * qz
    twx, twy, twz = tx * qw, ty * qw, tz * qw
    txx, txy, txz = tx * qx, ty * qx, tz * qx
    tyy, tyz = ty * qy, tz * qy
    tzz = tz * qz
    one = np.ones_like(qw)
    R = np.stack([
        one - (tyy + tzz), txy - twz, txz + twy,
        txy + twz, one - (txx + tzz), tyz - twx,
        txz - twy, tyz + twx, one - (txx + tyy),
    ], axis=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def np_quat_time_integration(q0, w_glob, dt):
    """Host quaternion update, batched (..., 4) / (..., 3)."""
    z = np.zeros_like(w_glob[..., :1])
    q1 = q0 + 0.5 * dt * np_quat_mul(np.concatenate([z, w_glob], axis=-1), q0)
    return q1 / np.linalg.norm(q1, axis=-1, keepdims=True)


def rotation_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z) on the host."""
    R = np.asarray(R)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w, x = 0.25 * s, (R[2, 1] - R[1, 2]) / s
        y, z = (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w, x = (R[2, 1] - R[1, 2]) / s, 0.25 * s
        y, z = (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w, x = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s
        y, z = 0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w, x = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s
        y, z = (R[1, 2] + R[2, 1]) / s, 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def blend(begin_value, end_value, begin_time, end_time, t, blend_type="linear"):
    """Scalar easing used by scripted animations (reference utils/blends.h)."""
    if t <= begin_time:
        return begin_value
    if t >= end_time:
        return end_value
    s = (t - begin_time) / (end_time - begin_time)
    if blend_type == "linear":
        w = s
    elif blend_type == "ease_in_out":
        w = 0.5 - 0.5 * np.cos(np.pi * s)
    elif blend_type == "instant":
        w = 1.0
    else:
        raise ValueError(f"unknown blend type {blend_type}")
    return begin_value + (end_value - begin_value) * w
