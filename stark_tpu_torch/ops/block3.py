"""Kernel D: 3x3 block-Jacobi inverse and apply (csrc/block3.cu) and twins.

Replaces stark_tpu/solver/assembly.py `precondition_inverse` (:876-903),
the closed-form adjugate inverse with identity fallback when
|det| <= eps, and `apply_preconditioner` (:906-908).
"""
from __future__ import annotations

import torch

from . import build


def block3_inverse_plain(D: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Plain PyTorch twin of the symmetric 3x3 cofactor inverse."""
    a, b, c = D[:, 0, 0], D[:, 0, 1], D[:, 0, 2]
    e, f = D[:, 1, 1], D[:, 1, 2]
    i = D[:, 2, 2]
    A = e * i - f * f
    B = c * f - b * i
    C = b * f - c * e
    det = a * A + b * B + c * C
    E2 = a * i - c * c
    F = b * c - a * f
    I2 = a * e - b * b
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([B, E2, F], -1),
        torch.stack([C, F, I2], -1),
    ], -2)
    ok = torch.abs(det) > eps
    eye = torch.eye(3, dtype=D.dtype, device=D.device).expand(D.shape)
    inv = adj / torch.where(ok, det, torch.ones_like(det))[:, None, None]
    return torch.where(ok[:, None, None], inv, eye)


def block3_apply_plain(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bij,bj->bi", Dinv, r)


def block3_inverse(D: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """(n, 3, 3) symmetric blocks -> their inverses (identity if singular)."""
    if D.dim() != 3 or D.shape[1:] != (3, 3):
        raise ValueError(f"block3_inverse: expected (n, 3, 3), got {tuple(D.shape)}")
    if D.device.type == "cpu":
        return block3_inverse_plain(D, eps)
    build.require_cuda("block3_inverse", D)
    fn = build.entry("stk_block3_inverse", D.dtype)
    out = torch.empty_like(D)
    rc = fn(D.data_ptr(), D.shape[0], float(eps), out.data_ptr(),
            build.stream_ptr(D.device))
    build.check_status("block3_inverse", rc)
    build.count_launch("block3_inverse")
    return out


def block3_apply(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z_b = Dinv_b r_b for every block b."""
    n = Dinv.shape[0]
    if Dinv.shape != (n, 3, 3) or r.shape != (n, 3):
        raise ValueError("block3_apply: inconsistent shapes")
    if r.device.type == "cpu":
        return block3_apply_plain(Dinv, r)
    build.require_cuda("block3_apply", Dinv, r)
    if Dinv.dtype != r.dtype:
        raise TypeError("block3_apply: dtypes differ")
    fn = build.entry("stk_block3_apply", r.dtype)
    out = torch.empty_like(r)
    rc = fn(Dinv.data_ptr(), r.data_ptr(), n, out.data_ptr(),
            build.stream_ptr(r.device))
    build.check_status("block3_apply", rc)
    build.count_launch("block3_apply")
    return out
