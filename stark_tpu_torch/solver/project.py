"""Projection of element Hessians to positive definiteness.

Port of `stark_tpu/solver/project.py`: per-element symmetric
eigendecomposition, eigenvalues below eps clamped to eps or mirrored to
-lambda, and the matrix rebuilt (project_to_PD.cpp:12-48). The batched
eigensolve and rebuild are kernel C (`ops.pd_project`, parallel-order
cyclic Jacobi; `pd_project_wide` for 16 < d <= 64); its plain twin —
`_jacobi_eigh`, or exact `torch.linalg.eigh` when `jacobi_sweeps=0` or
d <= 3, as stark_tpu/solver/project.py:116-119 does — is the CPU path. On
the card JAX's exact-eigh branch (`jacobi_sweeps=0`, every d <= 3) runs
kernel Z, Jacobi to convergence, which the fused solve's CUDA graph
captures (cuSOLVER's eigh reads the device and cannot be captured), and a
block of more than 64 DOFs with sweeps runs Z's wide layout at those
sweeps. `unconverged` (a 0-d int32 device tensor) collects Z's count of
blocks the converged mode left unconverged; the solvers raise on it.
`project_all` serves the ProjectedNewton and ProjectOnDemand modes,
`project_selective` (kernel C with an element mask) the Progressive mode.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.pd_project import (KERNEL_MAX_D, KERNEL_WIDE_MAX_D,  # noqa: F401
                              _jacobi_eigh, _round_robin_rounds, batched_eigh,
                              pd_project, pd_project_plain, pd_project_wide,
                              pd_project_z, z_converges, Z_MAX_SWEEPS)


def default_jacobi_sweeps(device: torch.device) -> int:
    """0 (exact eigh) on the CPU, 8 Jacobi sweeps on CUDA."""
    return 0 if torch.device(device).type == "cpu" else 8


def project_family_to_pd(H, eps: float, mirroring: bool, elem_mask=None,
                         jacobi_sweeps: int = 0, unconverged=None):
    """Project a (E, d, d) stack of symmetric matrices to PD. Returns
    (H_projected, changed) where changed marks elements whose eigenvalues
    were modified (for the `ph%` statistic). elem_mask restricts projection
    to selected elements. On the CPU the twin (exact eigh for sweeps 0 or
    d <= 3); on the card kernel Z for those and for d > 64, kernel C for
    the rest."""
    H = H.contiguous()
    if H.device.type == "cpu":
        return pd_project_plain(H, eps, mirroring, elem_mask, jacobi_sweeps)
    d = H.shape[-1]
    if z_converges(d, jacobi_sweeps) or d > KERNEL_WIDE_MAX_D:
        return pd_project_z(H, eps, mirroring, elem_mask, jacobi_sweeps, unconverged)
    if d > KERNEL_MAX_D:
        return pd_project_wide(H, eps, mirroring, elem_mask, jacobi_sweeps)
    return pd_project(H, eps, mirroring, elem_mask, jacobi_sweeps)


def project_all(hess: Dict[str, torch.Tensor], eps: float, mirroring: bool,
                data=None, jacobi_sweeps: int = 0, psd_names=(), unconverged=None):
    """ProjectedNewton mode: project every element Hessian. `data` restricts
    the changed-count to active rows. Families in `psd_names` are PSD by
    construction and pass through unchanged. `unconverged`: see
    project_family_to_pd."""
    out = {}
    n_changed = None
    for name, H in hess.items():
        if name in psd_names:
            out[name] = H
            continue
        Hp, changed = project_family_to_pd(H, eps, mirroring,
                                           jacobi_sweeps=jacobi_sweeps,
                                           unconverged=unconverged)
        out[name] = Hp
        if data is not None:
            changed = changed & (data[name]["rows"]["active"] > 0.5)
        c = torch.sum(changed.to(torch.int32))
        n_changed = c if n_changed is None else n_changed + c
    if n_changed is None:
        dev = next(iter(hess.values())).device
        n_changed = torch.zeros((), dtype=torch.int32, device=dev)
    return out, n_changed.to(torch.int32)


def project_selective(hess: Dict[str, torch.Tensor], data, eps: float,
                      mirroring: bool, block_mask, jacobi_sweeps: int = 0,
                      psd_names=(), unconverged=None):
    """Progressive (PPN) mode: project only the active elements that touch a
    DOF block whose gradient magnitude reaches the threshold (block_mask
    (n_blocks,) bool), through kernel C's elem_mask
    (NewtonsMethod.cpp:310-334)."""
    out = {}
    n_changed = None
    for name, H in hess.items():
        if name in psd_names:
            out[name] = H
            continue
        conn = data[name]["conn"]
        elem_mask = torch.any(block_mask[conn], dim=1) \
            & (data[name]["rows"]["active"] > 0.5)
        Hp, changed = project_family_to_pd(H, eps, mirroring, elem_mask,
                                           jacobi_sweeps=jacobi_sweeps,
                                           unconverged=unconverged)
        out[name] = Hp
        c = torch.sum(changed.to(torch.int32))
        n_changed = c if n_changed is None else n_changed + c
    if n_changed is None:
        dev = next(iter(hess.values())).device
        n_changed = torch.zeros((), dtype=torch.int32, device=dev)
    return out, n_changed.to(torch.int32)


def count_elements(hess: Dict[str, torch.Tensor], data) -> torch.Tensor:
    n = None
    for name in hess:
        c = torch.sum((data[name]["rows"]["active"] > 0.5).to(torch.int32))
        n = c if n is None else n + c
    return n.to(torch.int32)


def raise_unconverged(n: int):
    """The solvers' check of kernel Z's count, read with their host read."""
    if n > 0:
        raise RuntimeError(
            f"PD projection: {n} element Hessian(s) still unconverged after "
            f"{Z_MAX_SWEEPS} Jacobi sweeps (kernel Z's converged mode)")
