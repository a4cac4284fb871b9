"""Projection of element Hessians to positive definiteness.

Port of `stark_tpu/solver/project.py`: per-element symmetric
eigendecomposition, eigenvalues below eps clamped to eps or mirrored to
-lambda, and the matrix rebuilt (project_to_PD.cpp:12-48). The batched
eigensolve and rebuild are kernel C (`ops.pd_project`, parallel-order
cyclic Jacobi; `pd_project_wide` for 16 < d <= 64); its plain twin —
`_jacobi_eigh`, or exact `torch.linalg.eigh` when `jacobi_sweeps=0` — is
the CPU path. On the card `jacobi_sweeps=0` also takes the twin's exact
eigh, as stark_tpu/solver/project.py:116-119 does. `torch.linalg.eigh`
(cuSOLVER) cannot be captured into a CUDA graph, so the fused solve's
capture raises there with that cause (ROADMAP Queue 3). `project_all`
serves the ProjectedNewton and ProjectOnDemand modes, `project_selective`
(kernel C with an element mask) the Progressive mode.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.pd_project import (KERNEL_MAX_D, _jacobi_eigh,  # noqa: F401
                              _round_robin_rounds, batched_eigh, pd_project,
                              pd_project_plain, pd_project_wide)


def default_jacobi_sweeps(device: torch.device) -> int:
    """0 (exact eigh) on the CPU, 8 Jacobi sweeps on CUDA."""
    return 0 if torch.device(device).type == "cpu" else 8


def project_family_to_pd(H, eps: float, mirroring: bool, elem_mask=None,
                         jacobi_sweeps: int = 0):
    """Project a (E, d, d) stack of symmetric matrices to PD. Returns
    (H_projected, changed) where changed marks elements whose eigenvalues
    were modified (for the `ph%` statistic). elem_mask restricts projection
    to selected elements."""
    H = H.contiguous()
    if H.device.type == "cuda" and not jacobi_sweeps:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "project_family_to_pd: exact eigh (jacobi_sweeps=0) runs "
                "torch.linalg.eigh (cuSOLVER), which cannot be captured into "
                "the fused solve's CUDA graph; use jacobi_sweeps > 0 or the "
                "staged solver (STARK_TPU_TORCH_NO_FUSED=1)")
        return pd_project_plain(H, eps, mirroring, elem_mask, 0)
    if H.shape[-1] > KERNEL_MAX_D:
        return pd_project_wide(H, eps, mirroring, elem_mask, jacobi_sweeps)
    return pd_project(H, eps, mirroring, elem_mask, jacobi_sweeps)


def project_all(hess: Dict[str, torch.Tensor], eps: float, mirroring: bool,
                data=None, jacobi_sweeps: int = 0, psd_names=()):
    """ProjectedNewton mode: project every element Hessian. `data` restricts
    the changed-count to active rows. Families in `psd_names` are PSD by
    construction and pass through unchanged."""
    out = {}
    n_changed = None
    for name, H in hess.items():
        if name in psd_names:
            out[name] = H
            continue
        Hp, changed = project_family_to_pd(H, eps, mirroring,
                                           jacobi_sweeps=jacobi_sweeps)
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
                      psd_names=()):
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
                                           jacobi_sweeps=jacobi_sweeps)
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
