"""Matrix-free block-preconditioned conjugate gradient.

Port of `stark_tpu/solver/pcg.py` (solve_pcg.h:82-240): PCG with
error = sqrt(r^2/b^2) tested against abs_tol and error/error_0 against
rel_tol, and indefiniteness detection pAp <= 0 with optional early stop.
The JAX `lax.while_loop` is `ctl.while_` (solver/program.py): a WHILE node
of the captured fused solve, or a Python loop on host reads under
EagerControl (the staged solver's, whose reads are its host syncs). Each
iteration is the operator, kernel Y's first half (ops/pcg_step.py), the
preconditioner and Y's second half, over x, r, p and a scalar carry that
stay in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops import pcg_step as Y
from .program import Control, EagerControl


class PCGResult(NamedTuple):
    x: torch.Tensor           # (n_blocks, 3)
    converged: torch.Tensor   # bool scalar
    n_iterations: torch.Tensor  # int32 scalar
    error: torch.Tensor
    found_indefiniteness: torch.Tensor


def pcg_init(Minv: Callable, b, abs_tol, max_iter: int):
    """The loop's carry at x0 = 0: (x, r, p, sf, si) with r = b, p =
    Minv(b) and the scalars of ops/pcg_step.py, the first predicate
    included."""
    dev, ftype = b.device, b.dtype
    b_norm_sq = Y._dot(b, b)
    # Zero-RHS early out (solve_pcg.h:118-126)
    zero_rhs = b_norm_sq < abs_tol * abs_tol
    # x0 = 0 -> r0 = b
    r = b.clone()
    z0 = Minv(r)
    rz = Y._dot(r, z0)
    err0 = torch.sqrt(torch.clamp_min(Y._dot(r, r) / torch.clamp_min(b_norm_sq, 1e-300),
                                      0.0))
    x = torch.zeros_like(b)
    p = z0.contiguous().clone()
    done = torch.logical_or(zero_rhs, err0 < abs_tol)
    sf = torch.stack([rz, err0, err0, b_norm_sq,
                      torch.as_tensor(abs_tol, dtype=ftype, device=dev),
                      torch.zeros((), dtype=ftype, device=dev)])
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    pred = torch.logical_not(done) & (max_iter > 0)
    si = torch.stack([zi, done.to(torch.int32), done.to(torch.int32), zi, zi, zi, zi,
                      pred.to(torch.int32)])
    return x, r, p, sf, si


def solve_pcg(A: Callable, Minv: Callable, b, abs_tol, rel_tol: float,
              max_iter: int, stop_on_indef: bool,
              ctl: Control = None) -> PCGResult:
    """Solve A x = b with PCG from x0 = 0 (NewtonsMethod.cpp:428-430 zeroes
    the initial guess each Newton iteration). abs_tol is a 0-d tensor or a
    float of b's dtype, rel_tol a float (a 0-d tensor is read once); without
    `ctl` the loop runs on host reads."""
    ctl = EagerControl() if ctl is None else ctl
    if isinstance(rel_tol, torch.Tensor):
        rel_tol = float(rel_tol)
    x, r, p, sf, si = pcg_init(Minv, b, abs_tol, max_iter)

    def body():
        Y.pcg_step1(p, A(p), x, r, sf, si, stop_on_indef, rel_tol)
        Y.pcg_step2(Minv(r), r, p, sf, si, max_iter)

    ctl.while_(lambda: si[Y.PRED] != 0, body)
    return PCGResult(x=x, converged=si[Y.CONVERGED] != 0, n_iterations=si[Y.IT],
                     error=sf[Y.ERROR], found_indefiniteness=si[Y.INDEFINITE] != 0)
