"""Matrix-free block-preconditioned conjugate gradient.

Port of `stark_tpu/solver/pcg.py` (solve_pcg.h:82-240): PCG with
error = sqrt(r^2/b^2) tested against abs_tol and error/error_0 against
rel_tol, and indefiniteness detection pAp <= 0 with optional early stop.
The JAX `lax.while_loop` becomes a Python loop with the same carry, tests
and exits; its exit test is one host read per iteration (`to_host`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGResult(NamedTuple):
    x: torch.Tensor           # (n_blocks, 3)
    converged: torch.Tensor   # bool scalar
    n_iterations: int
    error: torch.Tensor
    found_indefiniteness: torch.Tensor


def _dot(a, b):
    return torch.sum(a * b)


def solve_pcg(A: Callable, Minv: Callable, b, abs_tol, rel_tol,
              max_iter: int, stop_on_indef: bool,
              to_host: Callable = lambda t: t.item()) -> PCGResult:
    """Solve A x = b with PCG from x0 = 0 (NewtonsMethod.cpp:428-430 zeroes
    the initial guess each Newton iteration)."""
    b_norm_sq = _dot(b, b)

    # Zero-RHS early out (solve_pcg.h:118-126)
    zero_rhs = b_norm_sq < abs_tol * abs_tol

    # x0 = 0 -> r0 = b
    r = b
    z0 = Minv(r)
    rz = _dot(r, z0)
    err0 = torch.sqrt(torch.clamp_min(_dot(r, r) / torch.clamp_min(b_norm_sq, 1e-300), 0.0))

    x = torch.zeros_like(b)
    p = z0
    it = 0
    error = err0
    done = torch.logical_or(zero_rhs, err0 < abs_tol)
    converged = done
    indefinite = torch.zeros((), dtype=torch.bool, device=b.device)

    while it < max_iter and not to_host(done):
        Ap = A(p)
        pAp = _dot(p, Ap)
        indef = pAp <= 0.0
        stop_indef = indef & stop_on_indef

        alpha = rz / torch.where(pAp == 0.0, torch.full_like(pAp, 1e-300), pAp)
        x_new = x + alpha * p
        r = r - alpha * Ap
        err = torch.sqrt(_dot(r, r) / torch.clamp_min(b_norm_sq, 1e-300))
        conv = torch.logical_or(err < abs_tol,
                                err / torch.clamp_min(err0, 1e-300) < rel_tol)

        z = Minv(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0.0, torch.full_like(rz, 1e-300), rz)
        p = z + beta * p

        # On indefinite stop, keep the pre-update x like the reference
        # (solve_pcg.h:183-192 returns x before applying alpha)
        x = torch.where(stop_indef, x, x_new)
        error = torch.where(stop_indef, error, err)
        done = torch.logical_or(conv, stop_indef)
        converged = conv & torch.logical_not(stop_indef)
        indefinite = indefinite | indef
        rz = rz_new
        it += 1

    return PCGResult(x=x, converged=converged, n_iterations=it, error=error,
                     found_indefiniteness=indefinite)
