"""Kernel Y: the two halves of a PCG step (csrc/pcg_step.cu) and their
plain twins.

Replaces the body of stark_tpu/solver/pcg.py's `lax.while_loop` (:99): the
port's CG iteration around the operator and the preconditioner. `pcg_step1`
runs after Ap = A p, `pcg_step2` after z = Minv r; both update x, r, p and
the scalar carry in place (sf: [rz, err0, error, b.b, abs_tol, err], si:
[it, done, converged, indefinite, stop_indef, conv, indef, pred]), so that a
captured loop body replays at fixed addresses. The twins are PCG's plain
torch expressions (solve_pcg.h:128-200), split at the same two points: the
CPU path, and the reference tests/test_torch_program.py holds bit for bit
against a Python-loop PCG.
"""
from __future__ import annotations

import torch

from . import build

# sf slots
RZ, ERR0, ERROR, BNSQ, ABS_TOL, ERR = range(6)
# si slots
IT, DONE, CONVERGED, INDEFINITE, STOP_INDEF, CONV, INDEF, PRED = range(8)


def _dot(a, b):
    return torch.sum(a * b)


def pcg_step1_plain(p, Ap, x, r, sf, si, stop_on_indef: bool, rel_tol: float):
    pAp = _dot(p, Ap)
    indef = pAp <= 0.0
    stop_indef = indef & stop_on_indef
    alpha = sf[RZ] / torch.where(pAp == 0.0, torch.full_like(pAp, 1e-300), pAp)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    err = torch.sqrt(_dot(r_new, r_new) / torch.clamp_min(sf[BNSQ], 1e-300))
    conv = torch.logical_or(err < sf[ABS_TOL],
                            err / torch.clamp_min(sf[ERR0], 1e-300) < rel_tol)
    # on an indefinite stop x keeps its pre-update value (solve_pcg.h:183-192)
    x.copy_(torch.where(stop_indef, x, x_new))
    r.copy_(r_new)
    sf[ERR] = err
    si[STOP_INDEF] = stop_indef.to(torch.int32)
    si[CONV] = conv.to(torch.int32)
    si[INDEF] = indef.to(torch.int32)


def pcg_step2_plain(z, r, p, sf, si, max_iter: int):
    rz = sf[RZ]
    rz_new = _dot(r, z)
    beta = rz_new / torch.where(rz == 0.0, torch.full_like(rz, 1e-300), rz)
    p.copy_(z + beta * p)
    stop_indef = si[STOP_INDEF] != 0
    conv = si[CONV] != 0
    sf[ERROR] = torch.where(stop_indef, sf[ERROR], sf[ERR])
    done = torch.logical_or(conv, stop_indef)
    si[DONE] = done.to(torch.int32)
    si[CONVERGED] = (conv & torch.logical_not(stop_indef)).to(torch.int32)
    si[INDEFINITE] = ((si[INDEFINITE] != 0) | (si[INDEF] != 0)).to(torch.int32)
    sf[RZ] = rz_new
    si[IT] = si[IT] + 1
    si[PRED] = (torch.logical_not(done) & (si[IT] < max_iter)).to(torch.int32)


def _check(name, vecs, sf, si):
    build.require_cuda(name, *vecs, sf, si)
    if any(v.dtype != sf.dtype or v.shape != vecs[0].shape for v in vecs):
        raise ValueError(f"{name}: vectors must share sf's dtype and one shape")
    if si.dtype != torch.int32 or sf.shape != (6,) or si.shape != (8,):
        raise ValueError(f"{name}: expected sf (6,) and si (8,) int32")


def pcg_step1(p, Ap, x, r, sf, si, stop_on_indef: bool, rel_tol: float):
    """After Ap = A p: x, r and sf/si's step-1 slots, in place."""
    if p.device.type == "cpu":
        return pcg_step1_plain(p, Ap, x, r, sf, si, stop_on_indef, rel_tol)
    Ap = Ap.contiguous()
    _check("pcg_step1", (p, Ap, x, r), sf, si)
    rc = build.entry("stk_pcg_step1", p.dtype)(
        p.data_ptr(), Ap.data_ptr(), x.data_ptr(), r.data_ptr(), sf.data_ptr(),
        si.data_ptr(), p.numel(), int(bool(stop_on_indef)), float(rel_tol),
        build.stream_ptr(p.device))
    build.check_status("pcg_step1", rc)
    build.count_launch("pcg_step[1]")


def pcg_step2(z, r, p, sf, si, max_iter: int):
    """After z = Minv r: p, the flags, the count and the predicate, in
    place."""
    if p.device.type == "cpu":
        return pcg_step2_plain(z, r, p, sf, si, max_iter)
    z = z.contiguous()
    _check("pcg_step2", (z, r, p), sf, si)
    rc = build.entry("stk_pcg_step2", p.dtype)(
        z.data_ptr(), r.data_ptr(), p.data_ptr(), sf.data_ptr(), si.data_ptr(),
        p.numel(), int(min(max_iter, 2**31 - 1)), build.stream_ptr(p.device))
    build.check_status("pcg_step2", rc)
    build.count_launch("pcg_step[2]")
