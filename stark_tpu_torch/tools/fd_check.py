"""Finite-difference check of a scene's incremental potential (the port's
counterpart of tests/test_derivatives.py's `fd_check`, after the reference's
SecondOrderCompiledGlobal::test_derivatives_with_FD).

At a random iterate around the step-start DOFs, central differences of the
energy against the gradient of `energy_grad_hess` on a sample of DOFs, and
central differences of the gradient along a random direction against the
product of the element Hessians with it. Every static family of the scene
takes part (contact off). Run on the CPU in float64: the families evaluate
through their torch.func twins, or, with `host=True`, through the g++ build
of their kernels' element math (ops/egh.py `launch`).
"""
from __future__ import annotations

import numpy as np
import torch


def hessian_product(H: dict, data: dict, v: torch.Tensor) -> torch.Tensor:
    """sum over families and elements of H_e v[conn_e], scattered by block."""
    out = torch.zeros_like(v)
    for name, He in H.items():
        conn = data[name]["conn"].long()
        E, a = conn.shape
        y = torch.bmm(He, v[conn].reshape(E, 3 * a, 1)).reshape(E * a, 3)
        out.index_add_(0, conn.reshape(-1), y)
    return out


def _host_evaluate(host: bool):
    """With host=True, route every family with a kernel through its g++
    build (the launcher's `host` route); returns the evaluate to restore."""
    from ..ops import egh

    orig = egh.evaluate
    if host:
        def evaluate(fam, u, conn, rows, glob, derivs=True):
            if fam.kernel is not None:
                return fam.kernel(u, conn, rows, glob, derivs, host=True)
            return orig(fam, u, conn, rows, glob, derivs)

        egh.evaluate = evaluate
    return orig


def fd_check(sim, seed: int = 0, h: float = 1e-6, tol: float = 2e-5,
             hv_tol: float = 5e-4, noise: float = 0.1, host: bool = False) -> dict:
    """The check of tests/test_derivatives.py's fd_check on a port
    Simulation (float64, CPU): asserts, and returns the worst relative
    errors {"grad": ..., "hvp": ...}."""
    stark = sim.stark
    stark._initialize()
    stark.callbacks.run_before_time_step()
    nm = stark.newton
    ev = nm._ev
    data = sim._get_static_data()
    glob = sim._get_glob()
    topo = ev.topology(data, dense=False)
    rng = np.random.default_rng(seed)
    u = sim._get_dofs().double().numpy()
    u = u + noise * rng.standard_normal(u.shape)
    from ..ops import egh

    orig = _host_evaluate(host)
    try:
        E, _aux, g, H = ev.energy_grad_hess(torch.as_tensor(u), data, glob, topo,
                                            ev.egh_csr(data))
        g = g.numpy()
        assert np.isfinite(float(E)) and np.all(np.isfinite(g))
        n = u.shape[0] * 3
        scale = max(1.0, float(np.max(np.abs(g))))
        worst_g = 0.0
        for flat in rng.choice(n, size=min(30, n), replace=False):
            b, d = divmod(int(flat), 3)
            up = u.copy()
            up[b, d] += h
            um = u.copy()
            um[b, d] -= h
            Ep = float(ev.energy(torch.as_tensor(up), data, glob))
            Em = float(ev.energy(torch.as_tensor(um), data, glob))
            err = abs((Ep - Em) / (2 * h) - g[b, d]) / scale
            assert err < tol, f"grad mismatch at block {b} dim {d}: {err:.3e}"
            worst_g = max(worst_g, err)
        v = rng.standard_normal(u.shape)
        v /= np.linalg.norm(v)
        gp = ev.energy_grad_hess(torch.as_tensor(u + h * v), data, glob, topo,
                                 ev.egh_csr(data))[2].numpy()
        gm = ev.energy_grad_hess(torch.as_tensor(u - h * v), data, glob, topo,
                                 ev.egh_csr(data))[2].numpy()
        fd_hv = (gp - gm) / (2 * h)
        hv = hessian_product(H, data, torch.as_tensor(v)).numpy()
        s = max(1.0, float(np.max(np.abs(fd_hv))))
        err_hv = float(np.max(np.abs(fd_hv - hv))) / s
        assert err_hv < hv_tol, f"Hvp mismatch: {err_hv:.3e}"
    finally:
        egh.evaluate = orig
    return {"grad": worst_g, "hvp": err_hv}
