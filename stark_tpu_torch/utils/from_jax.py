"""Carry the JAX package's frozen state into the port's tensors.

The inputs are plain numpy arrays (a caller pulls them from `stark_tpu`
with `np.asarray`), so this module imports neither JAX nor `stark_tpu`; it
lets both packages compute on identical element tables and states.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a.astype(np.int64), device=device)


def tables_from_numpy(static: Dict[str, Dict], dtype: torch.dtype = torch.float64,
                      device="cpu") -> Dict[str, Dict]:
    """{name: {"conn": (E, a), "rows": {...}}} numpy tables (the JAX
    Simulation's `_device_data`, or its contact engine's friction tables,
    pulled to numpy) -> the port's device tables: float leaves in `dtype`,
    integer leaves int64, same order."""
    return {name: {"conn": _tensor(fd["conn"], dtype, device),
                   "rows": {k: _tensor(v, dtype, device)
                            for k, v in fd["rows"].items()}}
            for name, fd in static.items()}


def state_from_numpy(x0, v0, X, dtype: torch.dtype = torch.float64,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Point state (positions x0, velocities v0, rest positions X) -> the
    glob entries the deformable energies read (zero nodal accelerations and
    forces, as after a fresh freeze)."""
    x0 = _tensor(x0, dtype, device)
    return {"x0": x0, "v0": _tensor(v0, dtype, device),
            "X": _tensor(X, dtype, device),
            "pt_a": torch.zeros_like(x0), "pt_f": torch.zeros_like(x0)}


def set_rigid_state(rb_dyn, t0, q0, v1=None, w1=None):
    """Give the port's frozen rigid bodies (`Simulation._rb_dyn`) a state:
    translations t0 (n, 3) and unit quaternions q0 (n, 4) (w, x, y, z) on the
    host, and the trial velocities v1, w1 (n, 3) on the device (None keeps
    the current ones)."""
    rb_dyn.t0 = np.array(t0, dtype=np.float64).reshape(-1, 3)
    rb_dyn.q0 = np.array(q0, dtype=np.float64).reshape(-1, 4)
    if v1 is not None:
        rb_dyn.v1 = _tensor(np.reshape(v1, (-1, 3)), rb_dyn.dtype, rb_dyn.device)
    if w1 is not None:
        rb_dyn.w1 = _tensor(np.reshape(w1, (-1, 3)), rb_dyn.dtype, rb_dyn.device)


def set_contact_state(contact, thicknesses, stiffness: float, caps=None,
                      pair_mu=None):
    """Give the port's contact model (`Simulation.interactions.contact`) the
    per-mesh contact thicknesses, the running barrier stiffness, the
    per-mesh-pair Coulomb mu (the JAX model's `pair_mu`, {(a, b): mu}; the
    port's `mu_mat` glob entry is built from it) and, once the engine exists
    (after the first step's freeze), the list capacities of the JAX engine
    (`engine._caps`: the f_ friction tables', the hash grid's g_ and the
    candidate rows' c_, cf_, i_ included; the names the port does not have
    are ignored)."""
    contact.contact_thicknesses = [float(t) for t in np.asarray(thicknesses).ravel()]
    contact.contact_stiffness = float(stiffness)
    if pair_mu is not None:
        contact.pair_mu = {(int(a), int(b)): float(v) for (a, b), v in pair_mu.items()}
    if caps:
        eng = contact.engine()
        if eng is None:
            raise RuntimeError("set_contact_state: the contact engine is built "
                               "at the first step; carry caps after it")
        eng.set_caps({k: int(v) for k, v in caps.items()})
