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
    Simulation's `_device_data`, pulled to numpy) -> the port's device
    tables: float leaves in `dtype`, integer leaves int64, same order."""
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
