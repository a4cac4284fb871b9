"""Potential registry: the PyTorch port of stark_tpu's GlobalPotential.

Each registered `PotentialFamily` carries a plain PyTorch per-element energy
function and, where one is written, its hand-written CUDA kernel
(`kernel`, ops/egh.py: kernels M-V). On CUDA tensors the kernel computes
the element energies, gradients and dense Hessians; on CPU tensors (and on
the card for a family without a kernel) they come from
`torch.func.grad_and_value` / `torch.func.hessian` under `torch.func.vmap`
(ops/egh.py `plain`), mirroring `jax.grad`/`jax.hessian` under `vmap`.

Element protocol
----------------
`energy_fn(u_e, row, glob) -> scalar` where

  * ``u_e``  : (arity, 3) tensor of gathered DOF blocks of the element (next-step
               velocities, see dofs.py for the block layout),
  * ``row``  : dict of per-element tensors (node/body indices, rest data,
               material params, and an 'active' mask entry),
  * ``glob`` : dict of global tensors (dt, gravity, state arrays like x0 /
               rigid q0 needed for gathers by index).

Masking: element tables are padded to static capacities; inactive rows must
produce finite values (energy functions guard their singular expressions via
row['active']), and the registry zeroes E/grad/Hessian of inactive rows.
This mirrors SymX's conditional potentials / active masks
(CompiledInLoop.h:22-79).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class PotentialFamily:
    name: str
    arity: int                       # number of 3-blocks per element
    energy_fn: Callable              # (u_e, row, glob) -> scalar
    # True for families whose (conn, rows) are refreshed every Newton
    # iteration (contact) rather than frozen at initialization.
    dynamic: bool = False
    # True for families whose element Hessians are PSD BY CONSTRUCTION
    # (quadratic energies in the DOFs with frozen coefficients: lumped /
    # rigid inertia, prescribed positions, d-d attachments, Bergou
    # flat-rest-angle bending). The PD projection skips them — the
    # reference projects every element (project_to_PD.cpp:12-48) but its
    # per-element eigendecompositions are cheap on CPU; the batched
    # eigensolve is a measurable per-iteration cost and a provably-PSD
    # family projects to itself.
    psd: bool = False
    # The CUDA launcher of the family's e/g/H kernel, (u, conn, rows, glob,
    # derivs) -> e or (e, g (E, arity, 3), H (E, 3 arity, 3 arity)), inactive
    # rows zero; None: torch.func on the card too (ops/egh.py `evaluate`).
    kernel: Optional[Callable] = None


class FamilyData:
    """Runtime element tables for one family: conn (E, arity) int32 block
    indices, rows dict (leading dim E, must contain 'active'), numpy on the
    host; the Simulation facade moves them onto the device at freeze."""

    __slots__ = ("conn", "rows")

    def __init__(self, conn, rows):
        self.conn = conn
        self.rows = rows


@dataclass
class GlobalPotential:
    """Ordered registry of potential families (GlobalPotential.h:15-77)."""

    families: List[PotentialFamily] = field(default_factory=list)
    # providers fill in FamilyData for static families at freeze time
    _static_providers: Dict[str, Callable[[], Optional[FamilyData]]] = field(default_factory=dict)

    def add_potential(self, family: PotentialFamily,
                      provider: Optional[Callable[[], Optional[FamilyData]]] = None):
        if any(f.name == family.name for f in self.families):
            # unique names enforced like GlobalPotential.cpp:6-14
            raise ValueError(f"duplicate potential name {family.name}")
        self.families.append(family)
        if provider is not None:
            self._static_providers[family.name] = provider

    def get_provider(self, name: str):
        return self._static_providers.get(name)

    def freeze_static_data(self, pad_multiple: int = 8) -> Dict[str, FamilyData]:
        """Collect all static family data. Called once at solver init; families
        whose provider returns None (no elements) are dropped from evaluation."""
        data: Dict[str, FamilyData] = {}
        for fam in self.families:
            if fam.dynamic:
                continue
            provider = self._static_providers.get(fam.name)
            if provider is None:
                continue
            fd = provider()
            if fd is None:
                continue
            data[fam.name] = pad_family_data(fd, fam.arity, pad_multiple)
        return data


def pad_family_data(fd: FamilyData, arity: int, multiple: int,
                    capacity: int | None = None) -> FamilyData:
    """Pad element tables to a static capacity (multiple of `multiple`).

    Padded rows repeat row 0's data with active=0 so every gathered index is
    in-bounds and every computed quantity finite. This replaces the
    reference's exact-size dynamic arrays; the same padding as stark_tpu keeps
    the two packages' tables identical."""
    conn = np.asarray(fd.conn, dtype=np.int32).reshape(-1, arity)
    n = conn.shape[0]
    cap = capacity if capacity is not None else max(multiple, -(-n // multiple) * multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} smaller than element count {n}")
    if cap == n and "active" in fd.rows:
        return fd

    def pad_leaf(x):
        x = np.asarray(x)
        out = np.zeros((cap,) + x.shape[1:], dtype=x.dtype)
        if n > 0:
            out[:n] = x
            out[n:] = x[0]  # repeat a valid row
        return out

    new_conn = pad_leaf(conn)
    new_rows = {k: pad_leaf(v) for k, v in fd.rows.items() if k != "active"}
    active = np.zeros((cap,), dtype=np.float64)
    if "active" in fd.rows:
        active[:n] = np.asarray(fd.rows["active"], dtype=np.float64)
    else:
        active[:n] = 1.0
    new_rows["active"] = active
    return FamilyData(new_conn, new_rows)
