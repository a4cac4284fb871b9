"""Global DOF block layout.

The reference flattens all DOF sets (soft.v1, rigid.v1, rigid.w1) into one
vector with cumulative offsets and a hard BLOCK_SIZE=3 invariant
(stark/extern/symx/src/solver/GlobalPotential.cpp:83-140,
second_order/ElementHessians.h:42, NewtonsMethod.cpp:44-47). Here the DOF
vector is a (n_blocks, 3) array:

    block i               -> soft node i's v1            (i < n_soft)
    block n_soft + 2b     -> rigid body b's v1
    block n_soft + 2b + 1 -> rigid body b's w1

Keeping rigid DOFs as two 3-blocks preserves the reference's 3-blocked
Hessian structure so one block-diagonal preconditioner covers everything.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DofLayout:
    n_soft: int
    n_rigid: int

    @property
    def n_blocks(self) -> int:
        return self.n_soft + 2 * self.n_rigid

    @property
    def n_dofs(self) -> int:
        return 3 * self.n_blocks

    def soft_block(self, i: int) -> int:
        return i

    def rigid_v_block(self, b: int) -> int:
        return self.n_soft + 2 * b

    def rigid_w_block(self, b: int) -> int:
        return self.n_soft + 2 * b + 1
