"""Hook registries for the core loop and the Newton solver.

Reference: stark/src/core/Callbacks.h:13-85 (stark-level hooks)
and stark/extern/symx/src/solver/solver_utils.h:29-118
(SolverCallbacks, combined by AND for validity and min for max-step).
Models register themselves here at construction time — the plugin architecture
the core drives blindly (SURVEY.md L3/L4 dependency direction).
"""
from __future__ import annotations

from typing import Callable, List


class SolverCallbacks:
    """symx::SolverCallbacks equivalent (solver_utils.h:29-118)."""

    def __init__(self):
        self.before_energy_evaluation: List[Callable[[], None]] = []
        self.is_initial_state_valid: List[Callable[[], bool]] = []
        self.is_intermediate_state_valid: List[Callable[[], bool]] = []
        self.on_intermediate_state_invalid: List[Callable[[], None]] = []
        self.on_armijo_fail: List[Callable[[], None]] = []
        self.is_converged: List[Callable[[], bool]] = []
        self.is_converged_state_valid: List[Callable[[], bool]] = []
        self.max_allowed_step: List[Callable[[], float]] = []
        self.residual = None  # optional custom residual fn

    def add_before_energy_evaluation(self, f): self.before_energy_evaluation.append(f)
    def add_is_initial_state_valid(self, f): self.is_initial_state_valid.append(f)
    def add_is_intermediate_state_valid(self, f): self.is_intermediate_state_valid.append(f)
    def add_on_intermediate_state_invalid(self, f): self.on_intermediate_state_invalid.append(f)
    def add_on_armijo_fail(self, f): self.on_armijo_fail.append(f)
    def add_is_converged(self, f): self.is_converged.append(f)
    def add_is_converged_state_valid(self, f): self.is_converged_state_valid.append(f)
    def add_max_allowed_step(self, f): self.max_allowed_step.append(f)

    def run_before_energy_evaluation(self):
        for f in self.before_energy_evaluation:
            f()

    def run_is_initial_state_valid(self) -> bool:
        return all(f() for f in self.is_initial_state_valid)

    def run_is_intermediate_state_valid(self) -> bool:
        return all(f() for f in self.is_intermediate_state_valid)

    def run_on_intermediate_state_invalid(self):
        for f in self.on_intermediate_state_invalid:
            f()

    def run_on_armijo_fail(self):
        for f in self.on_armijo_fail:
            f()

    def run_is_converged(self) -> bool:
        # default false, AND over registered (solver_utils.h:101-104)
        if not self.is_converged:
            return False
        return all(f() for f in self.is_converged)

    def run_is_converged_state_valid(self) -> bool:
        return all(f() for f in self.is_converged_state_valid)

    def run_max_allowed_step(self) -> float:
        step = 1.0
        for f in self.max_allowed_step:
            step = min(step, f())
        return step


class Callbacks:
    """stark::core::Callbacks equivalent (Callbacks.h:13-85)."""

    def __init__(self):
        self.newton = SolverCallbacks()
        self.before_simulation: List[Callable[[], None]] = []
        self.before_time_step: List[Callable[[], None]] = []
        self.after_time_step: List[Callable[[], None]] = []
        self.on_time_step_accepted: List[Callable[[], None]] = []
        self.write_frame: List[Callable[[], None]] = []
        self.should_continue_execution: List[Callable[[], bool]] = []

    def add_before_simulation(self, f): self.before_simulation.append(f)
    def add_before_time_step(self, f): self.before_time_step.append(f)
    def add_after_time_step(self, f): self.after_time_step.append(f)
    def add_on_time_step_accepted(self, f): self.on_time_step_accepted.append(f)
    def add_write_frame(self, f): self.write_frame.append(f)
    def add_should_continue_execution(self, f): self.should_continue_execution.append(f)

    def run_before_simulation(self):
        for f in self.before_simulation:
            f()

    def run_before_time_step(self):
        for f in self.before_time_step:
            f()

    def run_after_time_step(self):
        for f in self.after_time_step:
            f()

    def run_on_time_step_accepted(self):
        for f in self.on_time_step_accepted:
            f()

    def run_write_frame(self):
        for f in self.write_frame:
            f()

    def run_should_continue_execution(self) -> bool:
        return all(f() for f in self.should_continue_execution)
