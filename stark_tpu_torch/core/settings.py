"""Configuration tree mirroring the reference's nested Settings structs.

Reference: stark/src/core/Settings.h:10-50 (Output, Simulation,
Execution) and stark/extern/symx/src/solver/solver_utils.h:173-259
(SolverSettings/NewtonSettings with ~25 solver knobs). Implemented as plain
dataclasses so the whole tree serializes into the run log like the reference's
`as_string()` dump (Stark.cpp:76-77).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Tuple


class Verbosity(Enum):
    # Mirrors symx::Verbosity (OutputSink.h)
    NoOutput = 0
    Minimal = 1
    Summary = 2
    Medium = 3
    Full = 4


class LinearSolver(Enum):
    # symx::LinearSolver (solver_utils.h:121-127)
    DirectLLT = 0
    BDPCG = 1


class ProjectionToPD(Enum):
    # symx::ProjectionToPD (solver_utils.h:137-156)
    Newton = 0            # no projection
    ProjectedNewton = 1   # always project all element Hessians
    ProjectOnDemand = 2   # project for a countdown after a failure
    Progressive = 3       # PPN: per-3x3-block gradient-magnitude threshold


@dataclass
class OutputSettings:
    # Settings.h Output
    simulation_name: str = "sim"
    output_directory: str = ""
    fps: int = 30
    console_verbosity: Verbosity = Verbosity.Summary
    file_verbosity: Verbosity = Verbosity.Full
    enable_frame_writes: bool = True
    enable_output: bool = True


@dataclass
class SimulationSettings:
    # Settings.h Simulation
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    init_frictional_contact: bool = True
    max_time_step_size: float = 1.0 / 30.0
    use_adaptive_time_step: bool = True
    time_step_size_success_multiplier: float = 1.05
    time_step_size_lower_bound: float = 1e-6


@dataclass
class ExecutionSettings:
    # Settings.h Execution
    allowed_execution_time: float = math.inf
    end_simulation_time: float = math.inf
    end_frame: int = 2**31 - 1


@dataclass
class NewtonSettings:
    # solver_utils.h SolverSettings + NewtonSettings
    # Iteration limits
    max_iterations: int = 2**31 - 1
    min_iterations: int = 0
    # Convergence. None = derived from the device dtype at initialization
    # (resolve_for_dtype). The ABSOLUTE tolerance stays at the reference's
    # 1e-6 for BOTH dtypes: the residual's magnitude is scene-scale (~mass *
    # g * dt per node), and loosening abs for f32 froze light cloth mid-air
    # (gravity gradient ~4e-4 < 1e-3 -> "converged" at zero velocity).
    # Under f32 the gradient NOISE floor (~eps32 * force scale) can sit above
    # 1e-6 on stiff scenes, so f32 additionally derives a RELATIVE fallback
    # (res/res0 < 1e-3) — the reference has the same rel test, disabled.
    residual_tolerance_abs: float = None
    residual_tolerance_rel: float = None
    # f32 also derives a step tolerance (velocity units): near quasi-static
    # convergence the f32 gradient noise floor (eps32 * balancing-force
    # magnitude) can exceed residual_tolerance_abs while the Newton step is
    # ~1e-8 — without a step exit the solver spins Armijo on noise and the
    # dt ladder deadlocks.
    step_tolerance: float = None
    max_iterations_as_success: bool = False
    # Line search
    step_cap: float = math.inf
    enable_armijo_backtracking: bool = True
    line_search_armijo_beta: float = 1e-4
    max_backtracking_armijo_iterations: int = 20
    max_backtracking_invalid_state_iterations: int = 8
    print_line_search_upon_failure: bool = False
    # Hessian projection to PD
    projection_mode: ProjectionToPD = ProjectionToPD.ProjectedNewton
    projection_eps: float = 1e-10
    project_to_pd_use_mirroring: bool = False
    project_on_demand_countdown: int = 4
    ppn_tightening_factor: float = 0.5
    ppn_release_factor: float = 2.0
    # Linear solver (None tolerances derived per dtype, see above)
    linear_solver: LinearSolver = LinearSolver.BDPCG
    cg_max_iterations: int = 10000
    cg_abs_tolerance: float = None
    cg_rel_tolerance: float = 1e-4
    cg_stop_on_indefiniteness: bool = True
    bailout_residual: float = None

    def resolve_for_dtype(self, dtype: str):
        """Fill None tolerance fields with dtype-derived defaults. The f64
        values are the reference's (solver_utils.h:173-259, Settings.cpp:47);
        f32 keeps the same absolute target but adds the relative fallback and
        floors the sub-f32-precision knobs (see field comments)."""
        f32 = dtype == "float32"
        if self.residual_tolerance_abs is None:
            self.residual_tolerance_abs = 1e-6
        if self.residual_tolerance_rel is None:
            # rel fallback OFF for both dtypes (reference default,
            # solver_utils.h). f32's "can't reach 1e-6 on stiff scenes" is
            # handled by the principled residual noise floor (assembly.py
            # g_nsq -> fused.py res_target); the earlier rel=1e-3 fallback
            # accepted under-converged contact states (measured 1e-3..2e-2
            # one-step deviation vs f64 on the bench scene).
            self.residual_tolerance_rel = 0.0
        if self.step_tolerance is None:
            self.step_tolerance = 1e-5 if f32 else 0.0
        if self.cg_abs_tolerance is None:
            # floor of the Newton forcing sequence (min(1e-2, r*sqrt(r)),
            # NewtonsMethod.cpp:423). In f32, CG relative errors below
            # ~30*eps32 are Hvp rounding noise — the forcing sequence would
            # otherwise demand rel 1e-6 solves near the residual floor and
            # burn 100s of meaningless iterations (measured: ~57 CG/newton
            # dropping to ~25 with this floor, identical trajectories).
            self.cg_abs_tolerance = 3e-5 if f32 else 1e-12
        if self.bailout_residual is None:
            self.bailout_residual = 1e-7 if f32 else 1e-10


@dataclass
class DeviceSettings:
    """Device knobs with no reference analog."""
    device: str = "cuda"         # torch device; "cpu" runs the kernels' plain twins
    dtype: str = "float64"       # "float64" for trajectory parity, "float32" for speed
    element_pad_multiple: int = 8   # pad element tables to this multiple
    # PD-projection eigensolver: None = auto (exact eigh on CPU, 8-sweep
    # batched cyclic Jacobi on CUDA), 0 = exact eigh (CPU only), N = N sweeps
    jacobi_sweeps: int = None


@dataclass
class Settings:
    output: OutputSettings = field(default_factory=OutputSettings)
    simulation: SimulationSettings = field(default_factory=SimulationSettings)
    newton: NewtonSettings = field(default_factory=NewtonSettings)
    execution: ExecutionSettings = field(default_factory=ExecutionSettings)
    device: DeviceSettings = field(default_factory=DeviceSettings)

    def as_string(self) -> str:
        def fmt(obj, indent=0):
            lines = []
            pad = "    " * indent
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if dataclasses.is_dataclass(v):
                    lines.append(f"{pad}{f.name}:")
                    lines.append(fmt(v, indent + 1))
                else:
                    if isinstance(v, Enum):
                        v = v.name
                    lines.append(f"{pad}{f.name}: {v}")
            return "\n".join(lines)

        return fmt(self)
