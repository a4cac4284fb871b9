"""Core runtime: time loop, adaptive dt, frame scheduling, retry ladder.

Port of `stark_tpu/core/stark.py` (single process; multi-GPU is ROADMAP
Queue 1 P11). Reference: stark/src/core/Stark.cpp:79-338 — `run(duration)`
with 4 exit guards (sim time, duration, frame count, wall-clock budget);
`run_one_step()` lazily initializes, solves one Newton step, and on success
grows dt x1.05 capped at max; on InvalidConvergedState /
TooManyInvalidIntermediateIterations retries the same step (models already
hardened their stiffness); otherwise halves dt and aborts below the lower
bound. Frame writes follow the fps accounting of Stark.cpp:314-338.
"""
from __future__ import annotations

import math
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..solver.newton import NewtonsMethod, SolverReturn
from ..solver.potential import GlobalPotential
from .callbacks import Callbacks
from .logger import Logger, OutputSink
from .settings import Settings, Verbosity


def resolve_device(name: str) -> torch.device:
    """The torch device the settings ask for. A CUDA device that is not
    available raises: the port never falls back to the CPU silently."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"settings.device.device = {name!r} but no CUDA device is "
            "available; set settings.device.device = 'cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def resolve_dtype(name: str) -> torch.dtype:
    if name == "float64":
        return torch.float64
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported dtype {name!r}")


class Stark:
    def __init__(self, settings: Settings):
        self.settings = settings
        self.device = resolve_device(settings.device.device)
        # fill dtype-derived tolerance defaults (None fields)
        settings.newton.resolve_for_dtype(settings.device.dtype)
        out = settings.output
        log_path = None
        file_path = None
        if out.output_directory:
            os.makedirs(out.output_directory, exist_ok=True)
            base = os.path.join(out.output_directory, out.simulation_name)
            log_path = base + ".yaml"
            file_path = base + ".log"
        self.logger = Logger(log_path)
        self.output = OutputSink(out.console_verbosity, out.file_verbosity,
                                 out.enable_output, file_path)
        self.callbacks = Callbacks()
        self.global_potential = GlobalPotential()

        self.dt: float = settings.simulation.max_time_step_size
        self.gravity = np.asarray(settings.simulation.gravity, dtype=np.float64)
        self.current_time: float = 0.0
        self.current_frame: int = 0
        self.current_time_step: int = 0
        self.next_frame_time: float = 0.0
        self.is_init = False
        self.newton: Optional[NewtonsMethod] = None
        self.dtype = resolve_dtype(settings.device.dtype)

        # wired by the Simulation facade before the first step
        self._init_hooks: List[Callable[[], None]] = []
        self._connector = None  # dict with get_dofs/set_dofs/get_glob/get_data/n_blocks
        # families whose element tables must be regenerated (param updates,
        # animated targets, stiffness hardening). Consumed by the data manager.
        self.dirty_families: set[str] = set()

        self.output.print_with_new_line("================================== Settings ==============================")
        self.output.print_with_new_line(settings.as_string(), Verbosity.Summary)

    # ------------------------------------------------------------------
    def mark_dirty(self, family_name: str):
        self.dirty_families.add(family_name)

    def add_init_hook(self, f: Callable[[], None]):
        self._init_hooks.append(f)

    def connect(self, *, n_blocks_fn, get_dofs, set_dofs, get_glob, get_data,
                get_static_data, prime_host_dofs=None, get_engine=None):
        self._connector = dict(n_blocks_fn=n_blocks_fn, get_dofs=get_dofs,
                               set_dofs=set_dofs, get_glob=get_glob, get_data=get_data,
                               get_static_data=get_static_data,
                               prime_host_dofs=prime_host_dofs,
                               get_engine=get_engine)

    # ------------------------------------------------------------------
    def run(self, duration: float = math.inf, callback: Optional[Callable[[], None]] = None) -> bool:
        begin_time = self.current_time
        t0 = time.perf_counter()
        success = False
        while True:
            if self.current_time > self.settings.execution.end_simulation_time:
                self.output.print_with_new_line("Simulation time exceeded. Exiting simulation.")
                break
            if (self.current_time - begin_time) > duration:
                break
            if self.current_frame > self.settings.execution.end_frame:
                self.output.print_with_new_line("Frame count exceeded. Exiting simulation.")
                break
            if (time.perf_counter() - t0) > self.settings.execution.allowed_execution_time:
                self.output.print_with_new_line("Execution time exceeded. Exiting simulation.")
                break
            if callback is not None:
                callback()
            success = self.run_one_step()
            if not success:
                break
        self.print_summary()
        return success

    # ------------------------------------------------------------------
    def run_one_step(self) -> bool:
        logger, output = self.logger, self.output

        if not self.is_init:
            with logger.time("initialization"):
                self._initialize()

        if not self.callbacks.run_should_continue_execution():
            output.print_with_new_line("Simulation interrupted by user.", Verbosity.Minimal)
            return False

        if output.get_console_verbosity() != Verbosity.Minimal:
            output.print_with_new_line(
                f"{self.current_time_step}. dt: {1000.0 * self.dt:5.2f} ms | ", Verbosity.Summary)
        self.callbacks.run_before_time_step()

        t0 = time.perf_counter()
        newton = self.newton.solve()

        if newton == SolverReturn.Successful:
            self.callbacks.run_on_time_step_accepted()
            self.callbacks.run_after_time_step()
            self.current_time += self.dt
            self.current_time_step += 1
            # adaptive dt growth (Stark.cpp:170)
            self.dt = min(self.settings.simulation.max_time_step_size,
                          self.dt * self.settings.simulation.time_step_size_success_multiplier)

            runtime = time.perf_counter() - t0
            cr = runtime / self.dt
            stats = self.newton.get_last_solve_stats()
            if output.get_console_verbosity() != Verbosity.Minimal:
                cg_per_newton = (stats.cg_iterations // stats.newton_iterations
                                 if stats.newton_iterations > 0 else 0)
                output.print(
                    f"#newton: {stats.newton_iterations:2d} | "
                    f"ph: {100.0 * stats.projected_hessians_ratio:4.1f}% | "
                    f"#CG/newton: {cg_per_newton:4d} | "
                    f"ls (cap|max|inv|bt): {stats.ls_cap_iterations:2d}|{stats.ls_max_iterations:2d}|"
                    f"{stats.ls_inv_iterations:2d}|{stats.ls_bt_iterations:2d}| "
                    f"runtime: {1000.0 * runtime:6.1f} ms | cr: {cr:6.1f}",
                    Verbosity.Summary)

            logger.append("dt", self.dt)
            logger.append("time", self.current_time)
            logger.append("frame", self.current_frame)
            logger.add("time_steps", 1)
            logger.set("avg dt", self.current_time / self.current_time_step)

            if self.settings.output.enable_frame_writes:
                self._write_frame()
            if logger.time_since_last_write() > 10.0:
                logger.save_to_disk()
            return True

        # Failure ladder (Stark.cpp:213-241)
        runtime = time.perf_counter() - t0
        logger.add("failed_steps", 1)

        if newton in (SolverReturn.InvalidConvergedState,
                      SolverReturn.TooManyInvalidIntermediateIterations):
            # model already hardened its stiffness; retry the same step
            return True

        if not self.settings.simulation.use_adaptive_time_step:
            output.print_with_new_line(
                "use_adaptive_time_step is false. Exiting simulation.", Verbosity.Summary)
            return False

        self.dt /= 2.0
        if self.dt < self.settings.simulation.time_step_size_lower_bound:
            output.print_with_new_line(
                "Adaptive time step size out of bounds. Exiting simulation.", Verbosity.Summary)
            return False
        return True

    # ------------------------------------------------------------------
    def _initialize(self):
        self.is_init = True
        for f in self._init_hooks:
            f()
        if self._connector is None:
            raise RuntimeError("Stark core not connected to a model layer")
        c = self._connector
        n_blocks = c["n_blocks_fn"]()
        if n_blocks == 0:
            raise RuntimeError("Stark::_initialize(): no degrees of freedom")
        self.newton = NewtonsMethod(
            families=self.global_potential.families,
            n_blocks=n_blocks,
            callbacks=self.callbacks.newton,
            settings=self.settings.newton,
            logger=self.logger,
            output=self.output,
            get_data=c["get_data"],
            get_glob=c["get_glob"],
            get_dofs=c["get_dofs"],
            set_dofs=c["set_dofs"],
            get_static_data=c["get_static_data"],
            device=self.device,
            prime_host_dofs=c.get("prime_host_dofs"),
            jacobi_sweeps=self.settings.device.jacobi_sweeps,
            get_engine=c.get("get_engine"),
        )
        self.newton.diagnostic_dir = self.settings.output.output_directory
        self._write_frame()
        self.callbacks.run_before_simulation()
        if not self.callbacks.newton.run_is_initial_state_valid():
            raise RuntimeError("Initial state is not valid.")

    # ------------------------------------------------------------------
    def _write_frame(self):
        def write_frame_impl():
            if self.settings.output.fps != 0:
                self.callbacks.run_write_frame()
            self.output.print_with_new_line(
                f"[Frame: {self.current_frame}] Time: {self.current_time:.3f} s")
            self.current_frame += 1

        fps = self.settings.output.fps
        if fps < 0:  # every time step
            write_frame_impl()
        elif self.current_frame == 0:
            write_frame_impl()
            self.next_frame_time += 1.0 / fps if fps else math.inf
        else:
            while self.current_time > self.next_frame_time + 100.0 * np.finfo(np.float64).eps:
                write_frame_impl()
                self.next_frame_time += 1.0 / fps if fps else math.inf

    def get_frame_path(self, name: str) -> str:
        out = self.settings.output
        return os.path.join(out.output_directory,
                            f"{out.simulation_name}_{name}_{self.current_frame}")

    # ------------------------------------------------------------------
    def print_summary(self):
        out = self.output
        out.print_new_line(Verbosity.Minimal)
        out.print_with_new_line("================================== Summary ===============================")
        if self.current_time_step == 0:
            out.print_with_new_line("  No completed time steps.")
            self.logger.save_to_disk()
            return
        dt_stats = self.logger.get_stats("dt")
        out.print_with_new_line("Info")
        out.print_with_new_line(f"  Name:               {self.settings.output.simulation_name}")
        out.print_with_new_line(f"  Simulation time:    {self.current_time:.3f} s")
        out.print_with_new_line(f"  Frames:             {self.current_frame}")
        out.print_with_new_line(f"  Time steps:         {self.logger.get_int('time_steps')}")
        out.print_with_new_line(
            f"  dt [ms]:            avg: {1000 * dt_stats.avg:.1f} | min: {1000 * dt_stats.min:.1f}"
            f" | max: {1000 * dt_stats.max:.1f}")
        if self.newton is not None:
            self.newton.print_summary()
        self.logger.save_to_disk()
