"""Projected Newton minimizer: host side of the fused solve.

Port of the fused path of `stark_tpu/solver/newton.py`
(`NewtonsMethod.__init__`, :77-178, and `_solve_fused`, :252-460): it builds
the evaluators, sizes the contact engine's slacks and the live-pool
capacity, runs the fused solve of one time step (solver/fused.py), pulls the
DOFs, the 16-float stats vector and the count vector back in one transfer,
and maps the outcome code to a `SolverReturn` with the same logger keys. A
count over its capacity (contact lists, friction tables, live pool) bumps
the capacity and solves the step again from the same state (logger key
`fused_retraces`, named after the JAX package's re-trace); the capacities
are kept in memory only (a persistent cache is ROADMAP Queue 1 P10).

Lagged friction: the fused solve builds the step's friction tables itself
while `ContactEngine.friction_enabled_now`; the solve is rebuilt when that
flips (set_friction after a frictionless step changes its count keys).

The staged host-driven solver, the other projection modes, the DirectLLT
linear solver and the line-search failure dump are ROADMAP Queue 1 P5 and
raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict

import numpy as np
import torch

from ..core.callbacks import SolverCallbacks
from ..core.logger import Logger, OutputSink
from ..core.settings import LinearSolver, NewtonSettings, ProjectionToPD
from . import assembly, project


class SolverReturn(Enum):
    # symx::SolverReturn (solver_utils.h:15-26)
    Successful = 0
    Running = 1
    InvalidInitialState = 2
    TooManyIterations = 3
    TooManyArmijoIterations = 4
    LinearSystemSolveFailure = 5
    TooManyInvalidIntermediateIterations = 6
    StepDoesNotDescend = 7
    InvalidConvergedState = 8


@dataclass
class SolveStats:
    newton_iterations: int = 0
    cg_iterations: int = 0
    ls_cap_iterations: int = 0
    ls_max_iterations: int = 0
    ls_inv_iterations: int = 0
    ls_bt_iterations: int = 0
    n_hessians: int = 0
    n_projected_hessians: int = 0
    projected_hessians_ratio: float = 0.0
    host_syncs: int = 0


_P5 = "ROADMAP Queue 1 P5 (staged solver and all projection modes)"


class NewtonsMethod:
    """Host orchestrator over the fused device solve.

    Parameters
    ----------
    families : registered potential families.
    n_blocks : total DOF blocks (DofLayout.n_blocks).
    get_static_data : () -> the frozen family tables.
    get_glob : () -> glob dict (dt, gravity, state tensors).
    get_dofs / set_dofs : read/write the (n_blocks, 3) DOF tensor.
    prime_host_dofs : feeds the host mirrors from the one per-step pull.
    """

    def __init__(self, families, n_blocks: int, callbacks: SolverCallbacks,
                 settings: NewtonSettings, logger: Logger, output: OutputSink,
                 get_glob: Callable, get_dofs: Callable, set_dofs: Callable,
                 get_static_data: Callable, device: torch.device,
                 prime_host_dofs: Callable = None, jacobi_sweeps: int = None,
                 get_engine: Callable = None):
        self.families = families
        self.n_blocks = n_blocks
        self.callbacks = callbacks
        self.settings = settings
        self.logger = logger
        self.output = output
        self.get_glob = get_glob
        self.get_dofs = get_dofs
        self.set_dofs = set_dofs
        self.get_static_data = get_static_data
        self.prime_host_dofs = prime_host_dofs
        self.get_engine = get_engine
        self.device = torch.device(device)
        self.stats = SolveStats()
        self._fused = None
        self._fused_use_ff = False
        self._fused_count_keys = []
        # dense Newton-Schulz preconditioner up to this many blocks
        # (assembly.ns_refresh); block-Jacobi above
        self._direct_max_blocks = 2048
        # motion prior (max |du| of the last accepted solve)
        self._du_prior = 1.0
        # live-pool capacity of the contact families (assembly.live_select)
        self._pool_cap = 8
        eng = self._engine()
        if eng is not None:
            need = max(2048, (2 * len(eng.sv_gid) + len(eng.es)) // 2)
            self._pool_cap = 1 << (need - 1).bit_length()
        self._last_counts: Dict[str, int] = {}
        self._topo = None
        self._M_dev = None

        ev = assembly.make_evaluators(families, n_blocks)
        self._ev = ev
        self._energy = ev.energy
        self._energy_grad_hess = ev.energy_grad_hess

        self._jacobi_sweeps = (jacobi_sweeps if jacobi_sweeps is not None
                               else project.default_jacobi_sweeps(self.device))
        # families PSD by construction skip the eigendecomposition entirely
        self._psd_names = frozenset(f.name for f in families if f.psd)

    def _engine(self):
        return self.get_engine() if self.get_engine is not None else None

    def _engine_params(self, engine, dtype):
        """Per-solve engine inputs: state, thicknesses and the slacks
        (stark_tpu/solver/newton.py:271-309)."""
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        dhat_max = 2.0 * float(np.max(np.asarray(engine.model.contact_thicknesses)))
        # the combined dense path's broad radius may grow to free-fall
        # stride scale, 8*dhat (32 mm at the default thickness); the
        # per-stem path keeps 4*dhat: its candidate rows (c_*) grow with
        # the radius cubed. The cap bounds the [max] stage's stride budget,
        # so the two paths take different Newton steps.
        dense = engine.dense_pt and engine.dense_ee
        return {"eng_state": engine.engine_state(), "th": engine.th_vec(),
                "slack_pair": t(0.5 * dhat_max),
                "slack_broad_min": t(2.0 * dhat_max),
                "slack_broad_max": t(max(8.0 * dhat_max, 0.032) if dense
                                     else 4.0 * dhat_max),
                "du_floor": t(1e-4)}

    def live_contact_pairs(self) -> int:
        """Contact pairs within dhat in the last solve (max over its shell
        builds, the n_live_* counts)."""
        return sum(c for k, c in self._last_counts.items() if k.startswith("n_live_"))

    def friction_rows(self) -> int:
        """Lagged friction pairs of the last solve (kernel I's counts of the
        pairs within dhat at the step start); 0 when the solve built none."""
        return self._last_counts.get("f_pt", 0) + self._last_counts.get("f_ee", 0)

    # ------------------------------------------------------------------
    def _fused_eligible(self) -> bool:
        s = self.settings
        cb = self.callbacks
        return (s.linear_solver == LinearSolver.BDPCG
                and s.projection_mode in (ProjectionToPD.ProjectedNewton,
                                          ProjectionToPD.Newton)
                and cb.residual is None
                and not cb.max_allowed_step
                and not cb.is_converged)

    def _build_fused(self):
        from .fused import build_fused_solve, uses_friction

        engine = self._engine()
        self._fused_use_ff = uses_friction(engine)
        self._fused, self._fused_count_keys = build_fused_solve(self, engine)

    def _solve_fused(self) -> SolverReturn:
        from .fused import uses_friction

        s = self.settings
        self.stats = SolveStats()
        engine = self._engine()
        if self._fused is None or uses_friction(engine) != self._fused_use_ff:
            self._build_fused()

        data_static = self.get_static_data()
        use_direct = (s.projection_mode == ProjectionToPD.ProjectedNewton
                      and self.n_blocks <= self._direct_max_blocks)
        if not self._ev.topology_matches(self._topo, data_static):
            self._topo = self._ev.topology(data_static, dense=use_direct)
        glob = self.get_glob()
        u0 = self.get_dofs()
        dtype = u0.dtype
        params = {
            "max_iterations": min(s.max_iterations, 2**31 - 1),
            "min_iterations": s.min_iterations,
            "residual_tolerance_abs": s.residual_tolerance_abs,
            "residual_tolerance_rel": s.residual_tolerance_rel,
            "bailout_residual": s.bailout_residual,
            "step_tolerance": s.step_tolerance,
            "step_cap": min(s.step_cap, float(torch.finfo(torch.float32).max)),
            "cg_abs_tolerance": s.cg_abs_tolerance,
            "cg_rel_tolerance": s.cg_rel_tolerance,
            "du_prior": self._du_prior,
        }
        if engine is not None:
            params.update(self._engine_params(engine, dtype))

        # persistent dense-inverse preconditioner (Newton-Schulz warm seed):
        # stays on the device across steps; zeros trigger the cold start
        if self._M_dev is None:
            n = 3 * (self.n_blocks + 1) if use_direct else 0
            self._M_dev = torch.zeros((n, n), dtype=dtype, device=u0.device)

        syncs0 = self._ev.host_syncs
        keys = self._fused_count_keys
        with self.logger.time("fused_solve"):
            while True:
                params["pool_cap"] = self._pool_cap
                u_out, packed, counts_dev, M_out = self._fused(
                    u0, data_static, glob, params, self._M_dev, self._topo)
                # the one transfer per solve: the DOFs, stats and counts
                u_np = u_out.cpu().numpy()
                packed = packed.cpu().numpy()
                counts = counts_dev.cpu().numpy()
                over = self._bump_caps(engine, keys, counts)
                if not over:
                    break
                # a capacity overflowed: solve the step again from the same
                # state with the larger capacities (and the same warm
                # preconditioner seed, so the result equals a run that
                # started with them)
                self.logger.add("fused_retraces", 1)
                self.output.print_with_new_line(
                    "fused re-solve: cap overflow on %s"
                    % ", ".join("%s=%d" % kc for kc in over))
            self._M_dev = M_out
        self.stats.host_syncs = self._ev.host_syncs - syncs0 + 1
        self._last_counts = {k: int(c) for k, c in zip(keys, counts)}

        code = int(packed[0])
        self.logger.append("solver_code", code)
        self.set_dofs(u_out)
        if self.prime_host_dofs is not None:
            self.prime_host_dofs(u_np)
        self._du_prior = max(1e-4, float(packed[11]))

        st = self.stats
        st.newton_iterations = int(packed[1])
        st.cg_iterations = int(packed[2])
        st.ls_cap_iterations = int(packed[3])
        st.ls_max_iterations = int(packed[4])
        st.ls_inv_iterations = int(packed[5])
        st.ls_bt_iterations = int(packed[6])
        st.n_projected_hessians = int(packed[7])
        st.n_hessians = int(packed[8])
        self.logger.add_and_append("broad_rebuilds", int(packed[12]))
        self.logger.add_and_append("live_contact_pairs", self.live_contact_pairs())
        self.logger.add_and_append("friction_rows", self.friction_rows())
        self.logger.add_and_append("pair_rebuilds", int(packed[13]))
        self.logger.append("ns_q", float(packed[14]))
        self.logger.add_and_append("ns_cold_restarts", int(packed[15]))
        self.logger.add_and_append("host_syncs", st.host_syncs)
        if st.n_hessians > 0:
            st.projected_hessians_ratio = st.n_projected_hessians / st.n_hessians
        self.logger.add_and_append("newton_iterations", st.newton_iterations)
        self.logger.add_and_append("cg_iterations", st.cg_iterations)
        self.logger.append("projected_hessians_ratio", st.projected_hessians_ratio)
        for key, n in (("ls_cap", st.ls_cap_iterations), ("ls_max", st.ls_max_iterations),
                       ("ls_inv", st.ls_inv_iterations), ("ls_bt", st.ls_bt_iterations)):
            self.logger.add_and_append(key, n)

        code_map = {
            1: SolverReturn.Successful,
            2: SolverReturn.InvalidInitialState,
            3: SolverReturn.TooManyIterations,
            4: SolverReturn.TooManyArmijoIterations,
            5: SolverReturn.LinearSystemSolveFailure,
            6: SolverReturn.TooManyInvalidIntermediateIterations,
            9: SolverReturn.InvalidConvergedState,
        }
        result = code_map.get(code, SolverReturn.LinearSystemSolveFailure)

        if result == SolverReturn.TooManyInvalidIntermediateIterations:
            self.callbacks.run_on_intermediate_state_invalid()
        if result == SolverReturn.TooManyArmijoIterations:
            if self.settings.print_line_search_upon_failure:
                raise NotImplementedError(
                    "print_line_search_upon_failure re-solves on the staged "
                    "path: " + _P5)
            self.callbacks.run_on_armijo_fail()
        if result == SolverReturn.Successful:
            # host-side converged-state checks (prescribed-position
            # tolerances with stiffness hardening)
            if not self.callbacks.run_is_converged_state_valid():
                result = SolverReturn.InvalidConvergedState
        return result

    def _bump_caps(self, engine, keys, counts):
        """Grow every capacity a count exceeded; returns [(key, count)] of
        the overflows (empty when none)."""
        over = []
        live = int(counts[keys.index("hvp_pool")])
        if live > self._pool_cap:
            while self._pool_cap < live:
                self._pool_cap *= 2
            over.append(("hvp_pool", live))
        eng_kc = [(k, c) for k, c in zip(keys, counts)
                  if k not in ("hvp_pool", "direct_slots")]
        if engine is not None and eng_kc \
                and engine._check_overflow([k for k, _ in eng_kc],
                                           [c for _, c in eng_kc]):
            over += engine._last_overflow
        return over

    # ------------------------------------------------------------------
    def solve(self) -> SolverReturn:
        if self._fused_eligible():
            return self._solve_fused()
        return self._solve_staged()

    def _solve_staged(self) -> SolverReturn:
        raise NotImplementedError(
            "the staged Newton solver (DirectLLT, ProjectOnDemand, "
            "Progressive, custom residual/convergence callbacks): " + _P5)

    # ------------------------------------------------------------------
    def get_last_solve_stats(self) -> SolveStats:
        return self.stats

    def print_summary(self):
        out = self.output
        logger = self.logger
        total_n_newton = logger.get_stats("newton_iterations").total
        if total_n_newton == 0:
            out.print_with_new_line("No Newton iterations were performed.")
            return
        out.print_with_new_line("")
        out.print_with_new_line(f"  {'Solve':<24} {'Total':>10} {'Avg':>8} {'Min':>8} {'Max':>8}")
        out.print_with_new_line("  " + "-" * 62)
        rows = [("Newton iterations", "newton_iterations"), ("CG iterations", "cg_iterations"),
                ("Line search cap", "ls_cap"), ("Line search max", "ls_max"),
                ("Line search inv", "ls_inv"), ("Line search bt", "ls_bt"),
                ("Host syncs", "host_syncs")]
        for label, key in rows:
            st = logger.get_stats(key)
            out.print_with_new_line(
                f"  {label:<24} {int(st.total):>10} {st.avg:>8.1f} {int(st.min):>8} {int(st.max):>8}")
        st = logger.get_stats("projected_hessians_ratio")
        out.print_with_new_line(
            f"  {'Projected hessians':<24} {'':>10} {100*st.avg:>7.1f}% {100*st.min:>7.1f}% {100*st.max:>7.1f}%")
        total_time = sum(logger.get_timer_total(l) for l in logger.get_timer_labels())
        out.print_with_new_line("")
        out.print_with_new_line(f"  {'Runtime':<40} {'Time (s)':>10}  {'%':>6}")
        out.print_with_new_line("  " + "-" * 60)
        entries = sorted(((l, logger.get_timer_total(l)) for l in logger.get_timer_labels()),
                         key=lambda kv: -kv[1])
        for label, t in entries:
            if total_time > 0 and t / total_time < 0.001:
                continue
            pct = 100.0 * t / total_time if total_time > 0 else 0.0
            out.print_with_new_line(f"  {label:<40} {t:>10.6f}  {pct:>5.1f}%")
        out.print_with_new_line("  " + "-" * 60)
        out.print_with_new_line(f"  {'Total':<40} {total_time:>10.6f}  100.0%")
        out.print_new_line()
