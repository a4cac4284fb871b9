"""Projected Newton minimizer: the host side of the fused solve and the
staged host-driven solver.

Port of `stark_tpu/solver/newton.py`. The fused path
(`NewtonsMethod.__init__`, :77-178, and `_solve_fused`, :252-460) builds
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

The staged solver (`_solve_staged`, :470-625) takes every configuration the
fused solve does not (`_fused_eligible`): DirectLLT, the ProjectOnDemand and
Progressive projection modes, a custom residual, `is_converged` or
`max_allowed_step` callback, or the STARK_TPU_TORCH_NO_FUSED=1 switch (read
at every solve). Its Newton loop, projection ladder (all four modes), linear
solves (BDPCG over per-arity groups: kernels A [diag], B [staged], D;
DirectLLT: kernel A [direct] then the library Cholesky) and four-stage line
search [cap] [max] [inv] [bt] are JAX's, with its exit order, logger keys
and SolverReturn codes; the contact model refreshes the contact tables
before every energy evaluation (ContactEngine.refresh_contacts, K16) and the
friction tables once per step. `print_line_search_upon_failure` re-solves a
fused step that ran out of Armijo iterations on the staged path, which
writes the energy profile along the failed direction.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.callbacks import SolverCallbacks
from ..core.logger import Logger, OutputSink
from ..core.settings import LinearSolver, NewtonSettings, ProjectionToPD, Verbosity
from . import assembly, project
from .pcg import solve_pcg

# set to "1" to send every solve through the staged solver
NO_FUSED_ENV = "STARK_TPU_TORCH_NO_FUSED"


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


class NewtonsMethod:
    """Host orchestrator over the fused device solve and the staged stages.

    Parameters
    ----------
    families : registered potential families.
    n_blocks : total DOF blocks (DofLayout.n_blocks).
    get_data : () -> the tables of the current Newton evaluation (static
        families and the contact model's refreshed tables; staged solver).
    get_static_data : () -> the frozen family tables (fused solve; None
        sends every solve to the staged solver).
    get_glob : () -> glob dict (dt, gravity, state tensors).
    get_dofs / set_dofs : read/write the (n_blocks, 3) DOF tensor.
    prime_host_dofs : feeds the host mirrors from the one per-step pull.
    """

    def __init__(self, families, n_blocks: int, callbacks: SolverCallbacks,
                 settings: NewtonSettings, logger: Logger, output: OutputSink,
                 get_data: Callable, get_glob: Callable, get_dofs: Callable,
                 set_dofs: Callable, get_static_data: Optional[Callable],
                 device: torch.device, prime_host_dofs: Callable = None,
                 jacobi_sweeps: int = None, get_engine: Callable = None):
        self.families = families
        self.n_blocks = n_blocks
        self.callbacks = callbacks
        self.settings = settings
        self.logger = logger
        self.output = output
        self.get_data = get_data
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
        # line-search failure diagnostic (print_line_search_upon_failure)
        self.diagnostic_dir = ""
        self._ls_failure_count = 0

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
        """Contact pairs within dhat in the last solve: a fused solve's
        max over its shell builds (the n_live_* counts); a staged solve's,
        the active rows of the engine's last contact refresh."""
        if self._last_counts:
            return sum(c for k, c in self._last_counts.items()
                       if k.startswith("n_live_"))
        return self._active_rows(lambda eng: eng._contact_data)

    def friction_rows(self) -> int:
        """Lagged friction pairs of the last solve (kernel I's counts of the
        pairs within dhat at the step start); a staged solve's, the active
        rows of the step's friction tables; 0 when none were built."""
        if self._last_counts:
            return self._last_counts.get("f_pt", 0) + self._last_counts.get("f_ee", 0)
        return self._active_rows(lambda eng: eng._friction_data or {})

    def _active_rows(self, tables_of) -> int:
        eng = self._engine()
        if eng is None:
            return 0
        return sum(int(torch.sum(fd["rows"]["active"] > 0.5))
                   for fd in tables_of(eng).values())

    # ------------------------------------------------------------------
    def _fused_eligible(self) -> bool:
        if os.environ.get(NO_FUSED_ENV) == "1":
            return False
        s = self.settings
        cb = self.callbacks
        return (self.get_static_data is not None
                and s.linear_solver == LinearSolver.BDPCG
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
                # as the reference, re-solve on the staged path, which dumps
                # the energy profile along the failed direction
                # (NewtonsMethod.cpp:604-634)
                return self._solve_staged()
            self.callbacks.run_on_armijo_fail()
        if result == SolverReturn.Successful:
            # host-side converged-state checks (prescribed-position
            # tolerances with stiffness hardening); the solve ran the
            # intersection test on the device (code 9), so the contact
            # model's own converged check is suppressed
            model = engine.model if engine is not None else None
            if model is not None:
                model._suppress_converged_intersection = True
            try:
                ok = self.callbacks.run_is_converged_state_valid()
            finally:
                if model is not None:
                    model._suppress_converged_intersection = False
            if not ok:
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
        """One time step on the host-driven stages (NewtonsMethod.cpp:
        28-252): evaluate, convergence tests, project and solve until the
        direction descends, line search, in JAX's order."""
        s = self.settings
        self.stats = SolveStats()
        # the counts of the last solve are the fused path's: clear them, so
        # that live_contact_pairs/friction_rows read this solve's tables
        self._last_counts = {}
        ev = self._ev
        result = SolverReturn.Running
        res_0 = math.inf
        E_prev = None
        stall = 0
        noise = 0.0

        # projection state persisting across Newton iterations
        self._pdn_countdown = 0
        self._ppn_threshold = -1.0

        if not self.callbacks.run_is_initial_state_valid():
            self.output.print_with_new_line("Newton failure: Invalid initial state.",
                                            Verbosity.Medium)
            result = SolverReturn.InvalidInitialState

        newton_iteration = -1
        while result == SolverReturn.Running:
            newton_iteration += 1
            if newton_iteration == s.max_iterations:
                result = (SolverReturn.Successful if s.max_iterations_as_success
                          else SolverReturn.TooManyIterations)
                break

            # energy, gradient and element Hessians at the refreshed tables
            self.callbacks.run_before_energy_evaluation()
            data = self.get_data()
            live = self._live_tables(data)
            glob = self.get_glob()
            u = self.get_dofs()
            with self.logger.time("evaluate"):
                E0_dev, aux, grad, hess_raw = self._energy_grad_hess(
                    u, live, glob, None, ev.egh_csr(live))
                E0 = ev.to_host(E0_dev)
                # rounding-noise floors (quadrature form; see assembly.py)
                eps_d = float(torch.finfo(u.dtype).eps)
                noise = eps_d * math.sqrt(max(ev.to_host(aux["e_nsq"]), 0.0))

            # residual (default inf-norm, solver_utils.h:28)
            if self.callbacks.residual is not None:
                residual_norm = float(self.callbacks.residual(grad))
            else:
                residual_norm = ev.to_host(torch.max(torch.abs(grad)))
            if newton_iteration == 0:
                res_0 = residual_norm

            # energy stall at the precision noise floor (fused.py)
            if E_prev is not None and (E_prev - E0) < noise:
                stall += 1
            else:
                stall = 0
            E_prev = E0

            if residual_norm < s.bailout_residual:
                result = SolverReturn.Successful
                break
            if newton_iteration >= s.min_iterations:
                # abs tolerance, componentwise floored by the per-block
                # backward-error floor (see fused.py res_ok)
                x_scale = (1.0 + ev.to_host(torch.max(torch.abs(glob["x0"])))
                           if "x0" in glob else 1.0)
                vscale = max(ev.to_host(torch.max(torch.abs(u))),
                             x_scale / ev.to_host(glob["dt"]))
                if ev.to_host(torch.all(torch.abs(grad) <= torch.clamp_min(
                        4.0 * eps_d * vscale * aux["hsum"], s.residual_tolerance_abs))):
                    result = SolverReturn.Successful
                    break
                if newton_iteration > 0 and residual_norm / res_0 < s.residual_tolerance_rel:
                    result = SolverReturn.Successful
                    break
                if stall >= 2:
                    result = SolverReturn.Successful
                    break

            # inner loop: project and solve until a descent direction (or
            # give up); the groups' CSRs depend on the tables only
            groups = ev.staged_groups(live)
            slots = self._padding_slots(data, grad)
            init_cg = self.stats.cg_iterations
            du = None
            du_dot_grad = 0.0
            dec_converged = False
            while True:
                hess, all_projected, n_projected, pads = self._project(hess_raw, live, grad)
                du, ok, cg_iters = self._solve_linear_system(
                    grad, live, hess, groups, residual_norm,
                    s.projection_eps * slots if pads else None)
                self.stats.cg_iterations += cg_iters

                descends = False
                if ok:
                    du_dot_grad = ev.to_host(torch.dot(du.reshape(-1), grad.reshape(-1)))
                    descends = du_dot_grad < 0.0
                    # Newton-decrement noise-floor convergence (fused.py)
                    if abs(du_dot_grad) < 4.0 * noise:
                        dec_converged = True
                        result = SolverReturn.Successful
                        break

                if ok and descends:
                    break
                can_project_more = (s.projection_mode != ProjectionToPD.Newton) \
                    and not all_projected
                if not can_project_more:
                    result = (SolverReturn.LinearSystemSolveFailure if not ok
                              else SolverReturn.StepDoesNotDescend)
                    break
                self._increase_projection(grad)

            if dec_converged:
                break

            if result != SolverReturn.Running:
                self.output.print_with_new_line(
                    "Newton failure: Could not solve the linear system or find a "
                    "descend direction.", Verbosity.Summary)
                break

            self._decrease_projection()

            # stats and logs (NewtonsMethod.cpp:195-207)
            self.stats.n_hessians += ev.to_host(project.count_elements(hess_raw, live))
            self.stats.n_projected_hessians += int(n_projected)
            self.logger.add_and_append("cg_iterations", self.stats.cg_iterations - init_cg)

            # step tolerance
            du_max = ev.to_host(torch.max(torch.abs(du)))
            if newton_iteration >= s.min_iterations and du_max < s.step_tolerance:
                result = SolverReturn.Successful
                break

            result = self._line_search(u, du, du_dot_grad, du_max, live, glob, noise)

            # user convergence
            if newton_iteration >= s.min_iterations and self.callbacks.run_is_converged():
                result = SolverReturn.Successful
                break
            if result != SolverReturn.Running:
                break

        # converged-state validity (NewtonsMethod.cpp:243-252)
        if result == SolverReturn.Successful:
            if not self.callbacks.run_is_converged_state_valid():
                self.output.print_with_new_line("Newton failure: Invalid converged state.",
                                                Verbosity.Medium)
                result = SolverReturn.InvalidConvergedState

        self.stats.newton_iterations = max(newton_iteration, 0)
        if self.stats.n_hessians > 0:
            self.stats.projected_hessians_ratio = (
                self.stats.n_projected_hessians / self.stats.n_hessians)
        self.logger.add_and_append("newton_iterations", self.stats.newton_iterations)
        self.logger.append("projected_hessians_ratio", self.stats.projected_hessians_ratio)
        return result

    # ------------------------------------------------------------------
    # projection ladder (NewtonsMethod.cpp:254-386)
    # ------------------------------------------------------------------
    def _live_rows(self):
        eng = self._engine()
        return eng.live_rows() if eng is not None else {}

    def _live_tables(self, data):
        """The tables the staged solve works on: the contact and friction
        tables cut to their live rows, the static families whole. JAX keeps
        the padding past a count: zero energy and derivatives there, so all
        it adds is what a projection makes of a zero Hessian
        (_padding_slots)."""
        live = self._live_rows()
        out = {}
        for name, fd in data.items():
            n = live.get(name)
            if n is None:
                out[name] = fd
            elif n > 0:
                out[name] = {"conn": fd["conn"][:n],
                             "rows": {r: v[:n] for r, v in fd["rows"].items()}}
        return out

    def _padding_slots(self, data, like):
        """(n_blocks,) per DOF block, how often the padding rows of the
        contact and friction tables that a projection touches (not PSD by
        construction) name it. project_all makes each of those zero
        Hessians eps * I, so JAX's staged sums add eps * slots to the block
        diagonal wherever it ran; the solve adds that term itself
        (_solve_linear_system), and kernels A and B never see the padding,
        whose rows would all land in one serial segment."""
        slots = torch.zeros(self.n_blocks, dtype=like.dtype, device=like.device)
        for name, n in self._live_rows().items():
            if name in data and name not in self._psd_names:
                pad = data[name]["conn"][n:].reshape(-1).long()
                slots += torch.bincount(pad, minlength=self.n_blocks).to(like.dtype)
        return slots

    def _project(self, hess_raw, data, grad):
        """(element Hessians for this solve, all of them projected, count of
        projected elements, whether project_all ran: only it touches the
        inactive rows) under the projection mode and its state."""
        s = self.settings
        mode = s.projection_mode
        kw = dict(jacobi_sweeps=self._jacobi_sweeps, psd_names=self._psd_names)
        with self.logger.time("project_to_PD"):
            if mode == ProjectionToPD.Newton:
                return hess_raw, False, 0, False
            if mode == ProjectionToPD.ProjectedNewton or (
                    mode == ProjectionToPD.ProjectOnDemand and self._pdn_countdown > 0):
                hess, n = project.project_all(hess_raw, s.projection_eps,
                                              s.project_to_pd_use_mirroring, data, **kw)
                return hess, True, self._ev.to_host(n), True
            if mode == ProjectionToPD.ProjectOnDemand:
                return hess_raw, False, 0, False
            if mode == ProjectionToPD.Progressive:
                if self._ppn_threshold < 0.0:
                    return hess_raw, False, 0, False
                thr = self._ppn_threshold
                if 0.0 < thr < 1e-12:
                    thr = 0.0
                    self._ppn_threshold = 0.0
                block_mask = torch.max(torch.abs(grad), dim=1).values >= thr
                all_projected = self._ev.to_host(torch.all(block_mask))
                hess, n = project.project_selective(
                    hess_raw, data, s.projection_eps, s.project_to_pd_use_mirroring,
                    block_mask, **kw)
                return hess, all_projected, self._ev.to_host(n), False
        raise ValueError(f"unknown projection mode {mode}")

    def _increase_projection(self, grad):
        s = self.settings
        if s.projection_mode == ProjectionToPD.ProjectOnDemand:
            self._pdn_countdown = s.project_on_demand_countdown
        elif s.projection_mode == ProjectionToPD.Progressive:
            if self._ppn_threshold < 0.0:
                self._ppn_threshold = self._ev.to_host(torch.max(torch.abs(grad)))
            self._ppn_threshold *= s.ppn_tightening_factor

    def _decrease_projection(self):
        s = self.settings
        if s.projection_mode == ProjectionToPD.ProjectOnDemand:
            self._pdn_countdown -= 1
        elif s.projection_mode == ProjectionToPD.Progressive:
            self._ppn_threshold *= s.ppn_release_factor

    # ------------------------------------------------------------------
    # linear solves (NewtonsMethod.cpp:388-457)
    # ------------------------------------------------------------------
    def _cg_stage(self, grad, ctx, abs_tol, rel_tol, max_iter, stop_on_indef,
                  pad=None):
        """BDPCG over the arity groups: block-Jacobi from kernel A [diag]
        and D, q = H p from kernel B [staged]; `pad` (n_blocks,) adds
        pad * I to each diagonal block."""
        ev = self._ev
        D = ev.diag_blocks_ctx(ctx)
        if pad is not None:
            D = D + pad[:, None, None] * torch.eye(3, dtype=D.dtype, device=D.device)

        def hvp(p):
            q = ev.hvp_ctx(p, ctx)
            return q if pad is None else q + pad[:, None] * p
        Dinv = assembly.precondition_inverse(D)
        return solve_pcg(hvp,
                         lambda r: assembly.apply_preconditioner(Dinv, r),
                         -grad, abs_tol, rel_tol, max_iter, stop_on_indef,
                         to_host=ev.to_host)

    def _direct_stage(self, grad, data, hess, pad=None):
        """DirectLLT (the rb_constraints tests use it for determinism,
        tests/rb_constraints.cpp:27-46): the dense (3n)^2 Hessian from
        kernel A [direct], a 1e-30 diagonal shift for untouched DOFs, then
        the library Cholesky, upper as JAX's cho_factor. A matrix that is
        not positive definite gives ok = False (JAX's cho_factor returns NaNs
        there), so the projection ladder can go on."""
        n = self.n_blocks
        Hd = self._ev.assemble_dense_direct(data, hess)
        if pad is not None:
            Hd.diagonal().add_(pad.repeat_interleave(3))
        Hd.diagonal().add_(1e-30)
        U, info = torch.linalg.cholesky_ex(Hd, upper=True)
        du = torch.cholesky_solve(-grad.reshape(-1, 1), U, upper=True).reshape(n, 3)
        ok = (info == 0) & torch.all(torch.isfinite(du))
        return du, ok

    def _solve_linear_system(self, grad, data, hess, groups, residual_norm, pad=None):
        """(du, ok, CG iterations) of the Newton system H du = -grad; BDPCG
        runs over the arity groups (`groups`, this iteration's CSRs). `pad`
        (n_blocks,), where given, adds pad * I to each diagonal block: the
        projected padding rows (_padding_slots)."""
        s = self.settings
        with self.logger.time("linear_system_solve"):
            if s.linear_solver == LinearSolver.DirectLLT:
                du, ok = self._direct_stage(grad, data, hess, pad)
                return du, self._ev.to_host(ok), 0
            # forcing sequence (NewtonsMethod.cpp:423)
            forcing = min(1e-2, residual_norm * min(0.5, math.sqrt(residual_norm)))
            res = self._cg_stage(grad, self._ev.hvp_context(groups, hess),
                                 torch.as_tensor(max(forcing, s.cg_abs_tolerance),
                                                 dtype=grad.dtype, device=grad.device),
                                 torch.as_tensor(s.cg_rel_tolerance, dtype=grad.dtype,
                                                 device=grad.device),
                                 s.cg_max_iterations, s.cg_stop_on_indefiniteness, pad)
            return res.x, self._ev.to_host(res.converged), int(res.n_iterations)

    # ------------------------------------------------------------------
    # four-stage line search (NewtonsMethod.cpp:459-641)
    # ------------------------------------------------------------------
    def _line_search(self, u0, du, du_dot_grad, du_max, data, glob,
                     noise: float = 0.0) -> SolverReturn:
        s = self.settings
        ev = self._ev
        retraction = 1.0

        # [cap]
        if du_max > s.step_cap:
            retraction *= s.step_cap / du_max
            du = du * (s.step_cap / du_max)
            du_max = s.step_cap
            self.stats.ls_cap_iterations += 1
            self.logger.add_and_append("ls_cap", 1)
        else:
            self.logger.add_and_append("ls_cap", 0)

        # [max]
        max_step = self.callbacks.run_max_allowed_step()
        if max_step < 1.0:
            retraction *= max_step
            du = du * max_step
            du_max *= max_step
            self.stats.ls_max_iterations += 1
            self.logger.add_and_append("ls_max", 1)
        else:
            self.logger.add_and_append("ls_max", 0)

        shrink = 0.5
        step = 1.0
        self.set_dofs(u0 + step * du)

        # [inv]
        ls_inv_it = 0
        while ls_inv_it < s.max_backtracking_invalid_state_iterations:
            if self.callbacks.run_is_intermediate_state_valid():
                break
            step *= shrink
            self.set_dofs(u0 + step * du)
            self.stats.ls_inv_iterations += 1
            ls_inv_it += 1
        self.logger.add_and_append("ls_inv", ls_inv_it)
        if ls_inv_it == s.max_backtracking_invalid_state_iterations:
            self.output.print_with_new_line(
                "Newton failure: Too many invalid intermediate state iterations.",
                Verbosity.Medium)
            self.callbacks.run_on_intermediate_state_invalid()
            return SolverReturn.TooManyInvalidIntermediateIterations

        # [bt] Armijo
        if not s.enable_armijo_backtracking:
            return SolverReturn.Running

        # the reference energy from the trials' own program, at the
        # iteration's tables
        E0 = ev.to_host(self._energy(u0, data, glob))
        expected_decrease = s.line_search_armijo_beta * du_dot_grad * retraction
        # + noise: noise-tolerant Armijo (see fused.py)
        E_threshold = E0 + expected_decrease * step + noise
        armijo_iterations = 0
        while armijo_iterations < s.max_backtracking_armijo_iterations:
            # the contact tables track the trial state (the reference re-runs
            # before_energy_evaluation inside armijo, NewtonsMethod.cpp:594-596)
            self.callbacks.run_before_energy_evaluation()
            E1 = ev.to_host(self._energy(self.get_dofs(), self._live_tables(self.get_data()),
                                         self.get_glob()))
            if E1 < E_threshold:
                break
            step *= shrink
            self.set_dofs(u0 + step * du)
            E_threshold = E0 + expected_decrease * step + noise
            self.stats.ls_bt_iterations += 1
            armijo_iterations += 1
        self.logger.add_and_append("ls_bt", armijo_iterations)

        if armijo_iterations == s.max_backtracking_armijo_iterations:
            if u0.dtype == torch.float32:
                # f32: exhaustion is convergence only when the descent claim
                # was rounding noise: the final displacement is under one
                # position ulp or the claimed decrease is within the energy
                # noise floor
                eps32 = float(torch.finfo(torch.float32).eps)
                glob_now = self.get_glob()
                x_scale = (1.0 + ev.to_host(torch.max(torch.abs(glob_now["x0"])))
                           if "x0" in glob_now else 1.0)
                disp = step * ev.to_host(glob_now["dt"]) * du_max
                if disp <= eps32 * x_scale or \
                        abs(expected_decrease * step) <= max(noise, 0.0):
                    self.set_dofs(u0)
                    return SolverReturn.Successful
            self.output.print_with_new_line("Newton failure: Too many armijo iterations.",
                                            Verbosity.Medium)
            if s.print_line_search_upon_failure:
                self._dump_line_search_profile(u0, du, E0, du_dot_grad)
            self.callbacks.run_on_armijo_fail()
            return SolverReturn.TooManyArmijoIterations

        return SolverReturn.Running

    def _dump_line_search_profile(self, u0, du, E0, du_dot_grad, n_samples: int = 1000):
        """Line-search failure diagnostic: E(u0 + alpha * du) at n_samples
        alphas over [-0.5, 1.5] into
        `diagnostic_dir`/line_search_failure_<k>.txt (NewtonsMethod.cpp:
        549-563, 604-634); the contact tables are refreshed per sample as for
        an Armijo trial."""
        path = os.path.join(self.diagnostic_dir or ".",
                            "line_search_failure_%d.txt" % self._ls_failure_count)
        self._ls_failure_count += 1
        lines = ["# alpha  E(u0 + alpha*du)   E0=%r  du_dot_grad=%r" % (E0, du_dot_grad)]
        for a in np.linspace(-0.5, 1.5, n_samples):
            self.set_dofs(u0 + float(a) * du)
            self.callbacks.run_before_energy_evaluation()
            E = self._ev.to_host(self._energy(
                self.get_dofs(), self._live_tables(self.get_data()), self.get_glob()))
            lines.append("%.8f %.17g" % (a, E))
        self.set_dofs(u0)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        self.output.print_with_new_line(
            f"Line search failure energy profile written to {path}", Verbosity.Minimal)

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
