"""The fused projected-Newton solve of one time step, without contact.

Port of `stark_tpu/solver/fused.py` for `engine=None`: energy, gradient and
Hessian, PD projection, matrix-free BDPCG (block-Jacobi, or the persistent
dense Newton-Schulz inverse for small scenes), and the [cap] and [bt]
line-search stages. The JAX program is one `lax.while_loop`; here it is a
Python loop with the same carry, the same outcome codes, the same 16-float
stats vector and the same count keys. Every loop exit test reads one scalar
from the device (`ev.to_host`), so a step costs one host sync per Newton
iteration, per CG iteration and per Armijo probe; removing them (CUDA
graphs with a device-side done flag) is ROADMAP K12.

Without a contact engine the [max] stage never clamps (its budget is
infinite) and [inv] always accepts, so both reduce to their `engine is
None` forms: ls_max and ls_inv stay 0, and no shell is ever rebuilt after
iteration 0.

Result codes (match SolverReturn):
  1 Successful, 2 InvalidInitialState, 3 TooManyIterations,
  4 TooManyArmijoIterations, 5 LinearSystemSolveFailure (or no-descent),
  6 TooManyInvalidIntermediateIterations
"""
from __future__ import annotations

import torch

from . import assembly, project
from .pcg import solve_pcg

COUNT_KEYS = ["hvp_pool", "direct_slots"]


def build_fused_solve(nm):
    """Build the fused solve closed over the NewtonsMethod evaluators.
    Returns (f, count_keys) with f(u0, static_data, glob, params, M0, topo)
    -> (u, packed (16,) float32 stats, counts (2,) int32, M)."""

    energy = nm._energy
    egh = nm._energy_grad_hess
    ev = nm._ev
    s = nm.settings
    mirroring = s.project_to_pd_use_mirroring
    eps = s.projection_eps
    do_project = s.projection_mode.name == "ProjectedNewton"
    max_bt = s.max_backtracking_armijo_iterations
    beta = s.line_search_armijo_beta
    enable_bt = s.enable_armijo_backtracking
    n_blocks = nm.n_blocks
    use_direct = (s.projection_mode.name == "ProjectedNewton"
                  and n_blocks <= nm._direct_max_blocks)
    to_host = ev.to_host

    def du_reach(du):
        """Soft vertices move dt*|du_v|_2 per unit line-search step."""
        return torch.sqrt(torch.max(torch.sum(du ** 2, -1)))

    def fused_solve(u0, static_data, glob, params, M0, topo):
        dt = glob["dt"]
        ftype = u0.dtype
        dev = u0.device
        f_eps = torch.finfo(ftype).eps
        # position magnitude scale: one position ulp is the smallest world
        # displacement a line-search trial can realize
        x_scale = (1.0 + torch.max(torch.abs(glob["x0"]))
                   if "x0" in glob else torch.ones((), dtype=ftype, device=dev))

        def zi():
            return torch.zeros((), dtype=torch.int32, device=dev)

        u = u0
        it = 0
        res0 = torch.zeros((), dtype=ftype, device=dev)
        done = False
        code = zi()
        cg_total = 0
        ls_cap = zi()
        ls_bt = 0
        n_proj = zi()
        n_hess = zi()
        res = torch.zeros((), dtype=ftype, device=dev)
        E_prev = torch.zeros((), dtype=torch.float64, device=dev)
        stall = zi()
        du_prev = torch.as_tensor(params["du_prior"], dtype=ftype, device=dev)
        M = M0 if use_direct else torch.zeros((0, 0), dtype=ftype, device=dev)
        m_q = torch.full((), 1e9, dtype=ftype, device=dev)
        n_cold = zi()
        n_broad_rb = 0
        n_pair_rb = 0

        while not done and it < params["max_iterations"]:
            # no contact shells: the only "rebuild" is iteration 0's
            need_b = it == 0
            need_p = need_b
            data = static_data

            E0, aux, grad, hess = egh(u, data, glob, topo)
            # rounding-noise floors (quadrature form, see assembly.py)
            noise = (f_eps * torch.sqrt(aux["e_nsq"])).to(ftype)
            res = torch.max(torch.abs(grad))
            res0 = res if it == 0 else res0

            past_min = it >= params["min_iterations"]
            # energy-stall convergence: two consecutive iterations whose
            # energy improvement is below the rounding-noise floor
            stalled = (it > 0) & ((E_prev - E0) < noise.to(E0.dtype))
            stall = torch.where(stalled, stall + 1, zi())
            # residual acceptance: every component below the absolute
            # tolerance OR below its per-block backward-error floor
            vscale = torch.maximum(torch.max(torch.abs(u)), x_scale / dt)
            g_floor = f_eps * vscale * aux["hsum"]
            res_ok = torch.all(torch.abs(grad) <= torch.clamp_min(
                4.0 * g_floor, params["residual_tolerance_abs"]))
            conv = (res < params["bailout_residual"]) \
                | (past_min & res_ok) \
                | (past_min & (it > 0)
                   & (res / torch.clamp_min(res0, 1e-30)
                      < params["residual_tolerance_rel"])) \
                | (past_min & (stall >= 2))

            # PD projection (ProjectedNewton): static families per family,
            # PSD families skipped. No dynamic families: the live pool is
            # empty and skipped (it adds nothing to n_proj or n_hess).
            stat_names, _dyn = ev.split_dyn(hess.keys())
            hess_stat = {n: hess[n] for n in stat_names}
            if do_project:
                hess_stat_p, n_proj_it = project.project_all(
                    hess_stat, eps, mirroring,
                    {n: data[n] for n in stat_names},
                    jacobi_sweeps=nm._jacobi_sweeps,
                    psd_names=nm._psd_names)
            else:
                hess_stat_p, n_proj_it = hess_stat, zi()
            n_hess_it = project.count_elements(hess_stat, data)

            conn_cat, H_cat = ev.cat_with_live(topo.conn_cat, hess_stat_p)
            D = ev.diag_bucket(H_cat, topo)
            Dinv = assembly.precondition_inverse(D)
            if use_direct:
                # persistent dense-inverse preconditioner tracked by
                # Newton-Schulz sweeps, refreshed when the pair topology is
                # (re)built or the last quality probe says it drifted
                need_m = need_p or bool(to_host(m_q > 0.5))
                if need_m:
                    M, m_q, was_cold = ev.ns_refresh(M, H_cat, topo)
                    n_cold = n_cold + was_cold.to(torch.int32)
                m_good = m_q < 0.5

                def Minv(r, M=M, m_good=m_good):
                    qd = ev.apply_dense_perm(M, r)
                    qj = assembly.apply_preconditioner(Dinv, r)
                    return torch.where(m_good, qd, qj)
            else:
                def Minv(r):
                    return assembly.apply_preconditioner(Dinv, r)

            forcing = torch.clamp_max(
                res * torch.clamp_max(torch.sqrt(res), 0.5), 1e-2)
            abs_tol = torch.clamp_min(forcing, params["cg_abs_tolerance"])
            cg = solve_pcg(lambda p: ev.hvp_bucket(p, H_cat, topo), Minv, -grad,
                           abs_tol, params["cg_rel_tolerance"],
                           s.cg_max_iterations, s.cg_stop_on_indefiniteness,
                           to_host=to_host)
            du = cg.x
            dug = torch.sum(du * grad)
            du_max = torch.max(torch.abs(du))
            reach_du = du_reach(du)
            step_conv = past_min & (du_max < params["step_tolerance"])
            # Newton-decrement convergence at the precision noise floor
            dec_conv = torch.abs(dug) < 4.0 * noise
            lin_fail = torch.logical_not(cg.converged) \
                | ((dug >= 0.0) & torch.logical_not(dec_conv))

            # -------- line search (NewtonsMethod.cpp:459-641) --------
            # [cap]
            capped = du_max > params["step_cap"]
            retraction = torch.where(
                capped, params["step_cap"] / torch.clamp_min(du_max, 1e-30),
                torch.ones_like(du_max))
            # [max] has an infinite budget and [inv] accepts the full step
            # without a contact engine
            du_ls = du * retraction
            step = torch.ones((), dtype=ftype, device=dev)

            def energy_at(step):
                return energy(u + step * du_ls, data, glob)

            expected = beta * dug * retraction
            bt_it = 0
            bt_fail = torch.zeros((), dtype=torch.bool, device=dev)
            bt_conv = torch.zeros((), dtype=torch.bool, device=dev)
            if enable_bt:
                # Armijo reference energy from the SAME energy-only function
                # as the trial energies
                E0a = energy(u, data, glob)
                # halvings below one position ulp cannot change any
                # coordinate at this dtype: stop probing there
                disp1 = dt * reach_du * retraction
                step_floor = f_eps * x_scale / torch.clamp_min(disp1, 1e-30)

                def bt_more(step, j, E1):
                    return (E1 >= E0a + expected * step + noise) \
                        & (j < max_bt) & (step > step_floor)

                E1 = energy_at(step)
                while to_host(bt_more(step, bt_it, E1)):
                    step = step * 0.5
                    bt_it += 1
                    E1 = energy_at(step)
                bt_exhausted = (E1 >= E0a + expected * step + noise) \
                    & ((bt_it >= max_bt) | (step <= step_floor))
                # f32: exhausting the noise-tolerant Armijo means the
                # descent claim is cancellation noise -> converged at dtype
                # resolution; f64 keeps the reference's failure semantics
                if ftype == torch.float32:
                    bt_conv = bt_exhausted
                else:
                    bt_fail = bt_exhausted

            u_new = u + step * du_ls

            # outcome resolution, in the reference's order of checks
            done_t = conv | lin_fail | step_conv | dec_conv | bt_fail | bt_conv
            code = torch.where(
                conv | step_conv | dec_conv | bt_conv, 1,
                torch.where(lin_fail, 5, torch.where(bt_fail, 4, 0))
            ).to(torch.int32)
            # on residual/step/decrement/sub-noise convergence the state is
            # NOT advanced
            keep = conv | step_conv | dec_conv | bt_conv | lin_fail
            u = torch.where(keep, u, u_new)

            cg_total += cg.n_iterations
            ls_cap = ls_cap + capped.to(torch.int32)
            ls_bt += bt_it
            n_proj = n_proj + n_proj_it
            n_hess = n_hess + n_hess_it
            E_prev = E0
            du_prev = reach_du
            n_broad_rb += int(need_b)
            n_pair_rb += int(need_p)
            it += 1
            done = bool(to_host(done_t))

        # loop exhausted without done -> TooManyIterations (or success)
        if not done:
            code = torch.full((), 1 if s.max_iterations_as_success else 3,
                              dtype=torch.int32, device=dev)
        f32 = torch.float32

        def fv(x):
            return torch.as_tensor(x, device=dev).to(f32).reshape(())

        packed = torch.stack([
            fv(code), fv(it), fv(cg_total), fv(ls_cap), fv(0), fv(0),
            fv(ls_bt), fv(n_proj), fv(n_hess), fv(res), fv(E_prev),
            fv(du_prev), fv(n_broad_rb), fv(n_pair_rb), fv(m_q), fv(n_cold),
        ])
        counts = torch.zeros((len(COUNT_KEYS),), dtype=torch.int32, device=dev)
        return u, packed, counts, M

    return fused_solve, list(COUNT_KEYS)
