"""The fused projected-Newton solve of one time step, with frozen contact
shells.

Port of `stark_tpu/solver/fused.py`: energy, gradient and Hessian, PD
projection (static families per family, the live contact pool at d=15),
matrix-free BDPCG (block-Jacobi, or the persistent dense Newton-Schulz
inverse for small scenes), and the four line-search stages [cap] [max]
[inv] [bt]. The JAX program is one `lax.while_loop`; here it is a Python
loop with the same carry, the same outcome codes, the same 16-float stats
vector and the same count keys.

Contact (`engine` not None) uses the JAX package's twin-range frozen
candidate topology:
  * the BROAD shell (engine.broad_fn: ball pairs, exact distances, mid lists
    and intersection candidates within slack_b) is rebuilt at iteration 0,
    after a [max]-clamped step, or when the motion since its build exceeds
    0.45*slack_b;
  * the PAIR shell (engine.pairs_fn: the family pair tables within slack_p)
    is rebuilt with it or when the motion exceeds 0.45*slack_p;
  * [max] clamps every step to the remaining broad budget, so the frozen
    intersection candidates stay a superset and [inv] (kernel H over them)
    is exact; [inv] halves the step until no candidate crosses.
The initial state is tested at iteration 0 (code 2) and the converged state
after the loop (code 9, InvalidConvergedState).

Host syncs (`ev.to_host`, counted in `host_syncs`): one per loop exit test,
per CG iteration, per Armijo probe and per [inv] trial, plus the two shell
guards (need_b, need_p) per Newton iteration with contact and one read of
the pair tables' counts per pair build (the tables are cut to their live
rows: JAX evaluates every padded row, the port only the real pairs). Removing them
(CUDA graphs with a device-side done flag) is ROADMAP K12.

Result codes (match SolverReturn):
  1 Successful, 2 InvalidInitialState, 3 TooManyIterations,
  4 TooManyArmijoIterations, 5 LinearSystemSolveFailure (or no-descent),
  6 TooManyInvalidIntermediateIterations, 9 InvalidConvergedState
"""
from __future__ import annotations

import torch

from . import assembly, project
from .pcg import solve_pcg

BASE_COUNT_KEYS = ["hvp_pool", "direct_slots"]


def count_keys_of(engine):
    """Count keys of one solve: the engine's candidate and pair keys, then
    the live-pool count (direct_slots stays 0: the port sizes no slots)."""
    keys = []
    if engine is not None:
        keys = engine.broad_count_keys() + engine.pair_count_keys()
    return list(dict.fromkeys(keys)) + list(BASE_COUNT_KEYS)


def build_fused_solve(nm, engine=None):
    """Build the fused solve closed over the NewtonsMethod evaluators and
    the contact engine (or None). Returns (f, count_keys) with
    f(u0, static_data, glob, params, M0, topo) -> (u, packed (16,) float32
    stats, counts (n_keys,) int32, M)."""

    energy = nm._energy
    egh = nm._energy_grad_hess
    ev = nm._ev
    s = nm.settings
    mirroring = s.project_to_pd_use_mirroring
    eps = s.projection_eps
    do_project = s.projection_mode.name == "ProjectedNewton"
    max_inv = s.max_backtracking_invalid_state_iterations
    max_bt = s.max_backtracking_armijo_iterations
    beta = s.line_search_armijo_beta
    enable_bt = s.enable_armijo_backtracking
    n_blocks = nm.n_blocks
    use_direct = (s.projection_mode.name == "ProjectedNewton"
                  and n_blocks <= nm._direct_max_blocks)
    to_host = ev.to_host
    to_host_vec = ev.to_host_vec
    count_keys = count_keys_of(engine)
    key_slot = {k: i for i, k in enumerate(count_keys)}
    if engine is not None:
        r_max = engine.max_rigid_lever()
        n_soft = engine.n_soft
        isect_on = engine.isect_on()
    else:
        r_max, n_soft, isect_on = 0.0, n_blocks, False

    def du_reach(du):
        """World-displacement reach per unit line-search step: soft vertices
        move dt*|du_v|; rigid vertices add the angular lever |du_w| r_max."""
        m = torch.zeros((), dtype=du.dtype, device=du.device)
        if n_soft > 0:
            m = torch.sqrt(torch.max(torch.sum(du[:n_soft] ** 2, -1)))
        if n_blocks > n_soft:
            rw = du[n_soft:].reshape(-1, 2, 3)
            mv = torch.sqrt(torch.sum(rw[:, 0] ** 2, -1))
            mw = torch.sqrt(torch.sum(rw[:, 1] ** 2, -1))
            m = torch.maximum(m, torch.max(mv + mw * r_max))
        return m

    def fused_solve(u0, static_data, glob, params, M0, topo):
        dt = glob["dt"]
        ftype = u0.dtype
        dev = u0.device
        f_eps = torch.finfo(ftype).eps
        x_scale = (1.0 + torch.max(torch.abs(glob["x0"]))
                   if "x0" in glob else torch.ones((), dtype=ftype, device=dev))

        def zi():
            return torch.zeros((), dtype=torch.int32, device=dev)

        def fz():
            return torch.zeros((), dtype=ftype, device=dev)

        counts_max = torch.zeros((len(count_keys),), dtype=torch.int32, device=dev)

        def fold(cmax, counts):
            # max, not set (a key may come from several builds)
            for k, v in counts.items():
                i = key_slot[k]
                cmax[i] = torch.maximum(cmax[i], v.to(torch.int32))
            return cmax

        if engine is not None:
            eng_state = params["eng_state"]
            th = params["th"]
            slack_p = params["slack_pair"]

        def world(u):
            return engine.world_from_u(u, eng_state, dt)

        def disp_from(Vpair, Vs, Vr):
            d2 = torch.cat([torch.sum((a - b) ** 2, -1)
                            for a, b in zip((Vs, Vr), Vpair) if a is not None])
            return torch.sqrt(torch.clamp_min(torch.max(d2), 0.0))

        def trim_tables(tables, cnt):
            """The family tables cut to their live rows (one host read of
            the stems' counts per pair build): empty families drop out, so
            energies, derivatives and the live pool run over real pairs
            only. Rows past the count are inactive padding, so the values
            are those of the full tables."""
            names = list(tables)
            n = to_host_vec(torch.stack([cnt[k[len("contact_"):]] for k in names]))
            out = {}
            for name, c in zip(names, n.tolist()):
                fd = tables[name]
                k = min(int(c), fd["conn"].shape[0])
                if k > 0:
                    out[name] = {"conn": fd["conn"][:k],
                                 "rows": {r: v[:k] for r, v in fd["rows"].items()}}
            return out

        def isect_hit(u, icands):
            if engine is None or not isect_on:
                return torch.zeros((), dtype=torch.bool, device=dev)
            Vs, Vr = world(u)
            return engine.isect_hit(Vs, Vr, icands)

        u = u0
        it = 0
        res0 = fz()
        done = False
        code = zi()
        cg_total = 0
        ls_cap = zi()
        ls_max = zi()
        ls_inv = 0
        ls_bt = 0
        n_proj = zi()
        n_hess = zi()
        res = fz()
        E_prev = torch.zeros((), dtype=torch.float64, device=dev)
        stall = zi()
        du_prev = torch.as_tensor(params["du_prior"], dtype=ftype, device=dev)
        M = M0 if use_direct else torch.zeros((0, 0), dtype=ftype, device=dev)
        m_q = torch.full((), 1e9, dtype=ftype, device=dev)
        n_cold = zi()
        n_broad_rb = 0
        n_pair_rb = 0
        force_rb = torch.zeros((), dtype=torch.bool, device=dev)
        bcands = icands = Vb = Vp = None
        slack_b = fz()
        tables = {}
        data = static_data
        egh_csr = None

        while not done and it < params["max_iterations"]:
            # ---- shell validity guards + conditional rebuilds ----
            init_bad = torch.zeros((), dtype=torch.bool, device=dev)
            disp_b = fz()
            if engine is not None:
                Vs, Vr = world(u)
                if it == 0:
                    need_b = True
                else:
                    disp_b = disp_from(Vb, Vs, Vr)
                    need_b = bool(to_host(force_rb | (disp_b > 0.45 * slack_b)))
                if need_b:
                    slack_b = torch.clamp(
                        2.5 * dt * torch.clamp_min(du_prev, params["du_floor"]),
                        params["slack_broad_min"], params["slack_broad_max"])
                    bcands, icands, cnt = engine.broad_fn(Vs, Vr, th, slack_b, slack_p)
                    Vb = (Vs, Vr)
                    counts_max = fold(counts_max, cnt)
                    disp_b = fz()
                need_p = need_b or bool(to_host(
                    disp_from(Vp, Vs, Vr) > 0.45 * slack_p))
                if need_p:
                    tables, cnt = engine.pairs_fn(Vs, Vr, th, bcands, slack_p)
                    Vp = (Vs, Vr)
                    counts_max = fold(counts_max, cnt)
                    data = dict(static_data)
                    data.update(trim_tables(tables, cnt))
                    egh_csr = ev.egh_csr(data)
                if it == 0:
                    init_bad = isect_hit(u, icands)
            else:
                need_b = need_p = it == 0

            E0, aux, grad, hess = egh(u, data, glob, topo, egh_csr)
            # rounding-noise floors (quadrature form, see assembly.py)
            noise = (f_eps * torch.sqrt(aux["e_nsq"])).to(ftype)
            res = torch.max(torch.abs(grad))
            res0 = res if it == 0 else res0

            past_min = it >= params["min_iterations"]
            stalled = (it > 0) & ((E_prev - E0) < noise.to(E0.dtype))
            stall = torch.where(stalled, stall + 1, zi())
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

            # PD projection: static families per family (PSD families
            # skipped); the contact families through their live pool
            stat_names, dyn_names = ev.split_dyn(hess.keys())
            hess_stat = {n: hess[n] for n in stat_names}
            pool = None
            n_live = None
            if dyn_names:
                conn_live, H_live, live_valid, live_cnt = ev.live_select(
                    ev.dyn_conn_cat(data), ev.dyn_hess_cat(hess), params["pool_cap"])
                counts_max[key_slot["hvp_pool"]] = torch.maximum(
                    counts_max[key_slot["hvp_pool"]], live_cnt)
                n_live = torch.clamp_max(live_cnt, params["pool_cap"])
            if do_project:
                hess_stat_p, n_proj_it = project.project_all(
                    hess_stat, eps, mirroring,
                    {n: data[n] for n in stat_names},
                    jacobi_sweeps=nm._jacobi_sweeps,
                    psd_names=nm._psd_names)
                if dyn_names:
                    H_live, ch = project.project_family_to_pd(
                        H_live, eps, mirroring, elem_mask=live_valid,
                        jacobi_sweeps=nm._jacobi_sweeps)
                    n_proj_it = n_proj_it + torch.sum(ch.to(torch.int32))
            else:
                hess_stat_p, n_proj_it = hess_stat, zi()
            n_hess_it = project.count_elements(hess_stat, data)
            if dyn_names:
                n_hess_it = n_hess_it + n_live.to(torch.int32)
                pool = ev.live_pool(conn_live, H_live, use_direct)

            _conn, H_cat = ev.cat_with_live(topo.conn_cat, hess_stat_p)
            D = ev.diag_bucket(H_cat, topo, pool)
            Dinv = assembly.precondition_inverse(D)
            if use_direct:
                # persistent dense-inverse preconditioner tracked by
                # Newton-Schulz sweeps, refreshed when the pair shell is
                # (re)built or the last quality probe says it drifted
                need_m = need_p or bool(to_host(m_q > 0.5))
                if need_m:
                    M, m_q, was_cold = ev.ns_refresh(M, H_cat, topo, pool=pool)
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
            cg = solve_pcg(lambda p: ev.hvp_bucket(p, H_cat, topo, pool), Minv, -grad,
                           abs_tol, params["cg_rel_tolerance"],
                           s.cg_max_iterations, s.cg_stop_on_indefiniteness,
                           to_host=to_host)
            du = cg.x
            dug = torch.sum(du * grad)
            du_max = torch.max(torch.abs(du))
            reach_du = du_reach(du)
            step_conv = past_min & (du_max < params["step_tolerance"])
            dec_conv = torch.abs(dug) < 4.0 * noise
            lin_fail = torch.logical_not(cg.converged) \
                | ((dug >= 0.0) & torch.logical_not(dec_conv))

            # -------- line search (NewtonsMethod.cpp:459-641) --------
            # [cap]
            capped = du_max > params["step_cap"]
            retraction = torch.where(
                capped, params["step_cap"] / torch.clamp_min(du_max, 1e-30),
                torch.ones_like(du_max))
            # [max]: clamp the step to the remaining broad-shell budget (the
            # frozen intersection candidates stay a superset); a clamp
            # forces a broad rebuild at the next iteration
            if engine is not None:
                reach = dt * reach_du * retraction
                budget = torch.clamp_min(0.45 * slack_b - disp_b, 0.0)
                max_step = torch.where(reach > budget,
                                       budget / torch.clamp_min(reach, 1e-30),
                                       torch.ones_like(reach))
                maxed = max_step < 1.0
                retraction = retraction * max_step
                force_rb = maxed
            else:
                maxed = torch.zeros((), dtype=torch.bool, device=dev)
            du_ls = du * retraction
            step = torch.ones((), dtype=ftype, device=dev)

            # [inv]: halve until no frozen candidate intersects
            inv_it = 0
            inv_valid = torch.ones((), dtype=torch.bool, device=dev)
            if engine is not None and isect_on:
                inv_valid = torch.logical_not(isect_hit(u + step * du_ls, icands))
                while inv_it < max_inv and not bool(to_host(inv_valid)):
                    step = step * 0.5
                    inv_it += 1
                    inv_valid = torch.logical_not(isect_hit(u + step * du_ls, icands))
            inv_fail = torch.logical_not(inv_valid)

            # [bt] Armijo over the frozen tables
            def energy_at(step):
                return energy(u + step * du_ls, data, glob)

            expected = beta * dug * retraction
            bt_it = 0
            bt_fail = torch.zeros((), dtype=torch.bool, device=dev)
            bt_conv = torch.zeros((), dtype=torch.bool, device=dev)
            if enable_bt:
                # JAX re-evaluates the reference energy with the trial
                # energies' program (XLA fuses the two programs differently);
                # here both run the same element kernels and the same sums,
                # so energy_grad_hess's E0 is the same value, bit for bit
                E0a = E0
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
            done_t = init_bad | conv | lin_fail | step_conv | dec_conv \
                | inv_fail | bt_fail | bt_conv
            code = torch.where(
                init_bad, 2, torch.where(
                    conv | step_conv | dec_conv | bt_conv, 1, torch.where(
                        lin_fail, 5, torch.where(
                            inv_fail, 6, torch.where(bt_fail, 4, 0))))
            ).to(torch.int32)
            keep = init_bad | conv | step_conv | dec_conv | bt_conv | lin_fail
            u = torch.where(keep, u, u_new)

            cg_total += cg.n_iterations
            ls_cap = ls_cap + capped.to(torch.int32)
            ls_max = ls_max + maxed.to(torch.int32)
            ls_inv += inv_it
            ls_bt += bt_it
            n_proj = n_proj + n_proj_it
            n_hess = n_hess + n_hess_it
            E_prev = E0
            du_prev = reach_du
            n_broad_rb += int(need_b)
            n_pair_rb += int(need_p)
            it += 1
            done = bool(to_host(done_t))

        if not done:
            code = torch.full((), 1 if s.max_iterations_as_success else 3,
                              dtype=torch.int32, device=dev)
        # converged-state intersection test (EnergyFrictionalContact.cpp:25):
        # the final state lies inside the frozen candidates' budget
        if engine is not None and isect_on:
            code = torch.where((code == 1) & isect_hit(u, icands),
                               torch.full_like(code, 9), code)
        f32 = torch.float32

        def fv(x):
            return torch.as_tensor(x, device=dev).to(f32).reshape(())

        packed = torch.stack([
            fv(code), fv(it), fv(cg_total), fv(ls_cap), fv(ls_max), fv(ls_inv),
            fv(ls_bt), fv(n_proj), fv(n_hess), fv(res), fv(E_prev),
            fv(du_prev), fv(n_broad_rb), fv(n_pair_rb), fv(m_q), fv(n_cold),
        ])
        return u, packed, counts_max, M

    return fused_solve, count_keys
