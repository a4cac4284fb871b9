"""The fused projected-Newton solve of one time step, with frozen contact
shells, as one device program (K12).

Port of `stark_tpu/solver/fused.py`: energy, gradient and Hessian, PD
projection (static families per family, the live contact pool at d=15),
matrix-free BDPCG (block-Jacobi, or the persistent dense Newton-Schulz
inverse for small scenes), and the four line-search stages [cap] [max]
[inv] [bt]. The JAX program is one `lax.while_loop` with `lax.cond`s and
nested loops; here it is written once over a Control (solver/program.py):
the Newton loop, PCG, [inv] and [bt] are `ctl.while_`, the broad and pair
rebuilds, the initial-state test and the Newton-Schulz refresh (and its
cold start) `ctl.if_`. On the card the program is captured into one CUDA
graph whose loops are WHILE nodes and whose conditionals are IF nodes
(kernel X), replayed once per solve; the host reads the result once, at
the solve's end. On the CPU the same program runs under EagerControl. The
carry is JAX's Carry (:244-273): fixed shapes, updated in place; the
contact and friction tables stay at their capacities, as JAX keeps them
(rows past a count are inactive padding, which the element kernels
evaluate to zero); the outcome codes, the 16-float stats vector (and, 17th,
kernel Z's count of unconverged projections) and the count keys are
JAX's.

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

Lagged friction (`use_ff`: the engine is live and friction_enabled_now):
the friction tables are built once per solve from the dt = 0 positions
(engine.friction_tables: kernels I, E and J), their counts join the count
vector, and they join every Newton iteration's tables; their rows enter
the live pool with the contact rows.

Result codes (match SolverReturn):
  1 Successful, 2 InvalidInitialState, 3 TooManyIterations,
  4 TooManyArmijoIterations, 5 LinearSystemSolveFailure (or no-descent),
  6 TooManyInvalidIntermediateIterations, 9 InvalidConvergedState
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from . import assembly, project
from .pcg import solve_pcg
from .program import Program, flatten

BASE_COUNT_KEYS = ["hvp_pool", "direct_slots"]


def count_keys_of(engine, use_ff: bool = False):
    """Count keys of one solve: the engine's candidate and pair keys (and
    the friction tables' with use_ff), then the live-pool count
    (direct_slots stays 0: the port sizes no slots)."""
    keys = []
    if engine is not None:
        keys = engine.broad_count_keys() + engine.pair_count_keys()
        if use_ff:
            keys += engine.friction_count_keys()
    return list(dict.fromkeys(keys)) + list(BASE_COUNT_KEYS)


def uses_friction(engine) -> bool:
    """Whether the solve builds the lagged friction tables."""
    return engine is not None and engine.friction_enabled_now()


class FusedSolve:
    """The fused solve of build_fused_solve: f(u0, static_data, glob,
    params, M0, topo) -> (u, packed (17,) float32 stats, counts (n_keys,)
    int32, M). Each call binds its arguments to the Program of its key (a
    CUDA graph on the card, captured at the key's first call; the program
    under EagerControl on the CPU or with `eager`), keeping one Program:
    a new key (a grown capacity, other shapes) releases the old one. The
    outputs of a graph are its own buffers: the caller clones what it
    keeps."""

    def __init__(self, program, key_of, eager: bool = False, strict_ev=None):
        self.program = program
        self._key_of = key_of
        self.eager = eager
        self._strict_ev = strict_ev
        self._bound = None
        self._key = None
        self.captures = 0
        self.capture_seconds = 0.0
        self.driver_reads = 0

    def __call__(self, u0, static_data, glob, params, M0, topo):
        args = (u0, static_data, glob, params, M0, topo)
        key = (flatten(args)[1], self._key_of())
        if self._bound is None or key != self._key:
            self.release()
            graph = u0.device.type == "cuda" and not self.eager
            self._bound = Program(self.program, args, graph=graph,
                                  strict_ev=self._strict_ev)
            self._key = key
            if graph:
                self.captures += 1
                self.capture_seconds += self._bound.capture_seconds
        reads0 = self._bound.driver_reads
        out = self._bound(args)
        self.driver_reads += self._bound.driver_reads - reads0
        return out

    def release(self):
        if self._bound is not None:
            self._bound.release()
        self._bound = None
        self._key = None


def build_fused_solve(nm, engine=None, eager: bool = False, strict: bool = False):
    """Build the fused solve closed over the NewtonsMethod evaluators and
    the contact engine (or None). Returns (FusedSolve, count_keys). `eager`
    (internal: the smoke's and the card tests' comparison) runs the program
    under EagerControl on the card too; `strict` makes a host read inside a
    body raise."""

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
    use_ff = uses_friction(engine)
    count_keys = count_keys_of(engine, use_ff)
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

    def key_of():
        """What the program reads as Python values besides its arguments:
        the engine's capacities, the settings and the projection's sweeps."""
        caps = () if engine is None else tuple(sorted(engine._caps.items()))
        return (caps, repr(sorted(vars(s).items())), nm._jacobi_sweeps)

    def fused_solve(u0, static_data, glob, params, M0, topo, ctl):
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

        def zb():
            return torch.zeros((), dtype=torch.bool, device=dev)

        # the carry (stark_tpu fused.py:244-273), updated in place
        c = SimpleNamespace(
            u=u0.clone(), it=zi(), res0=fz(), done=zb(), code=zi(), cg_total=zi(),
            ls_cap=zi(), ls_max=zi(), ls_inv=zi(), ls_bt=zi(), n_proj=zi(),
            n_hess=zi(), res=fz(), E_prev=torch.zeros((), dtype=torch.float64, device=dev),
            stall=zi(), counts_max=torch.zeros((len(count_keys),), dtype=torch.int32,
                                               device=dev),
            slack_b=fz(), du_prev=params["du_prior"].to(ftype).clone(), force_rb=zb(),
            n_broad_rb=zi(), n_pair_rb=zi(),
            M=M0.clone() if use_direct else torch.zeros((0, 0), dtype=ftype, device=dev),
            m_q=torch.full((), 1e9, dtype=ftype, device=dev), n_cold=zi(),
            init_bad=zb(), eig_unconv=zi())
        # what the shell rebuilds bind (read only after their IF has run)
        sh = SimpleNamespace(bcands=None, icands={}, data=None, egh_csr=None)

        def fold(counts):
            # max, not set (a key may come from several builds)
            for k, v in counts.items():
                i = key_slot[k]
                c.counts_max[i] = torch.maximum(c.counts_max[i], v.to(torch.int32))

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

        def copy_pair(dst, src):
            for d, v in zip(dst, src):
                if d is not None:
                    d.copy_(v)

        def isect_hit(u, icands):
            if engine is None or not isect_on:
                return zb()
            Vs, Vr = world(u)
            return engine.isect_hit(Vs, Vr, icands)

        friction_tabs = {}
        if use_ff:
            # the lagged anchors freeze at the step-start state (x1 = x0,
            # bodies at t0, q0), as the reference's before_time_step pass;
            # mu and the stiffness are glob arguments
            Vs0, Vr0 = engine.step_start_world(eng_state)
            friction_tabs, ff_counts = engine.friction_tables(
                Vs0, Vr0, th, glob["mu_mat"], glob["contact_k"])
            fold(ff_counts)

        def full_data(tables):
            data = dict(static_data)
            data.update(tables)
            data.update(friction_tabs)
            return data

        if engine is not None:
            # the shells' build positions (zeros until iteration 0 builds)
            V0 = world(c.u)
            Vb = tuple(None if v is None else torch.zeros_like(v) for v in V0)
            Vp = tuple(None if v is None else torch.zeros_like(v) for v in V0)
        else:
            sh.data = full_data({})

        def newton_body():
            u = c.u
            first = c.it == 0
            # ---- shell validity guards + conditional rebuilds ----
            disp_b = fz()
            if engine is not None:
                Vs, Vr = world(u)
                disp_b = disp_from(Vb, Vs, Vr)
                need_b = first | c.force_rb | (disp_b > 0.45 * c.slack_b)

                def rebuild_broad():
                    c.slack_b.copy_(torch.clamp(
                        2.5 * dt * torch.clamp_min(c.du_prev, params["du_floor"]),
                        params["slack_broad_min"], params["slack_broad_max"]))
                    sh.bcands, sh.icands, cnt = engine.broad_fn(Vs, Vr, th, c.slack_b,
                                                                slack_p)
                    copy_pair(Vb, (Vs, Vr))
                    fold(cnt)

                ctl.if_(need_b, rebuild_broad)
                disp_b = torch.where(need_b, fz(), disp_b)
                need_p = need_b | (disp_from(Vp, Vs, Vr) > 0.45 * slack_p)

                def rebuild_pairs():
                    tables, cnt = engine.pairs_fn(Vs, Vr, th, sh.bcands, slack_p)
                    copy_pair(Vp, (Vs, Vr))
                    fold(cnt)
                    sh.data = full_data(tables)
                    sh.egh_csr = ev.egh_csr(sh.data)

                ctl.if_(need_p, rebuild_pairs)
                if isect_on:
                    def initial_state_test():
                        c.init_bad.copy_(isect_hit(u, sh.icands))

                    ctl.if_(first, initial_state_test)
            else:
                need_b = need_p = first
            data = sh.data

            E0, aux, grad, hess = egh(u, data, glob, topo, sh.egh_csr)
            # rounding-noise floors (quadrature form, see assembly.py)
            noise = (f_eps * torch.sqrt(aux["e_nsq"])).to(ftype)
            res = torch.max(torch.abs(grad))
            c.res0.copy_(torch.where(first, res, c.res0))

            past_min = c.it >= params["min_iterations"]
            stalled = (c.it > 0) & ((c.E_prev - E0) < noise.to(E0.dtype))
            c.stall.copy_(torch.where(stalled, c.stall + 1, zi()))
            vscale = torch.maximum(torch.max(torch.abs(u)), x_scale / dt)
            g_floor = f_eps * vscale * aux["hsum"]
            res_ok = torch.all(torch.abs(grad) <= torch.clamp_min(
                4.0 * g_floor, params["residual_tolerance_abs"]))
            conv = (res < params["bailout_residual"]) \
                | (past_min & res_ok) \
                | (past_min & (c.it > 0)
                   & (res / torch.clamp_min(c.res0, 1e-30)
                      < params["residual_tolerance_rel"])) \
                | (past_min & (c.stall >= 2))

            # PD projection: static families per family (PSD families
            # skipped); the contact families through their live pool
            stat_names, dyn_names = ev.split_dyn(hess.keys())
            hess_stat = {n: hess[n] for n in stat_names}
            pool = None
            n_live = None
            if dyn_names:
                conn_live, H_live, live_valid, live_cnt = ev.live_select(
                    ev.dyn_conn_cat(data), ev.dyn_hess_cat(hess), params["pool_cap"])
                i_pool = key_slot["hvp_pool"]
                c.counts_max[i_pool] = torch.maximum(c.counts_max[i_pool], live_cnt)
                n_live = torch.clamp_max(live_cnt, params["pool_cap"])
            if do_project:
                hess_stat_p, n_proj_it = project.project_all(
                    hess_stat, eps, mirroring,
                    {n: data[n] for n in stat_names},
                    jacobi_sweeps=nm._jacobi_sweeps,
                    psd_names=nm._psd_names, unconverged=c.eig_unconv)
                if dyn_names:
                    H_live, ch = project.project_family_to_pd(
                        H_live, eps, mirroring, elem_mask=live_valid,
                        jacobi_sweeps=nm._jacobi_sweeps, unconverged=c.eig_unconv)
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
                def refresh_m():
                    M, m_q, was_cold = ev.ns_refresh(c.M, H_cat, topo, pool=pool,
                                                     ctl=ctl)
                    c.M.copy_(M)
                    c.m_q.copy_(m_q)
                    c.n_cold.add_(was_cold.to(torch.int32))

                ctl.if_(need_p | (c.m_q > 0.5), refresh_m)
                m_good = c.m_q < 0.5

                def Minv(r):
                    qd = ev.apply_dense_perm(c.M, r)
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
                           s.cg_max_iterations, s.cg_stop_on_indefiniteness, ctl=ctl)
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
                budget = torch.clamp_min(0.45 * c.slack_b - disp_b, 0.0)
                max_step = torch.where(reach > budget,
                                       budget / torch.clamp_min(reach, 1e-30),
                                       torch.ones_like(reach))
                maxed = max_step < 1.0
                retraction = retraction * max_step
            else:
                maxed = zb()
            du_ls = du * retraction
            # the line search's carry
            ls = SimpleNamespace(step=torch.ones((), dtype=ftype, device=dev),
                                 inv_it=zi(), bt_it=zi())

            # [inv]: halve until no frozen candidate intersects
            inv_valid = torch.ones((), dtype=torch.bool, device=dev)
            if engine is not None and isect_on:
                inv_valid = torch.logical_not(isect_hit(u + ls.step * du_ls, sh.icands))

                def inv_body():
                    ls.step.mul_(0.5)
                    ls.inv_it.add_(1)
                    inv_valid.copy_(torch.logical_not(
                        isect_hit(u + ls.step * du_ls, sh.icands)))

                ctl.while_(lambda: torch.logical_not(inv_valid) & (ls.inv_it < max_inv),
                           inv_body)
            inv_fail = torch.logical_not(inv_valid)

            # [bt] Armijo over the frozen tables
            def energy_at(step):
                return energy(u + step * du_ls, data, glob)

            expected = beta * dug * retraction
            bt_fail = zb()
            bt_conv = zb()
            if enable_bt:
                # JAX re-evaluates the reference energy with the trial
                # energies' program (XLA fuses the two programs differently);
                # here both run the same element kernels and the same sums,
                # so energy_grad_hess's E0 is the same value, bit for bit
                E0a = E0
                disp1 = dt * reach_du * retraction
                step_floor = f_eps * x_scale / torch.clamp_min(disp1, 1e-30)
                E1 = energy_at(ls.step)

                def bt_more():
                    return (E1 >= E0a + expected * ls.step + noise) \
                        & (ls.bt_it < max_bt) & (ls.step > step_floor)

                def bt_body():
                    ls.step.mul_(0.5)
                    ls.bt_it.add_(1)
                    E1.copy_(energy_at(ls.step))

                ctl.while_(bt_more, bt_body)
                bt_exhausted = (E1 >= E0a + expected * ls.step + noise) \
                    & ((ls.bt_it >= max_bt) | (ls.step <= step_floor))
                # f32: exhausting the noise-tolerant Armijo means the
                # descent claim is cancellation noise -> converged at dtype
                # resolution; f64 keeps the reference's failure semantics
                if ftype == torch.float32:
                    bt_conv = bt_exhausted
                else:
                    bt_fail = bt_exhausted

            u_new = u + ls.step * du_ls

            # outcome resolution, in the reference's order of checks
            init_bad = c.init_bad & first
            done_t = init_bad | conv | lin_fail | step_conv | dec_conv \
                | inv_fail | bt_fail | bt_conv
            code = torch.where(
                init_bad, 2, torch.where(
                    conv | step_conv | dec_conv | bt_conv, 1, torch.where(
                        lin_fail, 5, torch.where(
                            inv_fail, 6, torch.where(bt_fail, 4, 0))))
            ).to(torch.int32)
            keep = init_bad | conv | step_conv | dec_conv | bt_conv | lin_fail
            c.u.copy_(torch.where(keep, u, u_new))

            c.cg_total.add_(cg.n_iterations)
            c.ls_cap.add_(capped.to(torch.int32))
            c.ls_max.add_(maxed.to(torch.int32))
            c.ls_inv.add_(ls.inv_it)
            c.ls_bt.add_(ls.bt_it)
            c.n_proj.add_(n_proj_it)
            c.n_hess.add_(n_hess_it)
            c.res.copy_(res)
            c.E_prev.copy_(E0)
            c.du_prev.copy_(reach_du)
            c.force_rb.copy_(maxed)
            c.n_broad_rb.add_(need_b.to(torch.int32))
            c.n_pair_rb.add_(need_p.to(torch.int32))
            c.code.copy_(code)
            c.done.copy_(done_t)
            c.it.add_(1)

        ctl.while_(lambda: torch.logical_not(c.done) & (c.it < params["max_iterations"]),
                   newton_body)

        # the loop ran out without an outcome -> TooManyIterations (or
        # success if so configured)
        code = torch.where(c.done, c.code, torch.full_like(
            c.code, 1 if s.max_iterations_as_success else 3))
        # converged-state intersection test (EnergyFrictionalContact.cpp:25):
        # the final state lies inside the frozen candidates' budget
        if engine is not None and isect_on and params["max_iterations"] > 0:
            code = torch.where((code == 1) & isect_hit(c.u, sh.icands),
                               torch.full_like(code, 9), code)
        packed = torch.stack([x.to(torch.float32).reshape(()) for x in (
            code, c.it, c.cg_total, c.ls_cap, c.ls_max, c.ls_inv, c.ls_bt, c.n_proj,
            c.n_hess, c.res, c.E_prev, c.du_prev, c.n_broad_rb, c.n_pair_rb, c.m_q,
            c.n_cold, c.eig_unconv)])
        return c.u, packed, c.counts_max, c.M

    return FusedSolve(fused_solve, key_of, eager=eager,
                      strict_ev=ev if strict else None), count_keys
