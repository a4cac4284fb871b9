"""The linear solve of a Newton iteration, profiled on one CUDA card: JAX's
gather-table and dense-direct helpers (kernels AA, AB, AC) beside the
solver's own operator and preconditioners.

    python3 -m stark_tpu_torch.tools.profile_linsolve [--device cpu] [--n 32] [--seconds 0.4]

Builds bench.py's spinning_box_cloth at n x n (32: `chip_smoke.py` phase 7)
in float32 on the card, runs it for `--seconds` simulated seconds (0.4:
phase 7's state) and forms that state's Newton system as the fused solve
does (the static families projected, the live contact pool), then lays it
out as JAX's single bucket (every element padded to the largest arity, the
live rows after the static ones; stark_tpu's tools/profile_fused.py:220-231).
At that state it times, once warm:

  * kernel AA's three table builds (scatter_table, scatter_table_rows,
    direct_tables), each in a CUDA graph;
  * kernel AB's gather-table hvp against kernel B's hvp over the same
    single bucket and over the solver's two buckets (CUDA graphs);
  * kernel AC's dense assembly (a CUDA graph), then `dense_inverse` (one
    Cholesky and one triangular solve) against a cold and a warm
    Newton-Schulz refresh (`ns_refresh`, the fused solve's preconditioner),
    host launches between CUDA events;
  * PCG to the scene's tolerance (the fused solve's forcing term, its
    relative tolerance and iteration cap) on the solver's operator,
    preconditioned by the block Jacobi, the dense inverse and the cold and
    warm Newton-Schulz inverses: CG iterations and ms (host-driven loop),
    for the state's own right-hand side (-grad) and for a seeded one of the
    same norm;
  * `direct_solve` against the PCG solve preconditioned by the dense
    inverse: ms and the relative distance of the two solutions.

Prints one JSON line (`profile_linsolve: {...}`) and writes it to
chiprun_out/profile_linsolve/ at the repository root. TF32 is switched off,
so the GEMMs and the Cholesky run in full float32. Without a card it
refuses to run unless `--device cpu` is given; there the twins run and
every time is null (not measured).
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "profile_linsolve")
N_SBC, SECONDS = 32, 0.4
# JAX's table sizes (stark_tpu solver/newton.py and tools/profile_fused.py):
# level-1 width, hot side table, its width, dense slots
K, HOT_CAP, K2, SLOT_CAP = 128, 8, 256, 65536
RHS_SEED = 25


def run_scene(n: int, seconds: float, device: str):
    """bench.py's spinning box at n x n, float32, run for `seconds`."""
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    sim, _cloth, spin = spinning_box_cloth(n, "float32", device, name="profile_linsolve")
    sim.add_time_event(0.0, 10.0, spin)
    steps = int(round(seconds / sim.stark.settings.simulation.max_time_step_size))
    for i in range(steps):
        if not sim.run_one_time_step():
            raise AssertionError(f"profile_linsolve: step {i} failed")
    return sim


def single_bucket(ev, conn_static, H_static, conn_live=None, H_live=None):
    """JAX's single bucket (cat_with_live): the static rows then the live
    rows, each padded to the largest arity b (dummy id n_blocks, zero
    Hessian entries). Returns (conn (E, b) int64, H (E, 3b, 3b))."""
    parts = [(conn_static, H_static)] + ([(conn_live, H_live)] if conn_live is not None else [])
    b = max(c.shape[1] for c, _ in parts)
    conns, Hs = [], []
    for c, H in parts:
        a = c.shape[1]
        conns.append(F.pad(c.to(torch.int64), (0, b - a), value=ev.n_blocks))
        Hs.append(F.pad(H, (0, 3 * (b - a), 0, 3 * (b - a))))
    return torch.cat(conns), torch.cat(Hs).contiguous()


def linear_system(sim):
    """The Newton system at the simulation's state, as the fused solve forms
    it (static families projected, the live pool projected at d = 15), in
    the solver's two buckets and in JAX's single bucket."""
    from stark_tpu_torch.solver import project

    nm = sim.stark.newton
    ev, topo = nm._ev, nm._topo
    data = dict(sim._get_static_data())
    glob = sim._get_glob()
    u = sim._get_dofs().clone()
    eng = nm._engine()
    egh_csr = None
    if eng is not None:
        params = nm._engine_params(eng, u.dtype)
        th, slack_p = params["th"], params["slack_pair"]
        Vs, Vr = eng.world_from_u(u, params["eng_state"], glob["dt"])
        mc, _ic, _c = eng.broad_fn(Vs, Vr, th, params["slack_broad_min"], slack_p)
        tables, _c = eng.pairs_fn(Vs, Vr, th, mc, slack_p)
        data.update(tables)
        egh_csr = ev.egh_csr(data)
    _E, _aux, grad, hess = ev.energy_grad_hess(u, data, glob, topo, egh_csr)
    stat, dyn = ev.split_dyn(hess.keys())
    eps, sweeps = nm.settings.projection_eps, nm._jacobi_sweeps
    hp, _ = project.project_all({k: hess[k] for k in stat}, eps, False,
                                {k: data[k] for k in stat}, jacobi_sweeps=sweeps,
                                psd_names=nm._psd_names)
    _c, H_stat = ev.cat_with_live(topo.conn_cat, hp)
    pool, conn_live, H_live = None, None, None
    if dyn:
        conn_live, H_live, valid, _cnt = ev.live_select(
            ev.dyn_conn_cat(data), ev.dyn_hess_cat(hess), nm._pool_cap)
        H_live, _ch = project.project_family_to_pd(H_live, eps, False, elem_mask=valid,
                                                   jacobi_sweeps=sweeps)
        pool = ev.live_pool(conn_live, H_live, topo.pid_csr is not None)
    conn, H = single_bucket(ev, topo.conn_cat, H_stat, conn_live, H_live)
    return SimpleNamespace(ev=ev, nm=nm, topo=topo, pool=pool, H_stat=H_stat, conn=conn,
                           H=H, grad=grad.contiguous(), hess=hess, data=data)


def _timer(device):
    """(graph timer, host-launch timer) on the card; None (not measured)
    on the CPU."""
    if device.type != "cuda":
        return (lambda fn: None), (lambda fn, iters=5: None)
    from stark_tpu_torch.tools.timing import events_ms, graph_ms

    return graph_ms, (lambda fn, iters=5: events_ms(fn, iters=iters, warmup=1))


def profile(sim) -> dict:
    """The profile of the module docstring at the simulation's state."""
    from stark_tpu_torch.ops.hvp_bucket import hvp_bucket
    from stark_tpu_torch.ops.segment_reduce import build_csr
    from stark_tpu_torch.solver import assembly
    from stark_tpu_torch.solver.pcg import solve_pcg
    from stark_tpu_torch.solver.program import EagerControl

    st = linear_system(sim)
    ev, topo, pool = st.ev, st.topo, st.pool
    dev = st.grad.device
    graph_t, host_t = _timer(dev)
    n = ev.n_blocks
    E, b = st.conn.shape
    rows = st.conn.reshape(-1)
    ctx = {b: (st.conn, st.H, torch.ones(E, dtype=torch.bool, device=dev))}
    s = st.nm.settings
    out = {"device": str(dev), "dtype": str(st.grad.dtype).replace("torch.", ""),
           "n_blocks": n, "bucket": [E, b], "R": E * b, "K": K, "hot_cap": HOT_CAP,
           "K2": K2, "slot_cap": SLOT_CAP}

    # ---- AA: the three table builds
    entry, _R, max_len = ev.scatter_table(ctx, K)
    _e, _hi, _he, hot_n, max_deg = ev.scatter_table_rows(rows, K, HOT_CAP, K2)
    dtab = ev.direct_tables(st.conn, SLOT_CAP)
    out.update(max_len=int(max_len), hot_n=int(hot_n), max_deg=int(max_deg),
               n_slots=int(dtab.n_slots))
    if out["max_len"] > K or out["n_slots"] > SLOT_CAP:
        raise AssertionError(f"profile_linsolve: a table overflowed: {out}")
    out["scatter_table_ms"] = graph_t(lambda: ev.scatter_table(ctx, K))
    out["scatter_table_rows_ms"] = graph_t(lambda: ev.scatter_table_rows(rows, K, HOT_CAP, K2))
    out["direct_tables_ms"] = graph_t(lambda: ev.direct_tables(st.conn, SLOT_CAP))

    # ---- AB against kernel B, the single bucket and the solver's buckets
    p = (-st.grad).contiguous()
    conn32 = st.conn.to(torch.int32).contiguous()
    csr = build_csr(rows, n)
    q_tab = ev.hvp_table(p, ctx, entry)
    q_single = hvp_bucket(p, conn32, st.H, csr)
    q_solver = ev.hvp_bucket(p, st.H_stat, topo, pool)
    scale = float(torch.max(torch.abs(q_single)))
    out["hvp_table_vs_bucket_max_rel"] = float(torch.max(torch.abs(q_tab - q_single))) / scale
    out["hvp_single_vs_solver_max_rel"] = float(torch.max(torch.abs(q_single - q_solver))) / scale
    out["hvp_table_ms"] = graph_t(lambda: ev.hvp_table(p, ctx, entry))
    out["hvp_bucket_single_ms"] = graph_t(lambda: hvp_bucket(p, conn32, st.H, csr))
    out["hvp_bucket_solver_ms"] = graph_t(lambda: ev.hvp_bucket(p, st.H_stat, topo, pool))

    # ---- AC, dense_inverse and the Newton-Schulz refresh
    out["assemble_dense_perm_ms"] = graph_t(lambda: ev.assemble_dense_perm(st.H, dtab))
    M_di, ok = ev.dense_inverse(st.H, dtab)
    out["dense_inverse_ok"] = bool(ok)
    out["dense_inverse_ms"] = host_t(lambda: ev.dense_inverse(st.H, dtab))
    N1 = n + 1
    zeros = torch.zeros((3 * N1, 3 * N1), dtype=st.H.dtype, device=dev)
    ctl = EagerControl(read=ev.to_host)
    M_cold, q_cold, was_cold = ev.ns_refresh(zeros, st.H_stat, topo, pool=pool, ctl=ctl)
    M_warm, q_warm, _w = ev.ns_refresh(M_cold, st.H_stat, topo, pool=pool, ctl=ctl)
    out.update(ns_q_cold=float(q_cold), ns_went_cold=bool(was_cold), ns_q_warm=float(q_warm))
    out["ns_refresh_cold_ms"] = host_t(lambda: ev.ns_refresh(zeros, st.H_stat, topo,
                                                             pool=pool, ctl=ctl), iters=2)
    out["ns_refresh_warm_ms"] = host_t(lambda: ev.ns_refresh(M_cold, st.H_stat, topo,
                                                             pool=pool, ctl=ctl))

    # ---- PCG to the scene's tolerance under each preconditioner
    res = float(torch.max(torch.abs(st.grad)))
    forcing = min(1e-2, res * min(0.5, math.sqrt(res)))
    abs_tol = torch.as_tensor(max(forcing, s.cg_abs_tolerance), dtype=p.dtype, device=dev)
    Dinv = assembly.precondition_inverse(ev.diag_bucket(st.H_stat, topo, pool))
    precs = {"block_jacobi": lambda r: assembly.apply_preconditioner(Dinv, r),
             "dense_inverse": lambda r: ev.apply_dense_perm(M_di, r),
             "ns_cold": lambda r: ev.apply_dense_perm(M_cold, r),
             "ns_warm": lambda r: ev.apply_dense_perm(M_warm, r)}
    # the state's own right-hand side, and a seeded one of the same norm
    # (every mode of H, where a converged state's gradient has few)
    rng = np.random.default_rng(RHS_SEED)
    b_rand = torch.as_tensor(rng.normal(size=tuple(p.shape)), dtype=p.dtype, device=dev)
    b_rand = (b_rand * (torch.linalg.vector_norm(p) / torch.linalg.vector_norm(b_rand))).contiguous()
    out["pcg"] = {"grad": {}, "seeded": {}}
    sols = {}
    for rhs_name, rhs in (("grad", p), ("seeded", b_rand)):
        for name, Minv in precs.items():
            def solve(Minv=Minv, rhs=rhs):
                return solve_pcg(lambda v: ev.hvp_bucket(v, st.H_stat, topo, pool), Minv, rhs,
                                 abs_tol, s.cg_rel_tolerance, s.cg_max_iterations,
                                 s.cg_stop_on_indefiniteness, ctl=EagerControl(read=ev.to_host))
            r = solve()
            if rhs_name == "grad":
                sols[name] = r.x
            out["pcg"][rhs_name][name] = {"cg_iterations": int(r.n_iterations),
                                          "converged": bool(r.converged),
                                          "ms": host_t(solve, iters=2)}

    # ---- direct_solve against the PCG solve preconditioned by the inverse
    du, ok_d = ev.direct_solve(st.grad, st.H, dtab)
    x = sols["dense_inverse"]
    out["direct_solve_ok"] = bool(ok_d)
    out["direct_vs_pcg_max_rel"] = float(torch.max(torch.abs(du - x))) / max(
        float(torch.max(torch.abs(x))), 1e-300)
    Hdu = ev.hvp_bucket(du.contiguous(), st.H_stat, topo, pool)
    out["direct_residual_rel"] = float(torch.linalg.vector_norm(Hdu + st.grad)) / max(
        float(torch.linalg.vector_norm(st.grad)), 1e-300)
    out["direct_solve_ms"] = host_t(lambda: ev.direct_solve(st.grad, st.H, dtab))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=N_SBC)
    ap.add_argument("--seconds", type=float, default=SECONDS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_linsolve: no CUDA device is available (--device cpu runs "
              "the twins)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = None
    if args.device == "cuda":
        from stark_tpu_torch.tools.timing import card_line

        card = card_line()
        print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    sim = run_scene(args.n, args.seconds, args.device)
    res = {"card": card, "n": args.n, "seconds": args.seconds,
           "run_s": time.perf_counter() - t0, **profile(sim)}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"linsolve_{args.device}_{args.n}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("profile_linsolve: " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
