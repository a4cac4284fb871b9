"""Where a Newton iteration's time goes, on one CUDA card.

    python3 -m stark_tpu_torch.tools.profile_stages [--scene cloth|spinning_box]

`cloth` (the default) builds the 64x64 hanging cloth (Cotton_Fabric, 0.4 m,
two pinned corners) in float32, the scene of `chip_smoke.py` phase 4, and
runs 10 time steps; `spinning_box` builds bench.py's spinning_box_cloth at
32x32 in float32, `chip_smoke.py` phase 7, and runs 8 steps (0.27 s, the
cloth in contact over the box's top). At the state reached it times each stage of one
Newton iteration and profiles one more time step:

- energy_grad_hess, energy, PD projection, cat + diag + inverse: host
  launches between CUDA events, as the solver launches them;
- energy_grad_hess per family: each family's kernel (M-W) between CUDA
  events;
- the two kernels of one CG iteration (hvp_bucket + block3_apply): captured
  in a CUDA graph, so the time is the device's alone;
- one CG iteration of `solve_pcg` under the eager driver (kernel Y's two
  halves, its host read per iteration included);
- with contact, also: the broad shell (broad_fn), the pair shell (pairs_fn,
  its tables at their capacities as the fused solve keeps them), one [inv] trial (world
  positions and kernel H), the live pool (live_select, its projection at
  d=15 and its CSRs), and one Newton-Schulz refresh of the dense
  preconditioner;
- under torch.profiler, one time step (cloth) or one Newton iteration's
  stages (spinning box): wall time, device time and the device's busy
  share, the top device rows;
- the fused solve itself (K12): three more time steps recorded through
  the CUDA graph, each solve again under the eager driver from the same
  inputs (bit for bit), ms per Newton of both on graph replays, and the
  last such solve's eager kernel time under torch.profiler (the graph's
  bound on it, and its busy share inferred from it).

Prints the numbers and writes them, with the profiler table, to
chiprun_out/profile_stages/ at the repository root.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from stark_tpu_torch.solver.program import EagerControl
from stark_tpu_torch.tools import k12_checks
from stark_tpu_torch.tools.scenes import spinning_box_cloth
from stark_tpu_torch.tools.timing import card_line, events_ms, graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "profile_stages")
N, SIZE, STEPS = 64, 0.4, 10
N_SBC, STEPS_SBC = 32, 8


def hanging_cloth():
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    s = Settings()
    s.output.simulation_name = f"profile_stages_cloth_{N}"
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = "cuda"
    s.device.dtype = "float32"
    s.simulation.init_frictional_contact = False
    sim = Simulation(s)
    h = sim.presets.deformables.add_surface_grid(
        "cloth", (SIZE, SIZE), (N, N), SurfaceParams.Cotton_Fabric())
    hd = SIZE / 2.0
    for cx in (hd, -hd):
        sim.deformables.prescribed_positions.add_inside_aabb(
            h.point_set, (cx, hd, 0.0), (0.001, 0.001, 0.001),
            PrescribedPositionsParams())
    return sim


def egh_by_family(ev, u, data, glob) -> dict:
    """ms of one family's e, g and H as energy_grad_hess computes it (its
    kernel on the card, or torch.func where it has none), host launches
    between CUDA events."""
    from stark_tpu_torch.ops import egh

    return {name: events_ms(lambda fam=ev.fam_by_name[name], fd=fd: egh.evaluate(
        fam, u, fd["conn"], fd["rows"], glob), iters=5, warmup=1)
        for name, fd in data.items()}


def stages(sim) -> dict:
    """Time of each stage of one Newton iteration at the scene's state."""
    from stark_tpu_torch.solver import assembly, project
    from stark_tpu_torch.solver.pcg import solve_pcg

    nm = sim.stark.newton
    ev, topo = nm._ev, nm._topo
    data = sim._get_static_data()
    glob = sim._get_glob()
    u = sim._get_dofs().clone()
    _E, _aux, grad, hess = ev.energy_grad_hess(u, data, glob, topo)
    stat, _ = ev.split_dyn(hess.keys())
    hs = {k: hess[k] for k in stat}

    def proj():
        return project.project_all(hs, nm.settings.projection_eps, False,
                                   {k: data[k] for k in stat},
                                   jacobi_sweeps=nm._jacobi_sweeps,
                                   psd_names=nm._psd_names)

    hp, _ = proj()
    _c, H_cat = ev.cat_with_live(topo.conn_cat, hp)
    Dinv = assembly.precondition_inverse(ev.diag_bucket(H_cat, topo))
    b = -grad.contiguous()
    n_cg = 50

    def cg_kernels():
        ev.hvp_bucket(b, H_cat, topo)
        assembly.apply_preconditioner(Dinv, b)

    def cg_loop():
        # tolerances 0: exactly n_cg iterations of the real loop, syncs included
        solve_pcg(lambda p: ev.hvp_bucket(p, H_cat, topo),
                  lambda r: assembly.apply_preconditioner(Dinv, r),
                  b, 0.0, 0.0, n_cg, False, ctl=EagerControl(read=ev.to_host))

    return {
        "energy_grad_hess": events_ms(
            lambda: ev.energy_grad_hess(u, data, glob, topo), iters=5, warmup=1),
        "energy": events_ms(lambda: ev.energy(u, data, glob), iters=5, warmup=1),
        "pd_projection": events_ms(proj, iters=5, warmup=1),
        "cat_diag_inverse": events_ms(lambda: assembly.precondition_inverse(
            ev.diag_bucket(ev.cat_with_live(topo.conn_cat, hp)[1], topo))),
        "cg_iteration_kernels": graph_ms(cg_kernels),
        "cg_iteration": events_ms(cg_loop, iters=3, warmup=1) / n_cg,
        "energy_grad_hess_by_family": egh_by_family(ev, u, data, glob),
    }


def contact_stages(sim):
    """Time of each stage of one Newton iteration of the fused solve with
    contact, at the scene's state and its last step's velocities."""
    from stark_tpu_torch.solver import assembly, project
    from stark_tpu_torch.solver.pcg import solve_pcg

    nm = sim.stark.newton
    ev, topo = nm._ev, nm._topo
    eng = sim.interactions.contact.engine()
    static = sim._get_static_data()
    glob = sim._get_glob()
    u = sim._get_dofs().clone()
    params = nm._engine_params(eng, u.dtype)
    state, th, dt = params["eng_state"], params["th"], glob["dt"]
    slack_p, slack_b = params["slack_pair"], params["slack_broad_min"]
    Vs, Vr = eng.world_from_u(u, state, dt)
    mc, ic, _c = eng.broad_fn(Vs, Vr, th, slack_b, slack_p)

    def pairs():
        tables, _cnt = eng.pairs_fn(Vs, Vr, th, mc, slack_p)
        data = dict(static)
        data.update(tables)
        return data, ev.egh_csr(data)

    data, egh_csr = pairs()
    _E, _aux, grad, hess = ev.energy_grad_hess(u, data, glob, topo, egh_csr)
    stat, _dyn = ev.split_dyn(hess.keys())
    hs = {k: hess[k] for k in stat}
    eps, sweeps = nm.settings.projection_eps, nm._jacobi_sweeps
    dense = topo.pid_csr is not None

    def live():
        conn_live, H_live, valid, _cnt = ev.live_select(
            ev.dyn_conn_cat(data), ev.dyn_hess_cat(hess), nm._pool_cap)
        H_live, _ch = project.project_family_to_pd(
            H_live, eps, False, elem_mask=valid, jacobi_sweeps=sweeps)
        return ev.live_pool(conn_live, H_live, dense)

    pool = live()
    hp, _ = project.project_all(hs, eps, False, {k: data[k] for k in stat},
                                jacobi_sweeps=sweeps, psd_names=nm._psd_names)
    _c, H_cat = ev.cat_with_live(topo.conn_cat, hp)
    Dinv = assembly.precondition_inverse(ev.diag_bucket(H_cat, topo, pool))
    b = -grad.contiguous()
    n_cg = 50

    def cg_kernels():
        ev.hvp_bucket(b, H_cat, topo, pool)
        assembly.apply_preconditioner(Dinv, b)

    def cg_loop():
        solve_pcg(lambda p: ev.hvp_bucket(p, H_cat, topo, pool),
                  lambda r: assembly.apply_preconditioner(Dinv, r),
                  b, 0.0, 0.0, n_cg, False, ctl=EagerControl(read=ev.to_host))

    def inv_trial():
        Vs1, Vr1 = eng.world_from_u(0.5 * u, state, dt)
        return eng.isect_hit(Vs1, Vr1, ic)

    def iteration():
        """One Newton iteration's work, in the solve's order: pair shell,
        derivatives, live pool, projection, preconditioner, 10 CG
        iterations, one [inv] trial, three energies."""
        pairs()
        ev.energy_grad_hess(u, data, glob, topo, egh_csr)
        live()
        project.project_all(hs, eps, False, {k: data[k] for k in stat},
                            jacobi_sweeps=sweeps, psd_names=nm._psd_names)
        assembly.precondition_inverse(ev.diag_bucket(H_cat, topo, pool))
        solve_pcg(lambda p: ev.hvp_bucket(p, H_cat, topo, pool),
                  lambda r: assembly.apply_preconditioner(Dinv, r),
                  b, 0.0, 0.0, 10, False, ctl=EagerControl(read=ev.to_host))
        inv_trial()
        for _ in range(3):
            ev.energy(u, data, glob)

    out = {
        "energy_grad_hess": events_ms(
            lambda: ev.energy_grad_hess(u, data, glob, topo, egh_csr), iters=5, warmup=1),
        "energy": events_ms(lambda: ev.energy(u, data, glob), iters=5, warmup=1),
        "broad_fn": events_ms(lambda: eng.broad_fn(Vs, Vr, th, slack_b, slack_p),
                              iters=5, warmup=1),
        "pairs_fn": events_ms(pairs, iters=5, warmup=1),
        "inv_trial": events_ms(inv_trial, iters=5, warmup=1),
        "live_pool_select_project_csr": events_ms(live, iters=5, warmup=1),
        "pd_projection_static": events_ms(lambda: project.project_all(
            hs, eps, False, {k: data[k] for k in stat}, jacobi_sweeps=sweeps,
            psd_names=nm._psd_names), iters=5, warmup=1),
        "cat_diag_inverse": events_ms(lambda: assembly.precondition_inverse(
            ev.diag_bucket(ev.cat_with_live(topo.conn_cat, hp)[1], topo, pool))),
        "cg_iteration_kernels": graph_ms(cg_kernels),
        "cg_iteration": events_ms(cg_loop, iters=3, warmup=1) / n_cg,
        "pool_rows": int(pool.conn32.shape[0]),
        "contact_rows": {k: int(v["conn"].shape[0]) for k, v in data.items()
                         if k.startswith("contact_")},
        "energy_grad_hess_by_family": egh_by_family(ev, u, data, glob),
    }
    if dense and nm._M_dev is not None:
        out["ns_refresh"] = events_ms(lambda: ev.ns_refresh(
            nm._M_dev, H_cat, topo, pool=pool), iters=5, warmup=1)
    out["iteration"] = events_ms(iteration, iters=3, warmup=1)
    return out, iteration


def profiled(fn, tag: str) -> dict:
    """Wall and device time of fn() under torch.profiler: one time step of
    the cloth, or one Newton iteration's stages of the spinning box (a
    whole contact step records too many events for the profiler)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-only rows (kernels, copies, fills) carry no CPU time; the
    # operator rows above them would count the same device time twice
    dev_rows = [e for e in prof.key_averages() if e.self_cpu_time_total == 0]
    dev_us = sum(e.self_device_time_total for e in dev_rows)
    with open(os.path.join(OUT_DIR, f"profile_step_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": 1e3 * wall, "device_ms": dev_us / 1e3,
            "busy_share": dev_us / 1e3 / (1e3 * wall) if dev_us else None,
            "top": [[e.key[:60], e.self_device_time_total / 1e3] for e in top]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cloth", "spinning_box"), default="cloth")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stages: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    contact = args.scene == "spinning_box"
    if contact:
        sim, _cloth, spin = spinning_box_cloth(N_SBC, "float32",
                                               name="profile_stages_spinning_box")
        sim.add_time_event(0.0, 10.0, spin)
        n, steps = N_SBC, STEPS_SBC
    else:
        sim, n, steps = hanging_cloth(), N, STEPS
    t0 = time.perf_counter()
    for _ in range(steps):
        if not sim.run_one_time_step():
            raise AssertionError("a time step failed")
    torch.cuda.synchronize()
    logger = sim.get_logger()
    newton = int(logger.get_stats("newton_iterations").total)
    cg = int(logger.get_stats("cg_iterations").total)
    syncs = int(logger.get_stats("host_syncs").total)
    run = {"steps": steps, "newton": newton, "cg": cg,
           "host_syncs_per_newton": syncs / max(newton, 1),
           "ms_per_newton": 1e3 * (time.perf_counter() - t0) / max(newton, 1)}
    print(f"card: {card}", flush=True)
    name = f"stages_spinning_box_{n}.json" if contact else f"stages_{n}.json"
    result = {"card": card, "scene": args.scene, "n": n, "run": run}

    def save():
        print(json.dumps(result, indent=1), flush=True)
        with open(os.path.join(OUT_DIR, name), "w") as f:
            json.dump(result, f, indent=1)

    save()
    if contact:
        result["stages_ms"], iteration = contact_stages(sim)
        save()
        result["profiled_iteration"] = profiled(iteration, args.scene)
    else:
        result["stages_ms"] = stages(sim)
        save()

        def step():
            if not sim.run_one_time_step():
                raise AssertionError("the profiled time step failed")

        result["profiled_step"] = profiled(step, args.scene)
    save()
    result["fused_graph_vs_eager"] = k12_checks.window(sim, 3)
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
