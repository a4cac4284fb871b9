"""Where a Newton iteration's time goes: the hanging cloth on one CUDA card.

    python3 -m stark_tpu_torch.tools.profile_stages

Builds the 64x64 hanging cloth (Cotton_Fabric, 0.4 m, two pinned corners)
in float32, the scene of `chip_smoke.py`'s main path, runs 10 time steps,
then at the state reached times each
stage of one Newton iteration and profiles one more time step:

- energy_grad_hess, energy, PD projection, cat + diag + inverse: host
  launches between CUDA events (torch.func launches many small kernels, as
  the solver does);
- the two kernels of one CG iteration (hvp_bucket + block3_apply): captured
  in a CUDA graph, so the time is the device's alone;
- one CG iteration of the real `solve_pcg` loop, its host sync included;
- one profiled time step (torch.profiler): wall time, device time and the
  device's busy share, the top device rows.

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

from stark_tpu_torch.tools.timing import card_line, events_ms, graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "profile_stages")
N, SIZE, STEPS = 64, 0.4, 10


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
                  b, 0.0, 0.0, n_cg, False, to_host=ev.to_host)

    return {
        "energy_grad_hess": events_ms(
            lambda: ev.energy_grad_hess(u, data, glob, topo), iters=5, warmup=1),
        "energy": events_ms(lambda: ev.energy(u, data, glob), iters=5, warmup=1),
        "pd_projection": events_ms(proj, iters=5, warmup=1),
        "cat_diag_inverse": events_ms(lambda: assembly.precondition_inverse(
            ev.diag_bucket(ev.cat_with_live(topo.conn_cat, hp)[1], topo))),
        "cg_iteration_kernels": graph_ms(cg_kernels),
        "cg_iteration": events_ms(cg_loop, iters=3, warmup=1) / n_cg,
    }


def profiled_step(sim) -> dict:
    """Wall and device time of one time step under torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if not sim.run_one_time_step():
            raise AssertionError("the profiled time step failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-only rows (kernels, copies, fills) carry no CPU time; the
    # operator rows above them would count the same device time twice
    dev_rows = [e for e in prof.key_averages() if e.self_cpu_time_total == 0]
    dev_us = sum(e.self_device_time_total for e in dev_rows)
    with open(os.path.join(OUT_DIR, "profile_step.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": 1e3 * wall, "device_ms": dev_us / 1e3,
            "busy_share": dev_us / 1e3 / (1e3 * wall) if dev_us else None,
            "top": [[e.key[:60], e.self_device_time_total / 1e3] for e in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_stages: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    sim = hanging_cloth()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        if not sim.run_one_time_step():
            raise AssertionError("a time step failed")
    torch.cuda.synchronize()
    logger = sim.get_logger()
    newton = int(logger.get_stats("newton_iterations").total)
    cg = int(logger.get_stats("cg_iterations").total)
    run = {"steps": STEPS, "newton": newton, "cg": cg,
           "ms_per_newton": 1e3 * (time.perf_counter() - t0) / max(newton, 1)}
    result = {"card": card, "n": N, "run": run, "stages_ms": stages(sim),
              "profiled_step": profiled_step(sim)}
    print(f"card: {card}")
    print(json.dumps(result, indent=1))
    with open(os.path.join(OUT_DIR, f"stages_{N}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
