#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`stark_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (every failure propagates; nothing is caught):
  1. the card's name and power limit; TF32 switched off for matmuls and
     cuDNN (the JAX package forces full-precision f32 products);
  2. build the kernels of stark_tpu_torch/csrc with nvcc (sm_90a);
  3. hold kernels A-D against their plain PyTorch twins on the card, in f32
     and f64, at the shapes of the 64x64 hanging cloth (the dense-assembly
     site of kernel A at the 32x32 cloth's, where that branch runs), and time
     kernel, twin and the one-call PyTorch yardstick where there is one;
  4. run the 64x64 hanging cloth (Cotton_Fabric, 0.4 m, two pinned corners)
     in float32 through Simulation.run_one_time_step and check it: finite,
     sagging, pins held, and every kernel of the path launched;
  5. run the 32x32 cloth in float32 (the dense Newton-Schulz branch);
  6. run the hanging_cloth_16 golden scene in float64 for 30 steps against
     the reference C++ trajectory in tests/golden/;
  7. run bench.py's spinning_box_cloth at 32x32 in float32 for 0.4 simulated
     seconds (the rigid box and frictionless IPC contact: kernels A-H), print
     bench.py's fields, and check it: finite, live contact pairs, no
     intersection, every kernel of the path launched;
  8. hold kernels E-H (and kernel C on the live contact pool, d=15) against
     their twins in f32 and f64 at the shapes of phase 7's final, draped
     state, and time them;
  9. run the spinning_box_cloth_16 golden scene in float64 against the
     reference trajectory, with tests/test_trajectory_parity.py's bounds
     (in a child process, `chip_smoke.py --golden-sbc16 OUT`, started after
     phase 2 and running beside phases 3-8);
 10. run the same 32x32 spinning box with Coulomb friction mu = 1 (cloth and
     box, cloth and itself) in float32 for 0.3 simulated seconds (lagged
     friction: kernels I and J besides A-H), print bench.py's fields and the
     live friction rows, check it (finite, friction rows, no intersection,
     every kernel of the path launched), then hold kernels I and J against
     their twins on the CPU in f32 and f64 at the final state and time them
     (in a child process, `chip_smoke.py --friction OUT`, started with
     phase 9's);
 11. print the kernels' JSON line, the card line, and the result line.

Exits non-zero without a CUDA device. Long logs (ptxas report,
summary.json) go to chiprun_out/chip_smoke/. Where a Newton iteration's time
goes is measured on demand by `python3 -m stark_tpu_torch.tools.profile_stages`.
"""
from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from stark_tpu_torch.tools.timing import card_line, events_ms, graph_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
GOLDEN = os.path.join(ROOT, "tests", "golden", "hanging_cloth_16.txt.gz")
GOLDEN_SBC = os.path.join(ROOT, "tests", "golden", "spinning_box_cloth_16.txt.gz")
DEVICE = "cuda"
N_MAIN, N_DENSE, MAIN_STEPS, DENSE_STEPS = 64, 32, 6, 3
N_SBC, SBC_SECONDS = 32, 0.4
FRICTION_MU, FRICTION_SECONDS = 1.0, 0.3

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores; f64 outside the tensor cores is half
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def log(msg=""):
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    tb = nbytes / MEM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------
def make_cloth(n: int, size: float, dtype: str, **sim_kw):
    from stark_tpu_torch import Settings, Simulation
    from stark_tpu_torch.models.deformables.energies import PrescribedPositionsParams
    from stark_tpu_torch.presets.presets import SurfaceParams

    s = Settings()
    s.output.simulation_name = f"chip_smoke_cloth_{n}"
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = DEVICE
    s.device.dtype = dtype
    s.simulation.init_frictional_contact = False
    for k, v in sim_kw.items():
        setattr(s.simulation, k, v)
    sim = Simulation(s)
    h = sim.presets.deformables.add_surface_grid(
        "cloth", (size, size), (n, n), SurfaceParams.Cotton_Fabric())
    return sim, h, PrescribedPositionsParams


def pin_top_corners(sim, h, Params, size, stiffness=None):
    hd = size / 2.0
    bc = Params() if stiffness is None else Params().set_stiffness(stiffness)
    for cx in (hd, -hd):
        sim.deformables.prescribed_positions.add_inside_aabb(
            h.point_set, (cx, hd, 0.0), (0.001, 0.001, 0.001), bc)


def make_spinning_box(n: int, dtype: str, adaptive: bool = True, mu: float = 0.0):
    """bench.py's spinning_box_cloth on DEVICE (with Coulomb friction mu
    between cloth and box and of the cloth with itself when mu > 0):
    (sim, cloth, spin(t))."""
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    return spinning_box_cloth(n, dtype, DEVICE, adaptive, name="chip_smoke_spinning_box",
                              mu=mu)


def frozen_inputs(sim, dense: bool, seed: int):
    """Initialize the scene, then one energy_grad_hess at a seeded random
    velocity: the tables, topology and element Hessians the main path
    hands the kernels."""
    from stark_tpu_torch.solver import project

    sim.stark._initialize()
    nm = sim.stark.newton
    ev = nm._ev
    data = sim._get_static_data()
    glob = sim._get_glob()
    topo = ev.topology(data, dense=dense)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(0.0, 0.05, (nm.n_blocks, 3)),
                        dtype=sim.stark.dtype, device=DEVICE)
    _E, _aux, _g, hess = ev.energy_grad_hess(u, data, glob, topo)
    stat, _ = ev.split_dyn(hess.keys())
    hp, _ = project.project_all({k: hess[k] for k in stat}, 1e-10, False,
                                {k: data[k] for k in stat}, jacobi_sweeps=8,
                                psd_names=nm._psd_names)
    _conn, H_cat = ev.cat_with_live(topo.conn_cat, hp)
    return nm, ev, data, topo, hess, H_cat


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------
def check(name, dtype, err, tol) -> float:
    """Element-wise |kernel - twin| <= tol; returns the max abs error."""
    err = err.double()
    ratio = float((err / tol.double()).max())
    worst = float(err.max())
    log(f"  {name:<28} {str(dtype):<14} max_abs_err={worst:.3e}  "
        f"max err/tol={ratio:.3f}  {'ok' if ratio <= 1.0 else 'FAIL'}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name} ({dtype}) disagrees with its twin: "
                             f"err/tol = {ratio:.3e}")
    return worst


def sum_tol(absref, dtype, k=64.0):
    """Tolerance of a sum taken in another order: k * eps * sum|terms|."""
    return k * torch.finfo(dtype).eps * absref + torch.finfo(dtype).tiny


def kernel_checks(ev64, topo64, hess64, H64, ev32, topo32, H32):
    from stark_tpu_torch.ops import block3, hvp_bucket as hb, pd_project as pd
    from stark_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(7)
    results = {}

    def payload_for(csr, width, dtype):
        return torch.as_tensor(rng.normal(size=(csr.n_rows, width)),
                               dtype=dtype, device=DEVICE)

    for dtype in (torch.float64, torch.float32):
        main = dtype == torch.float32   # the main path runs float32
        log(f"-- {dtype}")
        # ---- A at its three sites ----
        b = ev64.max_arity
        sites = {
            "egh": (topo64.egh_csr, payload_for(topo64.egh_csr, 9, dtype)),
            "diag": (topo64.csr_cat, torch.einsum(
                "eiaib->eiab", H64.to(dtype).reshape(-1, b, 3, b, 3)
            ).reshape(-1, 9).contiguous()),
            "dense": (topo32.pid_csr, H32.to(dtype).reshape(
                H32.shape[0], b, 3, b, 3).permute(0, 1, 3, 2, 4)
                .reshape(-1, 9).contiguous()),
        }
        for site, (csr, pay) in sites.items():
            out = sr.segment_reduce(pay, csr, site)
            ref = sr.segment_reduce_plain(pay, csr)
            absref = sr.segment_reduce_plain(pay.abs(), csr)
            torch.cuda.synchronize()
            err = check(f"segment_reduce[{site}]", dtype, (out - ref).abs(),
                        sum_tol(absref, dtype))
            if main:
                perm64 = csr.perm.to(torch.int64)
                rows = torch.full((csr.n_rows,), csr.n_seg, dtype=torch.int64,
                                  device=DEVICE)
                rows[perm64] = csr.seg
                lib = torch.zeros((csr.n_seg + 1, pay.shape[1]), dtype=dtype,
                                  device=DEVICE)
                # only the payload rows the CSR keeps (and their perm
                # entries) are read
                n_kept = int(csr.offsets[-1])
                kept = n_kept * pay.shape[1]
                bnd = bound_ms(kept * pay.element_size()
                               + nbytes(csr.perm[:n_kept], csr.offsets, out),
                               kept, dtype)
                results[f"segment_reduce[{site}]"] = dict(
                    max_abs_err=err,
                    ms=graph_ms(lambda: sr.segment_reduce(pay, csr, site)),
                    plain_ms=graph_ms(lambda: sr.segment_reduce_plain(pay, csr)),
                    library_ms=graph_ms(lambda: lib.index_add_(0, rows, pay)),
                    bound_ms=bnd[0], bound_by=bnd[1],
                    shape=f"payload {tuple(pay.shape)} -> ({csr.n_seg}, 9)")

        # ---- B ----
        Hd = H64.to(dtype).contiguous()
        p = torch.as_tensor(rng.normal(size=(ev64.n_blocks, 3)), dtype=dtype,
                            device=DEVICE)
        q = hb.hvp_bucket(p, topo64.conn_cat32, Hd, topo64.csr_cat)
        q_ref = hb.hvp_bucket_plain(p, topo64.conn_cat32, Hd, topo64.csr_cat)
        q_abs = hb.hvp_bucket_plain(p.abs(), topo64.conn_cat32, Hd.abs(),
                                    topo64.csr_cat)
        torch.cuda.synchronize()
        err = check("hvp_bucket", dtype, (q - q_ref).abs(), sum_tol(q_abs, dtype))
        if main:
            # the kernel reads, for each kept CSR entry (e, a), the 3 rows of
            # H_e at a and in them the 3 columns of each non-dummy block of
            # conn_e: 9 * n_e values per entry, 9 * n_e^2 per element
            real = (topo64.conn_cat32 < ev64.n_blocks).sum(1)
            b64 = topo64.conn_cat32.shape[1]
            csr_k = topo64.csr_cat
            perm_k = csr_k.perm[:int(csr_k.offsets[-1])]
            e_of = perm_k.to(torch.int64) // b64
            h_read = 9 * int(real[e_of].sum())
            bnd = bound_ms(h_read * Hd.element_size()
                           + nbytes(topo64.conn_cat32, p, perm_k, csr_k.offsets, q),
                           2.0 * h_read, dtype)
            results["hvp_bucket"] = dict(
                max_abs_err=err,
                ms=graph_ms(lambda: hb.hvp_bucket(
                    p, topo64.conn_cat32, Hd, topo64.csr_cat)),
                plain_ms=graph_ms(lambda: hb.hvp_bucket_plain(
                    p, topo64.conn_cat32, Hd, topo64.csr_cat)),
                library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
                shape=f"H {tuple(Hd.shape)} ({h_read} values read), "
                      f"p {tuple(p.shape)}")

        # ---- C: the triangle-strain stack (d=9) and a random indefinite
        # d=15 stack; compare rebuilt matrices (eigenvector signs are free)
        Ht = hess64["EnergyTriangleStrain"].to(dtype).contiguous()
        A15 = rng.normal(size=(4096, 15, 15))
        H15 = torch.as_tensor(0.5 * (A15 + A15.transpose(0, 2, 1)), dtype=dtype,
                              device=DEVICE)
        # rebuilt matrices, per matrix: |kernel - twin| <= 2000 eps max|H_e|
        # (the same rotations; only the rounding of atan2/cos/sin and of
        # the rebuild's sums differ)
        for label, Hc in (("pd_project[d9]", Ht), ("pd_project[d15]", H15)):
            mask = torch.as_tensor(rng.random(Hc.shape[0]) < 0.9, device=DEVICE)
            tol = 2000.0 * torch.finfo(dtype).eps * Hc.abs().amax(dim=(1, 2),
                                                                keepdim=True)
            for m in (None, mask):
                for mirroring in (False, True):
                    out, ch = pd.pd_project(Hc, 1e-10, mirroring, m, 8)
                    ref, ch_ref = pd.pd_project_plain(Hc, 1e-10, mirroring, m, 8)
                    torch.cuda.synchronize()
                    err = check(f"{label}{'' if m is None else '+mask'}"
                                f"{'+mirror' if mirroring else ''}", dtype,
                                (out - ref).abs(), tol + torch.finfo(dtype).tiny)
                    if main and label == "pd_project[d9]" and m is None \
                            and not mirroring:
                        err_main = err
            if main and label == "pd_project[d9]":
                E_, d_, _ = Ht.shape
                n_rounds = d_ if d_ % 2 else d_ - 1
                flops = E_ * (8 * n_rounds * 9 * d_ * d_ + 3 * d_ ** 3)
                out, ch = pd.pd_project(Ht, 1e-10, False, None, 8)
                bnd = bound_ms(nbytes(Ht, out, ch), flops, dtype)
                results["pd_project"] = dict(
                    max_abs_err=err_main,
                    ms=graph_ms(lambda: pd.pd_project(Ht, 1e-10, False, None, 8)),
                    # the twin copies its schedule from the host each call and
                    # eigh checks its result on the host: neither can be
                    # captured, so both are timed from host launches
                    plain_ms=events_ms(
                        lambda: pd.pd_project_plain(Ht, 1e-10, False, None, 8), iters=5),
                    library_ms=events_ms(lambda: torch.linalg.eigh(Ht), iters=5),
                    bound_ms=bnd[0], bound_by=bnd[1],
                    shape=f"H {tuple(Ht.shape)}, 8 sweeps")

        # ---- D: the real diagonal blocks plus exactly singular ones ----
        D = sr.segment_reduce_plain(sites["diag"][1], topo64.csr_cat).reshape(-1, 3, 3)
        D = D.clone()
        D[::97] = 0.0
        D[1::101] = torch.ones(3, 3, dtype=dtype, device=DEVICE)
        Di = block3.block3_inverse(D)
        Di_ref = block3.block3_inverse_plain(D)
        torch.cuda.synchronize()
        # per block: 64 eps * cond_inf(D_b) * max|D_b^-1| (the same cofactor
        # formulas; contraction into FMAs may differ)
        cond = D.abs().sum(-1).amax(-1) * Di_ref.abs().sum(-1).amax(-1)
        tol_b = (64.0 * torch.finfo(dtype).eps * cond
                 * Di_ref.abs().amax(dim=(1, 2)))[:, None, None] \
            + torch.finfo(dtype).tiny
        err_inv = check("block3_inverse", dtype, (Di - Di_ref).abs(), tol_b)
        r = torch.as_tensor(rng.normal(size=(D.shape[0], 3)), dtype=dtype,
                            device=DEVICE)
        z = block3.block3_apply(Di_ref, r)
        z_ref = block3.block3_apply_plain(Di_ref, r)
        z_abs = block3.block3_apply_plain(Di_ref.abs(), r.abs())
        torch.cuda.synchronize()
        err = check("block3_apply", dtype, (z - z_ref).abs(),
                    sum_tol(z_abs, dtype, k=8.0))
        if main:
            bnd = bound_ms(nbytes(D, Di), 40.0 * D.shape[0], dtype)
            results["block3_inverse"] = dict(
                max_abs_err=err_inv,
                ms=graph_ms(lambda: block3.block3_inverse(D)),
                plain_ms=graph_ms(lambda: block3.block3_inverse_plain(D)),
                library_ms=graph_ms(lambda: torch.linalg.inv_ex(D)),
                bound_ms=bnd[0], bound_by=bnd[1], shape=f"D {tuple(D.shape)}")
            bnd = bound_ms(nbytes(Di, r, z), 15.0 * D.shape[0], dtype)
            results["block3_apply"] = dict(
                max_abs_err=err,
                ms=graph_ms(lambda: block3.block3_apply(Di_ref, r)),
                plain_ms=graph_ms(lambda: block3.block3_apply_plain(Di_ref, r)),
                library_ms=graph_ms(lambda: torch.bmm(Di_ref, r[:, :, None])),
                bound_ms=bnd[0], bound_by=bnd[1], shape=f"Dinv {tuple(Di.shape)}")
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the port's main path
# ---------------------------------------------------------------------------
def run_steps(sim, n_steps):
    from stark_tpu_torch.ops import build

    logger = sim.get_logger()
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ok = sim.run_one_time_step()
        if not ok:
            raise AssertionError("a time step failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    newton = int(logger.get_stats("newton_iterations").total)
    cg = int(logger.get_stats("cg_iterations").total)
    syncs = int(logger.get_stats("host_syncs").total)
    steps = sim.stark.current_time_step
    log(f"  steps={steps} newton={newton} cg={cg} wall={wall:.3f}s "
        f"ms/newton={1e3 * wall / max(newton, 1):.2f} "
        f"host_syncs/step={syncs / max(steps, 1):.1f}")
    return launches, dict(steps=steps, newton=newton, cg=cg, wall_s=wall,
                          ms_per_newton=1e3 * wall / max(newton, 1),
                          host_syncs_per_step=syncs / max(steps, 1))


# ---------------------------------------------------------------------------
# phase 8: kernels E-H against their twins on the draped spinning box
# ---------------------------------------------------------------------------
def contact_state(sim):
    """The engine, world positions at the current state (u = 0: the cloth
    and box where the last accepted step left them), thicknesses, and the
    live contact pool of one energy evaluation there."""
    eng = sim.interactions.contact.engine()
    nm = sim.stark.newton
    dt = torch.as_tensor(sim.stark.dt, dtype=sim.stark.dtype, device=DEVICE)
    u = torch.zeros((nm.n_blocks, 3), dtype=sim.stark.dtype, device=DEVICE)
    Vs, Vr = eng.world_from_u(u, eng.engine_state(), dt)
    return eng, nm, u, Vs, Vr


def live_pool_hessians(sim, eng, nm, u, Vs, Vr, slack_b, slack_p):
    """The live contact pool's element Hessians (pool_cap, 15, 15) at the
    state: pair tables, energy_grad_hess and live_select as the solve runs
    them."""
    ev = nm._ev
    th = eng.th_vec()
    mc, _ic, _c = eng.broad_fn(Vs, Vr, th, slack_b, slack_p)
    tables, _c = eng.pairs_fn(Vs, Vr, th, mc, slack_p)
    static = sim._get_static_data()
    data = dict(static)
    data.update(tables)
    topo = ev.topology(static, dense=False)
    _E, _aux, _g, hess = ev.energy_grad_hess(u, data, sim._get_glob(), topo,
                                             ev.egh_csr(data))
    _conn, H_live, valid, cnt = ev.live_select(
        ev.dyn_conn_cat(data), ev.dyn_hess_cat(hess), nm._pool_cap)
    return H_live, valid, int(cnt)


def contact_kernel_checks(sim):
    """Kernels E-H on the shapes of the draped 32x32 spinning box, f32 and
    f64 (the f64 inputs are the f32 state cast up), plus kernel C on the
    live pool at d=15. Returns the timing records of the float32 pass."""
    from stark_tpu_torch.ops import ball_wide as bw, compact as cp
    from stark_tpu_torch.ops import narrow as nw, pd_project as pd
    from stark_tpu_torch.ops import segment_triangle as st
    from stark_tpu_torch.ops.compact import compact_plain

    eng, nm, u32, Vs32, Vr32 = contact_state(sim)
    results = {}
    slack_p = 0.002
    slack_b = 0.016
    f = lambda x: torch.as_tensor(x, dtype=sim.stark.dtype, device=DEVICE)
    H_pool, valid, n_live = live_pool_hessians(sim, eng, nm, u32, Vs32, Vr32,
                                               f(slack_b), f(slack_p))
    for dtype in (torch.float64, torch.float32):
        main = dtype == torch.float32
        log(f"-- {dtype}")
        Vcat = eng._vcat(Vs32, Vr32).to(dtype).contiguous()
        th = eng.th_vec().to(dtype)
        th_p, th_t, th_e = th[eng.d_p_mesh], th[eng.d_t_mesh], th[eng.d_e_mesh]
        sb = torch.as_tensor(slack_b, dtype=dtype, device=DEVICE)
        margin = torch.as_tensor(slack_b + slack_p, dtype=dtype, device=DEVICE)
        pad = eng._bound_pad(Vcat)
        eps = torch.finfo(dtype).eps
        scale = 1.0 + float(Vcat.abs().max())

        # ---- F: the three ball lists of a broad build ----
        m, h = eng._edge_balls(Vcat)
        c, r = eng._tri_balls(Vcat)
        balls = {
            "w_pt": (Vcat, th_p, c, r + th_t, eng.d_pt_allowed, margin + pad),
            "w_ee": (m, h + th_e, m, h + th_e, eng.d_ee_allowed, margin + pad),
            "w_et": (m, h, c, r, eng.d_et_allowed, sb + pad),
        }
        lists = {}
        for key, args in balls.items():
            cap = eng._cap(key)
            q, t, cnt = bw.ball_wide(*args, cap)
            q_ref, t_ref, cnt_ref = bw.ball_wide_plain(*args, cap)
            torch.cuda.synchronize()
            same = (torch.equal(q, q_ref) and torch.equal(t, t_ref)
                    and int(cnt) == int(cnt_ref))
            log(f"  ball_wide[{key}] {str(dtype):<14} pairs={int(cnt)} "
                f"grid={args[0].shape[0]}x{args[2].shape[0]} cap={cap} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"ball_wide[{key}] ({dtype}) differs from its twin")
            act = torch.arange(cap, device=DEVICE) < torch.clamp_max(cnt, cap)
            lists[key] = (q, t, act, args)

        # ---- G: exact distances over the wide PT and EE lists ----
        q, t, act, _ = lists["w_pt"]
        bound = th_p[q.long()] + th_t[t.long()] + margin
        g_pt = (Vcat, Vcat, eng.d_tris_all, q, t, act, None, bound)
        d, keep = nw.pt_distance(*g_pt)
        d_ref, keep_ref = nw.pt_distance_plain(*g_pt)
        torch.cuda.synchronize()
        err_pt = check("pt_ee_distance[pt]", dtype, (d - d_ref).abs(),
                       torch.full_like(d, 64 * eps * scale))
        far = ((d_ref - bound).abs() > 64 * eps * scale)
        if not torch.equal(keep[far], keep_ref[far]):
            raise AssertionError("pt_ee_distance[pt] keep mask differs")
        a, b, act_e, _ = lists["w_ee"]
        bound_e = th_e[a.long()] + th_e[b.long()] + margin
        ptol = sim.interactions.contact.edge_edge_cross_norm_sq_cutoff
        g_ee = (Vcat, eng.d_edges_all, a, b, ptol, act_e, bound_e)
        d_e, keep_e = nw.ee_distance(*g_ee)
        d_e_ref, keep_e_ref = nw.ee_distance_plain(*g_ee)
        torch.cuda.synchronize()
        # the line-line formula cancels within a factor of the parallel
        # cutoff: sqrt(eps) there, 64 eps on every other row
        near = nw.ee_near_cutoff(Vcat, eng.d_edges_all, a, b, ptol) & act_e
        tol_e = torch.full_like(d_e, 64 * eps * scale)
        tol_e[near] = 8 * eps ** 0.5 * scale
        err_ee = check("pt_ee_distance[ee]", dtype, (d_e - d_e_ref).abs(), tol_e)
        far = ~near & ((d_e_ref - bound_e).abs() > 64 * eps * scale)
        if not torch.equal(keep_e[far], keep_e_ref[far]):
            raise AssertionError("pt_ee_distance[ee] keep mask differs")
        log(f"  pt_ee_distance[ee] {str(dtype):<14} rows near the parallel "
            f"cutoff: {int(near.sum())} of {int(act_e.sum())} active")

        # ---- E: the refine compaction of the wide EE list's keep mask ----
        cap_m = eng._cap("m_ee")
        keep_e = keep_e_ref.contiguous()
        idx, cnt = cp.compact(keep_e, cap_m, "check")
        idx_ref, cnt_ref = compact_plain(keep_e, cap_m)
        torch.cuda.synchronize()
        same = torch.equal(idx, idx_ref) and int(cnt) == int(cnt_ref)
        log(f"  compact[refine_ee]           {str(dtype):<14} n={keep_e.numel()} "
            f"count={int(cnt)} cap={cap_m} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("compact differs from its twin")

        # ---- H: any-hit over the intersection candidates ----
        e_, t_, act_h, _ = lists["w_et"]
        d_mid, keep_h = nw.pt_distance(m, Vcat, eng.d_tris_all, e_, t_, act_h,
                                       h[e_.long()], sb.reshape(1).expand(e_.shape[0]))
        (e_, t_, act_h), _c = eng._refine(e_, t_, keep_h, eng._cap("im_et"), "check")
        no = torch.zeros((), dtype=torch.bool, device=DEVICE)
        h_args = (Vcat, eng.d_edges_all, eng.d_tris_all, e_, t_, act_h, no)
        verdicts = []
        for case in ("draped", "moved"):
            if case == "moved":
                # every candidate's triangle translated onto its edge's midpoint
                Vm = Vcat.clone()
                tri = eng.d_tris_all[t_[0].long()].long()
                mid = m[e_[0].long()]
                Vm[tri] += mid - Vm[tri].mean(0)
                h_args = (Vm,) + h_args[1:]
            out = st.segment_triangle_any(*h_args)
            ref = st.segment_triangle_any_plain(*h_args)
            torch.cuda.synchronize()
            verdicts.append((bool(out), bool(ref)))
            if bool(out) != bool(ref):
                raise AssertionError(f"segment_triangle_any ({case}) differs")
        log(f"  segment_triangle_any         {str(dtype):<14} rows={e_.shape[0]} "
            f"verdicts(draped, moved)={verdicts} ok")
        h_args = (Vcat,) + h_args[1:]

        # ---- C on the live pool (d = 15) ----
        H_live = H_pool.to(dtype)
        out_c, _ch = pd.pd_project(H_live, 1e-10, False, valid, 8)
        ref_c, _ch = pd.pd_project_plain(H_live, 1e-10, False, valid, 8)
        torch.cuda.synchronize()
        tol = 2000.0 * eps * H_live.abs().amax(dim=(1, 2), keepdim=True)
        check(f"pd_project[pool d15 n={n_live}]", dtype, (out_c - ref_c).abs(),
              tol + torch.finfo(dtype).tiny)

        if not main:
            continue
        # ---- timings and bounds (float32, the main path's dtype) ----
        el = Vcat.element_size()
        A, ra, B, rb, allowed, extra = balls["w_ee"]
        cap_w = eng._cap("w_ee")
        npairs = int(lists["w_ee"][2].sum())
        Na, Nb = A.shape[0], B.shape[0]
        # inputs read once (the (Na, Nb) allowed bytes, the balls and their
        # squared norms), the (cap,) q and t lists and the count written
        # once; 12 flops per pair test
        bnd = bound_ms(Na * Nb + nbytes(A, ra, B, rb) + el * (Na + Nb) + 8 * cap_w + 4,
                       12.0 * Na * Nb, dtype)

        def lib_ball():
            a2 = (A * A).sum(-1)
            b2 = (B * B).sum(-1)
            rhs = ra[:, None] + rb[None, :] + extra
            mask = allowed.bool() & (a2[:, None] + b2[None, :] - 2.0 * (A @ B.T)
                                     <= rhs * rhs)
            return torch.nonzero(mask)

        results["ball_wide"] = dict(
            max_abs_err=0.0,
            ms=graph_ms(lambda: bw.ball_wide(A, ra, B, rb, allowed, extra, cap_w)),
            plain_ms=events_ms(lambda: bw.ball_wide_plain(A, ra, B, rb, allowed,
                                                          extra, cap_w), iters=5),
            library_ms=events_ms(lib_ball, iters=5),
            bound_ms=bnd[0], bound_by=bnd[1],
            shape=f"w_ee: {Na}x{Nb} balls, {npairs} pairs, cap {cap_w}")
        n = keep_e.numel()
        ncnt = int(keep_e.sum())
        # the mask read once, the (cap,) index buffer and the count written
        bnd = bound_ms(n + 4 * cap_m + 4, 0.0, dtype)
        results["compact"] = dict(
            max_abs_err=0.0,
            ms=graph_ms(lambda: cp.compact(keep_e, cap_m, "check")),
            plain_ms=events_ms(lambda: compact_plain(keep_e, cap_m), iters=5),
            library_ms=events_ms(lambda: torch.nonzero(keep_e), iters=5),
            bound_ms=bnd[0], bound_by=bnd[1],
            shape=f"refine_ee: mask ({n},), {ncnt} set, cap {cap_m}")
        # G: the vertices and the primitive table read once; per row the two
        # indices, act and the bound read, d and keep written; ~100 flops
        # per row (region test and one distance formula)
        for key, args, fn, fn_plain, err in (
                ("pt_ee_distance[pt]", g_pt, nw.pt_distance, nw.pt_distance_plain,
                 err_pt),
                ("pt_ee_distance[ee]", g_ee, nw.ee_distance, nw.ee_distance_plain,
                 err_ee)):
            pt = key.endswith("[pt]")
            R = args[3].shape[0] if pt else args[2].shape[0]
            table = eng.d_tris_all if pt else eng.d_edges_all
            bnd = bound_ms(nbytes(Vcat, table) + R * (8 + 1 + el + el + 1),
                           100.0 * R, dtype)
            results[key] = dict(
                max_abs_err=err,
                ms=graph_ms(lambda fn=fn, args=args: fn(*args)),
                plain_ms=graph_ms(lambda fn=fn_plain, args=args: fn(*args)),
                library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
                shape=f"{R} rows")
        # H: the vertices and both primitive tables read once, act of every
        # row, the two indices of the active rows only (the kernel skips the
        # others), the flag read and written; ~80 flops per active row
        R = h_args[3].shape[0]
        n_act = int(h_args[5].sum())
        bnd = bound_ms(nbytes(Vcat, eng.d_edges_all, eng.d_tris_all) + R
                       + 8 * n_act + 2, 80.0 * n_act, dtype)
        results["segment_triangle_any"] = dict(
            max_abs_err=0.0,
            ms=graph_ms(lambda: st.segment_triangle_any(*h_args)),
            plain_ms=graph_ms(lambda: st.segment_triangle_any_plain(*h_args)),
            library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
            shape=f"im_et: {R} rows, {n_act} active")
    return results


def run_spinning_box(sim, spin_steps):
    """Phase 7: step the scene with bench.py's bookkeeping; the counts of
    the kernels are set to 0 just before and read just after."""
    from stark_tpu_torch.ops import build

    logger = sim.get_logger()
    count_max, live, fric = {}, [], []
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_warm = None
    for i in range(spin_steps):
        if not sim.run_one_time_step():
            raise AssertionError(f"spinning box step {i} failed")
        if i == 0:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
            warm_newton = int(logger.get_stats("newton_iterations").total)
        nm = sim.stark.newton
        for k, v in nm._last_counts.items():
            count_max[k] = max(count_max.get(k, 0), int(v))
        live.append(nm.live_contact_pairs())
        fric.append(nm.friction_rows())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(build.launches)
    newton = int(logger.get_stats("newton_iterations").total)
    cg = int(logger.get_stats("cg_iterations").total)
    syncs = int(logger.get_stats("host_syncs").total)
    steps = sim.stark.current_time_step
    warm = newton - warm_newton
    fields = {
        "newton_iters_per_s": warm / (t1 - t_warm) if t1 > t_warm else 0.0,
        "ms_per_newton_iter": 1e3 * (t1 - t_warm) / max(warm, 1),
        "cg_per_newton": cg / max(newton, 1),
        "broad_rebuilds": int(logger.get_stats("broad_rebuilds").total),
        "pair_rebuilds": int(logger.get_stats("pair_rebuilds").total),
        "fused_retraces": int(logger.get_int("fused_retraces")),
        "count_max": dict(sorted(count_max.items())),
        "live_pairs_last": live[-1], "live_pairs_max": max(live),
        "friction_rows_last": fric[-1], "friction_rows_max": max(fric),
        "host_syncs_per_step": syncs / max(steps, 1),
        "steps": steps, "sim_seconds": sim.get_time(), "newton_iters": newton,
        "wall_s": t1 - t0, "first_step_s": t_warm - t0,
        "solver_codes": [int(c) for c in logger.series["solver_code"]],
    }
    return launches, fields


def intersects_now(sim) -> bool:
    """Does any edge cross any triangle at the current state (u = 0)?"""
    eng, _nm, _u, Vs, Vr = contact_state(sim)
    zero = torch.zeros((), dtype=sim.stark.dtype, device=DEVICE)
    icands, _counts = eng._isect_stage1(eng._vcat(Vs, Vr), zero)
    return bool(eng.isect_hit(Vs, Vr, icands))


def load_golden(path):
    steps = []
    with gzip.open(path, "rt") as f:
        cur = None
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("step"):
                cur = []
                steps.append(cur)
            else:
                cur.append([float(v) for v in line.split()])
    return [np.asarray(s) for s in steps]


def golden_sbc16(out_json: str) -> int:
    """Phase 9's work, run as `chip_smoke.py --golden-sbc16 OUT_JSON`: the
    spinning_box_cloth_16 scene in float64 with fixed 1/30 s steps against
    the reference trajectory; writes the per-step max vertex deviations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = load_golden(GOLDEN_SBC)
    sim, cloth, spin = make_spinning_box(16, "float64", adaptive=False)
    devs = []
    t0 = time.perf_counter()
    for step in range(len(golden)):
        spin(sim.get_time())
        if not sim.run_one_time_step():
            raise AssertionError(f"golden step {step} failed")
        devs.append(float(np.max(np.linalg.norm(
            cloth.point_set.get_positions() - golden[step], axis=1))))
    with open(out_json, "w") as f:
        json.dump({"devs": devs, "seconds": time.perf_counter() - t0}, f)
    return 0


def start_child(flag: str, name: str):
    """Start `chip_smoke.py FLAG OUT_JSON` in a child process; (process,
    result path, log file), both files in OUT_DIR."""
    path = os.path.join(OUT_DIR, name + ".json")
    if os.path.exists(path):
        os.remove(path)
    logf = open(os.path.join(OUT_DIR, name + ".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, path],
        stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, path, logf


def finish_child(child, what: str) -> dict:
    """Wait for a child and return the results it wrote; raise with the
    tail of its log if it failed."""
    proc, path, logf = child
    rc = proc.wait()
    logf.flush()
    if rc != 0 or not os.path.exists(path):
        with open(logf.name) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"{what} failed (exit {rc}):\n{tail}")
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# phase 10: the spinning box with lagged friction, kernels I and J
# ---------------------------------------------------------------------------
# Operation counts of the device functions that I and J run, per distance
# region, counted in narrow.cuh and friction_rows.cu: an add, subtract,
# multiply, divide, square root or log is one, an FMA two; compares and
# selects are none; a subexpression repeated with the same operands once.
# Building blocks: a 3-vector difference 3, dot 5, cross 9 (three FMAs and
# three products), normalized 9 (a dot, a sqrt, three divides).
# Region tests, the cheapest branch through each:
#   PT 108: cross(t1-t0, t2-t0) 15, and 3 edge_param of 31 each (e 3,
#       |e|^2 5, p-e0 3, s 5+1, cross(e, n) 9, o 5);
#   EE 56: u, v, w 9, five dots 25, D 3, |u x v|^2 14, the parallel cut 2,
#       sN 3 (the parallel branch's alpha and beta cost 18).
REGION_OPS = {"pt": 108, "ee": 56}
# narrow.cuh's squared distance per region, plus the sqrt: point-point 8,
# point-line 24, point-plane 30, line-line 42
DIST_OPS = {"pt": [9, 9, 9, 25, 25, 25, 31], "ee": [9] * 4 + [25] * 4 + [43]}
# friction_rows.cu per region, the anchor and the tangent basis:
# proj_point_point 48; edge_alpha 17 (+1 for PT's 1 - alpha) and
# proj_point_edge 33; PT's face barycentric 47 and proj_triangle 42; EE's
# line parameters 39 (the parallel branch, the cheaper) and proj_edge_edge 42
ROW_OPS = {"pt": [48] * 3 + [51] * 3 + [89], "ee": [48] * 4 + [50] * 4 + [81]}
# barrier_force: Cubic k * gap^2 3; Log 9
FN_OPS = {"Cubic": 3, "Log": 9}


def region_hist(kind, V, table, keep, ptol):
    """Histogram of the distance regions over the pairs kernel I evaluates
    (the (Nq, Nt) mask `keep`: allowed and mu != 0), by the twin's
    classifier on the card, in chunks."""
    from stark_tpu_torch.collision import narrow_phase as nph

    n_reg = len(DIST_OPS[kind])
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
    nt = keep.shape[1]
    hist = torch.zeros(n_reg, dtype=torch.int64, device=V.device)
    for s in range(0, idx.numel(), 1 << 21):
        k = idx[s:s + (1 << 21)]
        i, j = k // nt, k % nt
        if kind == "pt":
            tri = table[j].long()
            reg = nph.point_triangle_region(V[i], V[tri[:, 0]], V[tri[:, 1]], V[tri[:, 2]])
        else:
            ea, eb = table[i].long(), table[j].long()
            reg = nph.edge_edge_region(V[ea[:, 0]], V[ea[:, 1]], V[eb[:, 0]], V[eb[:, 1]],
                                       ptol)
        hist += torch.bincount(reg.long(), minlength=n_reg)
    return hist.cpu()


def ops_of(hist, per_region, base) -> float:
    """Operations of rows with this region histogram."""
    return float(sum(int(c) * (base + per_region[r]) for r, c in enumerate(hist)))


def _row_amp(x32, x64):
    """Per row, |x32 - x64| in units of the float32 eps: how far the row's
    rounding is amplified (ill-conditioned tangent bases, line parameters of
    nearly parallel edges)."""
    d = (x32.double() - x64.double()).abs().reshape(x32.shape[0], -1).amax(1)
    return d / torch.finfo(torch.float32).eps


def friction_kernel_checks(sim):
    """Kernels I and J at the friction run's final state (the step-start
    positions of the next step), f64 and f32 (the f64 inputs are the f32
    state cast up), against their twins on the CPU: I's lists and counts
    exactly, its distances within 64 eps of the coordinate scale; J per
    friction family on the rows kernel E routes from I's lists: in f64 the
    same regions on every row and anchors and tangent bases within 64 eps of
    the coordinate scale; in f32 the same on the rows whose region f32
    rounding does not decide (the f32 and f64 twins agree; the rest are
    counted as left_out), within eps * max(64 * scale, 8 * the row's f32
    rounding amplification); mu exactly, fn within 64 eps of its largest
    value. Times I and J in f32."""
    from stark_tpu_torch.ops import friction_pairs as fp, friction_rows as fr

    eng = sim.interactions.contact.engine()
    contact = sim.interactions.contact
    Vs, Vr = eng.step_start_world(eng.engine_state())
    V32 = eng._vcat(Vs, Vr).contiguous()
    glob = eng.glob_entries()
    ptol = contact.edge_edge_cross_norm_sq_cutoff
    btype = contact.ipc_barrier_type
    results = {}

    def on(x, dtype, device):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.to(device)
        return x.to(dtype) if x.is_floating_point() else x

    def grid(dtype, device):
        V, mu, th = (on(x, dtype, device) for x in (V32, glob["mu_mat"], eng.th_vec()))
        i32 = lambda x: x.to(device)
        return {"pt": (V, i32(eng.d_tris_all), i32(eng.d_pt_allowed), i32(eng.d_p_mesh32),
                       i32(eng.d_t_mesh32), mu, th, eng._cap("f_pt")),
                "ee": (V, i32(eng.d_edges_all), i32(eng.d_ee_allowed), i32(eng.d_e_mesh32),
                       mu, th, eng._cap("f_ee"), ptol)}

    pairs = {"pt": (fp.friction_pairs_pt, fp.friction_pairs_pt_plain),
             "ee": (fp.friction_pairs_ee, fp.friction_pairs_ee_plain)}
    rows = {"pt": (fr.friction_rows_pt, fr.friction_rows_pt_plain),
            "ee": (fr.friction_rows_ee, fr.friction_rows_ee_plain)}
    for dtype in (torch.float64, torch.float32):
        main = dtype == torch.float32
        log(f"-- {dtype}")
        eps = torch.finfo(dtype).eps
        on_card = grid(dtype, DEVICE)
        k = glob["contact_k"].to(dtype)
        scale = 1.0 + float(V32.abs().max())
        for kind in ("pt", "ee"):
            kern, plain = pairs[kind]
            args = on_card[kind]
            out = kern(*args)
            ref = plain(*grid(dtype, "cpu")[kind])
            torch.cuda.synchronize()
            n = int(ref[4])
            same = (int(out[4]) == n and torch.equal(out[0].cpu(), ref[0])
                    and torch.equal(out[1].cpu(), ref[1]) and torch.equal(out[3].cpu(), ref[3]))
            table, allowed, meshes = args[1], args[2], args[3:5] if kind == "pt" else args[3:4]
            nq, nt = allowed.shape
            cap = args[7] if kind == "pt" else args[6]
            log(f"  friction_pairs[{kind}] {str(dtype):<14} grid={nq}x{nt} pairs={n} "
                f"cap={cap} {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"friction_pairs[{kind}] ({dtype}) differs from its twin")
            err_i = check(f"friction_pairs[{kind}] d", dtype, (out[2].cpu() - ref[2]).abs(),
                          torch.full_like(ref[2], 64 * eps * scale))
            q, t, d, dhat, cnt = out
            act = torch.arange(cap, device=DEVICE) < torch.clamp_max(cnt, cap)
            route = eng._route_pt if kind == "pt" else eng._route_ee
            routed = route(q, t, act, dhat, cap_pfx="f_", d_rows=d)
            best = None
            err_j = 0.0
            for stem, (a_loc, b_loc, _act, dh, ds, c) in routed.items():
                if kind == "pt":
                    ag = a_loc + (0 if stem[3] == "d" else eng.n_sv)
                    bg = b_loc + (0 if stem[4] == "d" else eng.n_ts)
                    jargs = (args[0], table, ag, bg, c, ds, dh, *meshes, args[5], k, btype)
                else:
                    ag = a_loc + (0 if stem == "ee_dd" else eng.n_es)
                    bg = b_loc + (eng.n_es if stem == "ee_rr" else 0)
                    jargs = (args[0], table, ag, bg, c, ds, dh, *meshes, args[4], k, btype,
                             ptol)
                jk, jp = rows[kind]
                o = [x.cpu() for x in jk(*jargs)]
                r = jp(*(on(x, dtype, "cpu") for x in jargs))
                torch.cuda.synchronize()
                nr = min(int(c), o[0].shape[0])
                # f64: every row at 64 eps of the coordinate scale
                decided = torch.ones_like(r[0], dtype=torch.bool)
                tol = torch.full((r[0].shape[0],), 64.0 * eps * scale, dtype=torch.float64)
                if main:
                    # f32: rows whose region f32 rounding decides (the f32
                    # and f64 twins disagree) are left out, and a row's
                    # tolerance grows with its f32 rounding amplification
                    r64 = jp(*(on(x, torch.float64, "cpu") for x in jargs))
                    decided = r[0] == r64[0]
                    amp = torch.maximum(_row_amp(r[1], r64[1]), _row_amp(r[2], r64[2]))
                    tol = eps * torch.clamp_min(8.0 * amp, 64.0 * scale)
                n_out = int((~decided).sum())
                if not torch.equal(o[0][decided], r[0][decided]) \
                        or not torch.equal(o[3], r[3]):
                    raise AssertionError(f"friction_rows[{kind}] {stem} ({dtype}): "
                                         "regions or mu differ from the twin")
                for name, x, y in (("anchor", o[1], r[1]), ("T", o[2], r[2])):
                    e = (x - y).abs().double().reshape(x.shape[0], -1).amax(1)
                    e = torch.where(decided, e, torch.zeros_like(e))
                    err_j = max(err_j, check(
                        f"friction_rows[{kind}] {stem} {name} n={nr} left_out={n_out}",
                        dtype, e, tol))
                fscale = float(r[4].abs().max()) if nr else 0.0
                check(f"friction_rows[{kind}] {stem} fn", dtype, (o[4] - r[4]).abs(),
                      torch.full_like(r[4], 64 * eps * fscale + torch.finfo(dtype).tiny))
                if best is None or nr > best[0]:
                    best = (nr, stem, jargs, o[0][:nr])
            if not main:
                continue
            # ---- timings and bounds (float32, the main path's dtype) ----
            # I: the mask, vertices, table, mesh ids, mu and th read once,
            # the (cap,) lists and the count written once; one distance per
            # allowed pair with mu != 0, priced by its region
            el = args[0].element_size()
            mu_g, th_g = (args[5], args[6]) if kind == "pt" else (args[4], args[5])
            mu_ok = mu_g[meshes[0].long()][:, meshes[-1].long()] != 0
            keep = allowed.bool() & mu_ok
            n_eval = int(keep.sum())
            ops_i = ops_of(region_hist(kind, args[0], table, keep, ptol), DIST_OPS[kind],
                           REGION_OPS[kind])
            bnd = bound_ms(nq * nt + nbytes(args[0], table, *meshes, mu_g, th_g)
                           + cap * (8 + 2 * el) + 4, ops_i, dtype)
            results[f"friction_pairs[{kind}]"] = dict(
                max_abs_err=err_i, ms=graph_ms(lambda: kern(*args)),
                plain_ms=events_ms(lambda: plain(*args), iters=3),
                library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
                shape=f"{nq}x{nt} grid, {n_eval} pairs evaluated "
                      f"({ops_i / max(n_eval, 1):.1f} ops each), {n} kept, cap {cap}")
            # J (the family with the most rows): vertices, table, mesh ids
            # and mu read once, each active row's two indices, d and dhat,
            # and every row's region, anchor, T, mu and fn written
            nr, stem, jargs, regs = best
            R = jargs[2].shape[0]
            width = 3 if kind == "pt" else 2
            hist_j = torch.bincount(regs.long(), minlength=len(ROW_OPS[kind]))
            ops_j = ops_of(hist_j, ROW_OPS[kind], REGION_OPS[kind] + FN_OPS[btype])
            bnd = bound_ms(nbytes(args[0], table, *meshes, mu_g)
                           + nr * (8 + 2 * el) + R * (4 + (width + 8) * el),
                           ops_j, dtype)
            jk, jp = rows[kind]
            results[f"friction_rows[{kind}]"] = dict(
                max_abs_err=err_j, ms=graph_ms(lambda: jk(*jargs)),
                plain_ms=events_ms(lambda: jp(*jargs), iters=3),
                library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
                shape=f"friction_{stem}: {R} rows, {nr} active "
                      f"({ops_j / max(nr, 1):.1f} ops each)")
    return results


def friction_run(out_json: str) -> int:
    """Phase 10's work, run as `chip_smoke.py --friction OUT_JSON`: the
    32x32 spinning box with friction in float32 through Simulation.run for
    FRICTION_SECONDS, its checks, then kernels I and J against their twins;
    writes the fields, the main path's launches and the kernel records."""
    from stark_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)     # the parent and phase 9 share the host
    t0 = time.perf_counter()
    sim, cloth, spin = make_spinning_box(N_SBC, "float32", mu=FRICTION_MU)
    sim.add_time_event(0.0, 10.0, spin)
    build.reset_launches()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    assert sim.run(duration=FRICTION_SECONDS - 1e-9), "the friction run failed"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(build.launches)
    launches["compact"] = sum(v for k, v in launches.items() if k.startswith("compact["))
    lg = sim.get_logger()
    newton = int(lg.get_stats("newton_iterations").total)
    steps = sim.stark.current_time_step
    fric = [int(v) for v in lg.series["friction_rows"]]
    counts = sim.stark.newton._last_counts
    fields = {
        "steps": steps, "sim_seconds": sim.get_time(), "newton_iters": newton,
        "wall_s": wall, "ms_per_newton_iter": 1e3 * wall / max(newton, 1),
        "cg_per_newton": int(lg.get_stats("cg_iterations").total) / max(newton, 1),
        "broad_rebuilds": int(lg.get_stats("broad_rebuilds").total),
        "pair_rebuilds": int(lg.get_stats("pair_rebuilds").total),
        "fused_retraces": int(lg.get_int("fused_retraces")),
        "host_syncs_per_step": int(lg.get_stats("host_syncs").total) / max(steps, 1),
        "live_pairs_last": sim.stark.newton.live_contact_pairs(),
        "friction_rows_per_solve": fric,
        "friction_rows_last": fric[-1],
        "friction_counts_last": {k: int(v) for k, v in counts.items() if k.startswith("f_")},
        "solver_codes": [int(c) for c in lg.series["solver_code"]],
    }
    print("friction run: " + json.dumps(fields), flush=True)
    print(f"launches={launches}", flush=True)
    x = cloth.point_set.get_positions()
    assert np.all(np.isfinite(x)), "non-finite positions"
    assert fields["friction_rows_last"] > 0, "no live friction rows"
    assert not intersects_now(sim), "the final state intersects"
    assert_launched(launches, CONTACT_KERNELS + FRICTION_KERNELS + SOLVER_KERNELS,
                    "the friction path")
    results = friction_kernel_checks(sim)
    with open(out_json, "w") as f:
        json.dump({"fields": fields, "launches": launches, "results": results,
                   "seconds": time.perf_counter() - t0}, f)
    return 0


KERNELS = [
    # name, source, the TPU-shaped JAX function it replaces
    ("segment_reduce[egh]", "stark_tpu_torch/csrc/segment_reduce.cu",
     "stark_tpu/solver/assembly.py:50"),
    ("segment_reduce[diag]", "stark_tpu_torch/csrc/segment_reduce.cu",
     "stark_tpu/solver/assembly.py:574"),
    ("segment_reduce[dense]", "stark_tpu_torch/csrc/segment_reduce.cu",
     "stark_tpu/solver/assembly.py:696"),
    ("hvp_bucket", "stark_tpu_torch/csrc/hvp_bucket.cu",
     "stark_tpu/solver/assembly.py:559"),
    ("pd_project", "stark_tpu_torch/csrc/pd_project.cu",
     "stark_tpu/solver/project.py:53"),
    ("block3_inverse", "stark_tpu_torch/csrc/block3.cu",
     "stark_tpu/solver/assembly.py:876"),
    ("block3_apply", "stark_tpu_torch/csrc/block3.cu",
     "stark_tpu/solver/assembly.py:906"),
    # the contact path (phase 7); compact's launches sum its call sites
    ("compact", "stark_tpu_torch/csrc/compact.cu",
     "stark_tpu/ops/compaction.py:59"),
    ("ball_wide", "stark_tpu_torch/csrc/ball_wide.cu",
     "stark_tpu/models/interactions/contact_engine.py:1102"),
    ("pt_ee_distance[pt]", "stark_tpu_torch/csrc/pt_ee_distance.cu",
     "stark_tpu/collision/narrow_phase.py:162"),
    ("pt_ee_distance[ee]", "stark_tpu_torch/csrc/pt_ee_distance.cu",
     "stark_tpu/collision/narrow_phase.py:328"),
    ("segment_triangle_any", "stark_tpu_torch/csrc/segment_triangle.cu",
     "stark_tpu/models/interactions/contact_engine.py:1782"),
    # the friction path (phase 10): the pair lists of friction_tables' dense
    # branch (:1535) and its per-row anchors
    ("friction_pairs[pt]", "stark_tpu_torch/csrc/friction_pairs.cu",
     "stark_tpu/models/interactions/contact_engine.py:1019"),
    ("friction_pairs[ee]", "stark_tpu_torch/csrc/friction_pairs.cu",
     "stark_tpu/models/interactions/contact_engine.py:1031"),
    ("friction_rows[pt]", "stark_tpu_torch/csrc/friction_rows.cu",
     "stark_tpu/collision/narrow_phase.py:172"),
    ("friction_rows[ee]", "stark_tpu_torch/csrc/friction_rows.cu",
     "stark_tpu/collision/narrow_phase.py:333"),
]
CONTACT_KERNELS = ("compact", "ball_wide", "pt_ee_distance[pt]",
                   "pt_ee_distance[ee]", "segment_triangle_any")
FRICTION_KERNELS = ("friction_pairs[pt]", "friction_pairs[ee]", "friction_rows[pt]",
                    "friction_rows[ee]")
SOLVER_KERNELS = ("segment_reduce[egh]", "segment_reduce[diag]", "segment_reduce[dense]",
                  "hvp_bucket", "pd_project", "block3_inverse", "block3_apply")


def assert_launched(launches, names, where: str):
    """Every kernel named was launched at least once in the run."""
    for k in names:
        assert launches.get(k, 0) > 0, f"{k} never launched on {where}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from stark_tpu_torch.ops import build

    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    # ---- 1 ----
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2 ----
    build.library()
    log(f"kernels built in {build.build_info['seconds']:.1f}s "
        f"(fresh build: {build.build_info['built']}) -> {build.build_info['path']}")
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for src, text in build.build_info["ptxas"].items():
            f.write(f"==== {src}\n{text}\n")

    # phases 9 and 10 run beside phases 3-8, each in a process of its own:
    # the work is host-bound (one Python thread each) and the card mostly idle
    children = [start_child("--golden-sbc16", "golden_sbc16"),
                start_child("--friction", "friction")]
    try:
        return phases_3_to_11(card, t_start, *children)
    finally:
        for proc, _path, logf in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()


def phases_3_to_11(card, t_start, golden_child, friction_child) -> int:
    from stark_tpu_torch.ops import build

    # ---- 3 ----
    size64 = 0.4
    sim64, h64, P = make_cloth(N_MAIN, size64, "float32")
    pin_top_corners(sim64, h64, P, size64)
    sim32, h32, P32 = make_cloth(N_DENSE, size64, "float32")
    pin_top_corners(sim32, h32, P32, size64)
    _nm64, ev64, _d64, topo64, hess64, H64 = frozen_inputs(sim64, False, 1)
    _nm32, ev32, _d32, topo32, _h32, H32 = frozen_inputs(sim32, True, 2)
    log(f"64x64: {ev64.n_blocks} blocks, H_cat {tuple(H64.shape)}; "
        f"32x32: {ev32.n_blocks} blocks, dense n={3 * (ev32.n_blocks + 1)}")
    log("phase 3: kernels against their twins")
    results = kernel_checks(ev64, topo64, hess64, H64, ev32, topo32, H32)

    # ---- 4: the main path ----
    log("phase 4: 64x64 hanging cloth, float32, cuda")
    n_steps = MAIN_STEPS
    x_rest = h64.point_set.get_positions().copy()
    pins = np.asarray(sim64.deformables.prescribed_positions._nodes)
    launches64, run64 = run_steps(sim64, n_steps)
    x = h64.point_set.get_positions()
    free = np.setdiff1d(np.arange(len(x)), pins)
    pin_dev = float(np.max(np.linalg.norm(x[pins] - x_rest[pins], axis=1)))
    log(f"  mean free z={np.mean(x[free, 2]):.4f} pin deviation={pin_dev:.2e} "
        f"launches={launches64}")
    assert np.all(np.isfinite(x)), "non-finite positions"
    assert np.mean(x[free, 2]) < 0.0, "the cloth does not sag"
    assert pin_dev < 2e-3, f"pins moved by {pin_dev}"
    for k in ("segment_reduce[egh]", "segment_reduce[diag]", "hvp_bucket",
              "pd_project", "block3_inverse", "block3_apply"):
        assert launches64.get(k, 0) > 0, f"{k} never launched on the main path"

    # ---- 5: the dense Newton-Schulz branch ----
    log("phase 5: 32x32 hanging cloth, float32, cuda (dense preconditioner)")
    launches32, run32 = run_steps(sim32, DENSE_STEPS)
    ns_q = sim32.get_logger().series["ns_q"]
    log(f"  ns_q={ns_q} launches={launches32}")
    assert launches32.get("segment_reduce[dense]", 0) > 0, \
        "the dense-assembly site never launched"
    assert all(np.isfinite(ns_q)), "ns_q is not finite"
    assert np.all(np.isfinite(h32.point_set.get_positions()))

    # ---- 6: the golden trajectory ----
    log("phase 6: hanging_cloth_16 golden, float64, cuda")
    golden = load_golden(GOLDEN)
    simg, hg, Pg = make_cloth(16, 1.0, "float64",
                              max_time_step_size=1.0 / 30.0,
                              use_adaptive_time_step=False)
    pin_top_corners(simg, hg, Pg, 1.0, stiffness=1e6)
    worst = 0.0
    t0 = time.perf_counter()
    for step in range(len(golden)):
        assert simg.run_one_time_step(), f"golden step {step} failed"
        dev = float(np.max(np.linalg.norm(hg.point_set.get_positions()
                                          - golden[step], axis=1)))
        worst = max(worst, dev)
    log(f"  {len(golden)} steps in {time.perf_counter() - t0:.2f}s, "
        f"max vertex deviation {worst:.3e} (bound 2e-3)")
    assert worst < 2e-3, f"golden deviation {worst}"

    # ---- 7: the contact path ----
    log(f"phase 7: spinning_box_cloth {N_SBC}x{N_SBC}, float32, cuda, "
        f"{SBC_SECONDS} s")
    sbc, cloth_sbc, spin = make_spinning_box(N_SBC, "float32")
    sbc.add_time_event(0.0, 10.0, spin)
    sbc_steps = int(round(SBC_SECONDS / sbc.stark.settings.simulation.max_time_step_size))
    launches_sbc, fields = run_spinning_box(sbc, sbc_steps)
    launches_sbc["compact"] = sum(v for k, v in launches_sbc.items()
                                  if k.startswith("compact["))
    log("  bench fields: " + json.dumps(fields))
    log(f"  launches={launches_sbc}")
    x = cloth_sbc.point_set.get_positions()
    assert np.all(np.isfinite(x)), "non-finite positions"
    assert fields["live_pairs_last"] > 0, "no live contact pairs"
    assert not intersects_now(sbc), "the final state intersects"
    assert_launched(launches_sbc, CONTACT_KERNELS + SOLVER_KERNELS, "the contact path")

    # ---- 8 ----
    log("phase 8: kernels E-H (and C on the live pool) against their twins")
    results.update(contact_kernel_checks(sbc))

    # ---- 9: the contact golden (its own process, started after phase 2)
    log("phase 9: spinning_box_cloth_16 golden, float64, cuda")
    r9 = finish_child(golden_child, "the spinning_box_cloth_16 golden run")
    devs, golden_s = r9["devs"], r9["seconds"]
    log(f"  {len(devs)} steps in {golden_s:.2f}s (beside phases 3-8), max vertex "
        f"deviation per step {[f'{d:.2e}' for d in devs]}")
    for step, dev in enumerate(devs):
        bound = 5e-4 if step < 2 else 2e-3 if step < 3 else 1e-1
        assert dev < bound, f"golden step {step}: deviation {dev} over {bound}"

    # ---- 10: lagged friction (its own process, started with phase 9's)
    log(f"phase 10: spinning_box_cloth {N_SBC}x{N_SBC} with friction mu={FRICTION_MU}, "
        f"float32, cuda, {FRICTION_SECONDS} s; kernels I and J against their twins")
    r10 = finish_child(friction_child, "the friction run")
    with open(os.path.join(OUT_DIR, "friction.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(("friction run:", "launches=", "  friction_", "-- ")):
                log("  " + line.strip())
    log(f"  {r10['seconds']:.2f}s (beside phases 3-9)")
    launches_fric = r10["launches"]
    results.update(r10["results"])

    # ---- 11 ----
    kernels = []
    for name, source, replaces in KERNELS:
        r = results[name]
        if name in FRICTION_KERNELS:
            launches = launches_fric.get(name, 0)
        elif name in CONTACT_KERNELS:
            launches = launches_sbc.get(name, 0)
        else:
            launches = (launches32 if name == "segment_reduce[dense]"
                        else launches64).get(name, 0)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    summary = {"card": card, "runs": {"cloth64_f32": run64,
                                      "cloth32_f32": run32,
                                      "spinning_box32_f32": fields,
                                      "spinning_box32_friction_f32": r10["fields"]},
               "spinning_box_launches": launches_sbc,
               "friction_launches": launches_fric,
               "golden16_f64_max_dev": worst,
               "spinning_box_golden16_f64_devs": devs, "kernels": kernels,
               "build_s": build.build_info["seconds"],
               "total_s": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--golden-sbc16":
        sys.exit(golden_sbc16(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--friction":
        sys.exit(friction_run(sys.argv[2]))
    sys.exit(main())
