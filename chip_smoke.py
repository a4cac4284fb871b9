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
  7. run bench.py's spinning_box_cloth at 32x32 in float32 for 0.5 simulated
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
 10. print the kernels' JSON line, the card line, and the result line.

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
N_SBC, SBC_SECONDS = 32, 0.5

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


def make_spinning_box(n: int, dtype: str, adaptive: bool = True):
    """bench.py's spinning_box_cloth on DEVICE: (sim, cloth, spin(t))."""
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    return spinning_box_cloth(n, dtype, DEVICE, adaptive, name="chip_smoke_spinning_box")


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
    count_max, live = {}, []
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


def start_golden_sbc16():
    """Start phase 9 in a child process; (process, result path, log file)."""
    path = os.path.join(OUT_DIR, "golden_sbc16.json")
    if os.path.exists(path):
        os.remove(path)
    logf = open(os.path.join(OUT_DIR, "golden_sbc16.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--golden-sbc16", path],
        stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, path, logf


def finish_golden_sbc16(child):
    proc, path, logf = child
    rc = proc.wait()
    logf.flush()
    if rc != 0 or not os.path.exists(path):
        with open(logf.name) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"the spinning_box_cloth_16 golden run failed "
                             f"(exit {rc}):\n{tail}")
    with open(path) as f:
        r = json.load(f)
    return r["devs"], r["seconds"]


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
]
CONTACT_KERNELS = ("compact", "ball_wide", "pt_ee_distance[pt]",
                   "pt_ee_distance[ee]", "segment_triangle_any")


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

    # phase 9 runs beside phases 3-8 in a process of its own: the work is
    # host-bound (one Python thread each) and the card mostly idle
    golden = start_golden_sbc16()
    try:
        return phases_3_to_10(card, t_start, golden)
    finally:
        if golden[0].poll() is None:
            golden[0].kill()
            golden[0].wait()
        golden[2].close()


def phases_3_to_10(card, t_start, golden_child) -> int:
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
    for k in CONTACT_KERNELS + ("segment_reduce[egh]", "segment_reduce[diag]",
                                "segment_reduce[dense]", "hvp_bucket",
                                "pd_project", "block3_inverse", "block3_apply"):
        assert launches_sbc.get(k, 0) > 0, f"{k} never launched on the contact path"

    # ---- 8 ----
    log("phase 8: kernels E-H (and C on the live pool) against their twins")
    results.update(contact_kernel_checks(sbc))

    # ---- 9: the contact golden (its own process, started after phase 2)
    log("phase 9: spinning_box_cloth_16 golden, float64, cuda")
    devs, golden_s = finish_golden_sbc16(golden_child)
    log(f"  {len(devs)} steps in {golden_s:.2f}s (beside phases 3-8), max vertex "
        f"deviation per step {[f'{d:.2e}' for d in devs]}")
    for step, dev in enumerate(devs):
        bound = 5e-4 if step < 2 else 2e-3 if step < 3 else 1e-1
        assert dev < bound, f"golden step {step}: deviation {dev} over {bound}"

    # ---- 10 ----
    kernels = []
    for name, source, replaces in KERNELS:
        r = results[name]
        if name in CONTACT_KERNELS:
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
                                      "spinning_box32_f32": fields},
               "spinning_box_launches": launches_sbc,
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
    sys.exit(main())
