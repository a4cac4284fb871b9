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
     kernel, twin and the one-call PyTorch yardstick where there is one
     (kernel B's `hvp_site`: its row lengths printed, the same bits from two
     launches, kernel and torch.sparse.mm both timed in a CUDA graph);
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
     friction: kernels I, J and Q besides A-H), print bench.py's fields and the
     live friction rows, check it (finite, friction rows, no intersection,
     every kernel of the path launched), then hold kernels I and J against
     their twins on the CPU in f32 and f64 at the final state and time them
     (in a child process, `chip_smoke.py --friction OUT`, started with
     phase 9's);
 11. print the Newton iterations of the scenes whose CG products run
     kernel B (phases 7, 10, 12, 14, 15), the kernels' JSON line, the card
     line, and the result line;
 12. run bench.py's 64x64 scale point of spinning_box_cloth (float32, one
     warm-up step, then 0.15 simulated seconds through Simulation.run),
     where the edge-edge block (12,416^2 pairs) takes the hash grid: kernels
     K and L besides A-H; print bench.py's scale_64 fields and check them
     (ok, finite, live contact pairs at the end, no intersection, every
     kernel of the path launched);
 13. at phase 12's final state, hold kernels K and L exactly against their
     twins in f32 and f64 (ee_dd on the grid; pt_dd and ee_dr dense), the
     broad shell's lists and the per-stem friction tables (mu = 1, f64)
     against the engine's twin path (every kernel's twin on the CPU, on
     the card's inputs), and the family pair
     sets of the grid against those of a dense-mode engine at the same
     state; time K, L, their twins, and ee_dd's grid path against the dense
     ball path (phases 12 and 13 run in a child process,
     `chip_smoke.py --scale64 OUT`, started with phase 9's); and, at the same
     state, kernel F's oracle ball pairs from the card's torch glue against
     those of the CPU glue, the card's list (the port's pad) containing the
     CPU's under JAX's pad; kernel B at the state's solver product (the
     static bucket and the live pool, `hvp_site`);
 14. run the 32x32 spinning box with friction mu = 1 in float32 through the
     staged solver (STARK_TPU_TORCH_NO_FUSED=1) for 0.2 simulated seconds:
     the contact tables refreshed before every energy evaluation (K16:
     kernel I's contact mode, then E), BDPCG over the arity groups (B at its
     staged site, A, D), the oracle (F, G, H) in the line search, friction
     tables once per step (I, J); print bench.py's fields with the live
     pairs and friction rows and check them (finite, live pairs and friction
     rows, no intersection, every kernel of the path launched);
 15. run the other staged configurations: the 32x32 hanging cloth in
     float32 for 3 steps each under DirectLLT (kernel A's direct site and
     the library Cholesky), ProjectOnDemand and Progressive, the same cloth
     squeezed to a third of its width under Progressive (the projection
     ladder escalates: kernel C with its selective mask), and
     tests/test_rb_constraints.py's global_point scene and a hinge (kernels
     T and U) on DirectLLT at 2 ms for 50 steps; the three DirectLLT runs
     print their Newton counts and a hash of their final positions;
 16. hold kernel B at its staged site (one launch over the arity groups,
     `hvp_site`) and the K16 lists (exactly) against
     their twins in f32 and f64 at phase 14's final state, and the whole
     contact refresh against the engine's twin path; kernel A's direct site
     on phase 15's DirectLLT input, bit for bit against its twin and the
     former design (CSR, segmented sum, permute), timed against both and
     the fill plus index_add_ yardstick; time them and the Cholesky (phases 14
     and 16 run in a child process, `chip_smoke.py --staged OUT`, started
     with phase 9's);
 17. kernels M-W, the element energies, gradients and Hessians: phases 4,
     7, 10, 12, 14 and 18-23 assert that every family of their path
     launched its kernel (e, g, H and the value-only form) and that no
     family ran torch.func on the card; at phase 4's, 7's, 10's, 12's,
     18's, 19's, 21's, 22's and 23's states (10, 12 and 18-23 in their
     processes) each
     family's kernel is held against its torch.func twin on the card, f64
     within 1e-10 of each element's largest entry (full shells' rows near
     flat edges, whose twin moves farther under f64 rounding of the
     positions: within twice that move, tools/egh_cases.f64_ratio) and f32
     by tools/egh_cases.f32_ratio, the value-only e bit for bit the egh e,
     and energy_grad_hess's E bit for bit energy()'s in f32 and f64; the
     families no scene runs, and kernel Q under C0 and C1, on seeded
     tables; then, on the idle card, each family's kernel and twin are
     timed (R and S at phase 18's state, Q at phase 19's, Q's families
     that only phase 10 fills on seeded tables, T and U at phase 21's and
     the joint chain's, V at the full-shell cloth's, W at phase 23's, and
     the families no scene runs on seeded tables), and energy_grad_hess
     and energy() whole with the kernels and with the twins;
 18. run upstream's hanging_box_with_composite_material at n = 10 (1,331
     nodes, 5,000 tets, surface membrane and flat shells, 120 rods on its
     sharp edges; kernels S, R, M, P and A-D) in float32 for 0.25
     simulated seconds, print bench.py's fields and check it: finite,
     sagging, pins held, every kernel of the path launched;
 19. run upstream's deformable_and_rigid_collisions (Soft_Rubber boxes of
     625 and 40 tets on a fixed rigid floor, mu = 1 on all three pairs;
     kernels S, Q, N, O, P, E-J and A-D) in float32 for 0.3 simulated
     seconds: finite, the lower box on the floor and the upper on it, live
     contact and friction rows, no intersection, every kernel launched;
 20. run upstream's hanging_net at n = 20 (441 nodes, 1,240 rods, the
     boundary pinned; kernels R, P and A-D) in float32 for 0.25 simulated
     seconds: finite, sagging, every kernel launched (phases 18-20 and
     their phase-17 part run in a child process, `chip_smoke.py --volumes
     OUT`, started with phase 9's);
 21. run upstream's simple_grasp at its sizes (a fixed hand, two fingers on
     prismatic presses at +-1 m/s and 5 N, a Soft_Rubber cube of 216 nodes
     and 625 tets, mu 1.05; kernels T, U, S, Q, N, O, P, E-J and A-D) in
     float32 through Simulation.run for 0.3 simulated seconds: finite, the
     fingers closed on the cube (live finger pairs and friction rows),
     no intersection, each press's velocity violation and force from its
     handler, every kernel launched, torch.func nowhere on the card;
 22. run tests/test_rb_constraints.py's ten joint scenes in float64 on the
     fused path (tools/rb_scenes.py), each with its force balance;
     tools/scenes.rigid_joint_chain (every joint family) in float32 for 0.3
     s; and the 32x32 hanging cloth with full DiscreteShells (kernel V) in
     float32 for 6 steps: finite, sagging, pins held (phases 21-22 and their
     phase-17 part run in a child process, `chip_smoke.py --joints OUT`,
     started with phase 9's);
 23. run upstream's attachments example at its sizes, built through
     stark_tpu_torch.examples (two 20x20 Cotton_Fabric cloths of 1 m, B
     turned 45 deg 1 mm above A and glued to A's triangles by distance, a
     0.25 m box of 0.1 kg glued to B's nodes near it, A pinned at two
     corners; kernels W, M, P and A-D) in float32 through Simulation.run
     for 0.4 simulated seconds with VTK frames of "A", "B" and "box" under
     chiprun_out/chip_smoke/frames/attachments/: finite, every attachment
     within its tolerance (the converged check's gap), A's pins held, B and
     the box moved down, every label's frames written and read back finite,
     the last frame the simulation's positions, every kernel launched,
     torch.func nowhere on the card (phase 23 and its phase-17 part run in
     a child process, `chip_smoke.py --attachments OUT`, started with
     phase 9's);
 24. K12, the fused solve as one CUDA graph per solve configuration (every
     fused phase above runs it: one replay and one host read per solve).
     Kernel X's nested WHILE/IF/WHILE nodes against the eager driver and
     the closed form, and one WHILE iteration's latency; kernel Y against
     its twin over three CG iterations of phase 7's final Newton system,
     its halves timed in CUDA graphs beside the twin's; then at the final
     states of phases 7, 10 and 23 (three solves each) and 12 (one solve,
     the grid path) the graph against the eager driver from each solve's
     recorded inputs, u, stats, counts and M bit for bit, with the captures,
     the capture time, ms per Newton of both over graph replays (a call
     that captured is timed again as a replay at the current capacities,
     else left out of both), and at phases 7 and 23 the last timed solve's
     eager kernel time under torch.profiler beside both drivers' ms on it
     (the graph's bound; the graph's busy share is inferred from it, as
     the profiler misses kernels inside conditional bodies);
 25. at phase 7's final state, `python3 -m stark_tpu_torch.tools.profile_linsolve`'s
     profile (JAX's gather-table and dense-direct helpers, kernels AA-AC,
     beside the solver's hvp, Newton-Schulz refresh and PCG), with the
     launches of AA-AC counted over it; AA's tables bit for bit and AB, AC
     within the sum rule against their twins there (AB in f32 and f64, two
     launches the same bits; AB and its sparse.mm yardstick timed alike),
     each timed; kernel B at the fused solve's product (`hvp_site`); kernel Z
     (JAX's exact-eigh branch: jacobi_sweeps = 0 and every d <= 3, here the
     box's fix at d = 3, which phase 7 ran through Z; and a seeded d = 96
     stack in f32 and f64, its shared wide layout, with the twin's sweeps
     per matrix) against its twin; and phase 19's soft boxes at
     jacobi_sweeps = 0 for a short window through the graph: finite, the
     last solve successful, one host read per solve, every projection on Z.

A kernel's launch count counts its wrapper's calls: inside the captured
graph a site counts once per capture (its replays launch it again on the
device, uncounted), plus the eager driver's calls.

Exits non-zero without a CUDA device. Long logs (ptxas report,
summary.json) go to chiprun_out/chip_smoke/. Where a Newton iteration's time
goes is measured on demand by `python3 -m stark_tpu_torch.tools.profile_stages`;
`python3 chip_smoke.py --witness` (not part of the smoke) measures phase 19's
contact rows and reruns phases 10, 18 and 19 under variants (witness_run);
`--witness-b` reruns phase 7 with kernel B, from a start moved one ulp and
with B's twin (witness_b_run).
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

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
N_SCALE, SCALE_SECONDS = 64, 0.15      # bench.py's BENCH_SCALE_QUADS / _SECONDS
STAGED_SECONDS, STAGED_STEPS, RIGID_STEPS = 0.2, 3, 50
NO_FUSED_ENV = "STARK_TPU_TORCH_NO_FUSED"

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
def make_cloth(n: int, size: float, dtype: str, flat_shells: bool = True, **sim_kw):
    """An n x n Cotton_Fabric cloth of side `size` on DEVICE (full
    DiscreteShells, kernel V, with flat_shells off): (sim, handler,
    PrescribedPositionsParams)."""
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
    params = SurfaceParams.Cotton_Fabric()
    params.bending.flat_rest_angle = flat_shells
    h = sim.presets.deformables.add_surface_grid("cloth", (size, size), (n, n), params)
    return sim, h, PrescribedPositionsParams


def pin_top_corners(sim, h, Params, size, stiffness=None):
    hd = size / 2.0
    bc = Params() if stiffness is None else Params().set_stiffness(stiffness)
    for cx in (hd, -hd):
        sim.deformables.prescribed_positions.add_inside_aabb(
            h.point_set, (cx, hd, 0.0), (0.001, 0.001, 0.001), bc)


def make_spinning_box(n: int, dtype: str, adaptive: bool = True, mu: float = 0.0,
                      broad_phase: str = "auto"):
    """bench.py's spinning_box_cloth on DEVICE (with Coulomb friction mu
    between cloth and box and of the cloth with itself when mu > 0):
    (sim, cloth, spin(t))."""
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    return spinning_box_cloth(n, dtype, DEVICE, adaptive, name="chip_smoke_spinning_box",
                              mu=mu, broad_phase=broad_phase)


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
    from stark_tpu_torch.ops import block3, pd_project as pd
    from stark_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(7)
    results = {}

    def payload_for(csr, width, dtype):
        return torch.as_tensor(rng.normal(size=(csr.n_rows, width)),
                               dtype=dtype, device=DEVICE)

    # ---- B over the static bucket (no pool: the cloth has no contact) ----
    p32 = torch.as_tensor(np.random.default_rng(3).normal(size=(ev64.n_blocks, 3)),
                          dtype=torch.float32, device=DEVICE)
    results["hvp_bucket"] = hvp_site("64x64 cloth bucket", [(topo64.conn_cat32, H64,
                                                             topo64.csr_cat)],
                                     ev64.n_blocks, p32)
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
    launches = dict(build.launches, **func_launches())
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


def trajectory_digest(sim) -> dict:
    """A run's Newton iterations per step and its final positions (the
    points' x1, the bodies' t1 and q1) as a hash of their f64 bytes and a
    sum: two builds whose linear systems agree bit for bit print the same."""
    parts = []
    if sim._dyn.n_points:
        parts.append(sim._dyn.x1.detach().double().cpu().numpy())
    if sim._rb_dyn.n_bodies:
        parts += [np.asarray(sim._rb_dyn.t1), np.asarray(sim._rb_dyn.q1)]
    flat = np.concatenate([np.ascontiguousarray(x, dtype=np.float64).reshape(-1)
                           for x in parts])
    return {"newton_per_step": [int(k) for k in
                                sim.get_logger().series["newton_iterations"]],
            "positions_sha1": hashlib.sha1(flat.tobytes()).hexdigest()[:16],
            "positions_sum": float(flat.sum())}


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
    launches = dict(build.launches, **func_launches())
    return launches, bench_fields(sim, (t0, t_warm, t1), warm_newton, count_max, live, fric)


def bench_fields(sim, times, warm_newton, count_max, live, fric) -> dict:
    """bench.py's fields of a run: times (start, end of the first step,
    end), the Newton count at the end of the first step, the counts' maxima
    and the live pairs and friction rows per step."""
    t0, t_warm, t1 = times
    logger = sim.get_logger()
    newton = int(logger.get_stats("newton_iterations").total)
    steps = sim.stark.current_time_step
    warm = newton - warm_newton
    return {
        "newton_iters_per_s": warm / (t1 - t_warm) if t1 > t_warm else 0.0,
        "ms_per_newton_iter": 1e3 * (t1 - t_warm) / max(warm, 1),
        "cg_per_newton": int(logger.get_stats("cg_iterations").total) / max(newton, 1),
        "broad_rebuilds": int(logger.get_stats("broad_rebuilds").total),
        "pair_rebuilds": int(logger.get_stats("pair_rebuilds").total),
        "fused_retraces": int(logger.get_int("fused_retraces")),
        "count_max": dict(sorted(count_max.items())),
        "live_pairs_last": live[-1], "live_pairs_max": max(live),
        "friction_rows_last": fric[-1], "friction_rows_max": max(fric),
        "host_syncs_per_step": int(logger.get_stats("host_syncs").total) / max(steps, 1),
        "steps": steps, "sim_seconds": sim.get_time(), "newton_iters": newton,
        "wall_s": t1 - t0, "first_step_s": t_warm - t0,
        "solver_codes": [int(c) for c in logger.series["solver_code"]],
    }


def intersects_now(sim) -> bool:
    """Does any edge cross any triangle at the current state (u = 0)?"""
    eng, _nm, _u, Vs, Vr = contact_state(sim)
    zero = torch.zeros((), dtype=sim.stark.dtype, device=DEVICE)
    icands, _counts = eng._isect_stage1(Vs, Vr, zero)
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


def start_child(flag: str, name: str, go_file: str = None):
    """Start `chip_smoke.py FLAG OUT_JSON [GO_FILE]` in a child process;
    (process, result path, log file), both files in OUT_DIR. A child given
    GO_FILE waits for it before its timings."""
    path = os.path.join(OUT_DIR, name + ".json")
    for f in (path, go_file):
        if f and os.path.exists(f):
            os.remove(f)
    logf = open(os.path.join(OUT_DIR, name + ".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, path]
        + ([go_file] if go_file else []),
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
    launches = dict(build.launches, **func_launches())
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
    assert_launched(launches, CONTACT_KERNELS + FRICTION_KERNELS + SOLVER_KERNELS
                    + K12_KERNELS, "the friction path")
    assert_egh_path(sim, launches, BOX_FAMILIES, "the friction path",
                    optional=[n for n in BOX_FAMILIES if n.startswith("contact_")])
    assert_egh_path(sim, launches, BOX_FRICTION_FAMILIES, "the friction path",
                    optional=BOX_FRICTION_FAMILIES)
    results = friction_kernel_checks(sim)
    print("-- phase 17 (kernel Q at the friction run's state)", flush=True)
    egh10 = egh_checks(sim, BOX_FRICTION_FAMILIES, "phase 10", 10)
    k12 = k12_window(sim, K12_SOLVES, "phase 10")
    with open(out_json, "w") as f:
        json.dump({"fields": fields, "launches": launches, "results": results,
                   "egh": egh10, "k12": k12, "seconds": time.perf_counter() - t0}, f)
    return 0


# ---------------------------------------------------------------------------
# phases 12-13: bench.py's 64x64 scale point on the hash grid, kernels K, L
# ---------------------------------------------------------------------------
SCALE_KERNELS = ("grid_build", "rowk_select")
# kernels A-D of the block-Jacobi branch (4,227 DOF blocks > 2048)
JACOBI_KERNELS = ("segment_reduce[egh]", "segment_reduce[diag]", "hvp_bucket",
                  "pd_project", "block3_inverse", "block3_apply")
# L's sphere test per scanned candidate: 3 differences, 3 products, 2 sums,
# the radius sum and its square
SPHERE_OPS = 10


class twins_on_cpu:
    """Within this context the engine's kernel table (`eng.kern`) holds the
    plain twins, run on the CPU on the inputs the card computed, their
    results handed back on the card: the engine's twin path, with the same
    torch glue (balls, radii, cell sizes) as its kernel path."""

    def __init__(self, eng):
        self.eng = eng

    @staticmethod
    def _move(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple):
            items = [twins_on_cpu._move(y, dev) for y in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    @staticmethod
    def _on_cpu(plain):
        def run(*args):
            out = plain(*(twins_on_cpu._move(a, "cpu") for a in args))
            return twins_on_cpu._move(out, DEVICE)
        return run

    def __enter__(self):
        from stark_tpu_torch.models.interactions import contact_engine as ce
        from stark_tpu_torch.ops import ball_wide as bw, compact as cp
        from stark_tpu_torch.ops import friction_pairs as fp, friction_rows as fr
        from stark_tpu_torch.ops import grid_build as gb, narrow as nw
        from stark_tpu_torch.ops import rowk_select as rk, segment_triangle as sg

        twins = dict(
            ball_wide=bw.ball_wide_plain,
            contact_pairs_ee=fp.contact_pairs_ee_plain,
            contact_pairs_pt=fp.contact_pairs_pt_plain,
            # the site name only labels compact's launch count
            compact=lambda mask, cap, site: cp.compact_plain(mask, cap),
            ee_distance=nw.ee_distance_plain, pt_distance=nw.pt_distance_plain,
            friction_pairs_ee=fp.friction_pairs_ee_plain,
            friction_pairs_pt=fp.friction_pairs_pt_plain,
            friction_rows_ee=fr.friction_rows_ee_plain,
            friction_rows_pt=fr.friction_rows_pt_plain,
            grid_build=gb.grid_build_plain, rowk_select=rk.rowk_select_plain,
            segment_triangle_any=sg.segment_triangle_any_plain)
        assert sorted(twins) == sorted(ce.KERNELS), "a kernel of the engine has no twin"
        self.saved = self.eng.kern
        self.eng.kern = SimpleNamespace(**{n: self._on_cpu(f) for n, f in twins.items()})
        return self

    def __exit__(self, *exc):
        self.eng.kern = self.saved


def same_tree(a, b, what):
    """Two nested dicts/tuples of tensors are equal element for element."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{what}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{what}[{i}]")
    elif not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"{what} differs")


def shells_settled(eng, Vs, Vr, th, slack_b, slack_p):
    """broad_fn and pairs_fn at (Vs, Vr), rebuilt with bumped capacities
    until nothing overflows, as the solve does: (mid lists, oracle lists,
    family tables, counts)."""
    while True:
        mc, ic, cnt = eng.broad_fn(Vs, Vr, th, slack_b, slack_p)
        tables, pcnt = eng.pairs_fn(Vs, Vr, th, mc, slack_p)
        cnt = dict(cnt, **pcnt)
        keys = sorted(cnt)
        if not eng._check_overflow(keys, [int(cnt[k]) for k in keys]):
            return mc, ic, tables, cnt


def family_sets(tables):
    out = {}
    for name, fd in tables.items():
        act = fd["rows"]["active"].cpu().numpy() > 0.5
        out[name] = set(map(tuple, fd["conn"].cpu().numpy()[act].tolist()))
    return out


def scale64_checks(sim):
    """Phase 13 at the final state of phase 12: kernels K and L exactly
    against their twins (f64, then f32: the f32 pass is timed), the broad
    shell and the per-stem friction tables against the engine's twin path,
    grid against dense pair sets; returns (timing
    records of K and L, the ee_dd grid-vs-dense times and pair counts)."""
    from stark_tpu_torch.collision import broad_phase as bp
    from stark_tpu_torch.ops import ball_wide as bw, grid_build as gb
    from stark_tpu_torch.ops import narrow as nw, rowk_select as rk

    eng, _nm, _u, Vs32, Vr32 = contact_state(sim)
    assert eng.dense_pt and not eng.dense_ee and eng.dense_et, \
        "the 64x64 routing: PT and ET dense, EE on the grid"
    slack_b, slack_p = 0.016, 0.002
    results, info = {}, {}
    for dtype in (torch.float64, torch.float32):
        log(f"-- {dtype}")
        Vs, Vr = Vs32.to(dtype), Vr32.to(dtype)
        th = eng.th_vec().to(dtype)
        sl = torch.as_tensor(slack_b + slack_p, dtype=dtype, device=DEVICE)
        # K and L on ee_dd's hash grid, called as _grid_stage1 calls them
        ma, ha, th_a, mb, hb, th_b = eng._ee_geom("ee_dd", Vs, Vr, th)
        qr, tr = ha + th_a + sl, hb + th_b
        h = bp.pick_cell_size(qr, tr)
        ins, occ = eng._cap("g_ee_dd_ins"), eng._cap("g_ee_dd_occ")
        tsz = bp.table_size_for(mb.shape[0])
        k_args = (mb, tr, bp.max_query_radius(qr), h, ins, tsz)
        out_k = gb.grid_build(*k_args)
        ref_k = gb.grid_build_plain(*k_args)
        torch.cuda.synchronize()
        same_tree(tuple(out_k), tuple(ref_k), f"grid_build ({dtype})")
        run = (out_k[0][1:] - out_k[0][:-1]).max()
        log(f"  grid_build {str(dtype):<14} T={mb.shape[0]} ins={ins} table={tsz} "
            f"h={float(h):.4e} slots={int(out_k[0][-1])} max_cells={int(out_k[2])} "
            f"longest bucket run={int(run)} ok")
        K = eng._cap("c_ee_dd")
        grid = rk.GridIndex(out_k[0], out_k[1], h, occ)
        l_args = (ma, mb, rk.Sphere("grid", qr, tr), eng._pred("ee_dd"), K, grid)
        out_l = rk.rowk_select(*l_args)
        ref_l = rk.rowk_select_plain(*l_args)
        torch.cuda.synchronize()
        same_tree(tuple(out_l), tuple(ref_l), f"rowk_select[grid ee_dd] ({dtype})")
        log(f"  rowk_select[grid ee_dd] {str(dtype):<14} Nq={ma.shape[0]} K={K} "
            f"occ_cap={occ} max_row={int(out_l[1])} max_occ={int(out_l[2])} ok")
        # L dense: pt_dd (4,225 x 8,192) and ee_dr (the box's edges)
        P, th_p, c, r, th_t = eng._pt_geom("pt_dd", Vs, Vr, th)
        mr, hr, th_r, ms, hs, th_s = eng._ee_geom("ee_dr", Vs, Vr, th)
        for stem, args in (
                ("pt_dd", (P, c, rk.Sphere("pt", th_p, r, tb=th_t, sl=sl),
                           eng._pred("pt_dd"), eng._cap("c_pt_dd"))),
                ("ee_dr", (mr, ms, rk.Sphere("ee", hr, hs, qb=th_r, tb=th_s, sl=sl),
                           eng._pred("ee_dr"), eng._cap("c_ee_dr")))):
            out = rk.rowk_select(*args)
            ref = rk.rowk_select_plain(*args)
            torch.cuda.synchronize()
            same_tree(tuple(out[:2]), tuple(ref[:2]), f"rowk_select[dense {stem}] ({dtype})")
            log(f"  rowk_select[dense {stem}] {str(dtype):<14} "
                f"{args[0].shape[0]}x{args[1].shape[0]} K={args[4]} "
                f"max_row={int(out[1])} ok")
        if dtype == torch.float64:
            continue
        # timing (float32, the path's dtype)
        T, nq = mb.shape[0], ma.shape[0]
        # the filled slots only: the padding past offsets[-1] is read by no one
        bnd = bound_ms(nbytes(mb, tr) + 4 * (tsz + 1) + 4 * int(out_k[0][-1]) + 4,
                       0.0, dtype)
        results["grid_build"] = dict(
            max_abs_err=0.0, ms=graph_ms(lambda: gb.grid_build(*k_args)),
            plain_ms=events_ms(lambda: gb.grid_build_plain(*k_args), iters=5),
            library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
            shape=f"ee_dd: {T} targets, {ins} slots, table {tsz}")
        qb = bp._hash_cells(bp._cell_of(ma, h), tsz).long()
        offs = out_k[0].long()
        scanned = int(torch.clamp_max(offs[qb + 1] - offs[qb], occ).sum())
        pr = l_args[3]
        bnd = bound_ms(nbytes(ma, qr, mb, tr, pr.qm, pr.tm, pr.qidx, pr.tidx,
                              out_k[0]) + 4 * scanned + 4 * nq * K,
                       SPHERE_OPS * scanned, dtype)
        results["rowk_select"] = dict(
            max_abs_err=0.0, ms=graph_ms(lambda: rk.rowk_select(*l_args)),
            plain_ms=events_ms(lambda: rk.rowk_select_plain(*l_args), iters=5),
            library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
            shape=f"ee_dd grid: {nq} queries, {scanned} scanned, K {K}")

    # the broad shell (the grid's mid lists, the dense oracle's lists) and
    # its counts against the engine's twin path (f32)
    th = eng.th_vec()
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=DEVICE)
    sb, sp = f(slack_b), f(slack_p)
    mc, ic, tables, cnt = shells_settled(eng, Vs32, Vr32, th, sb, sp)
    t0 = time.perf_counter()
    with twins_on_cpu(eng):
        mc_c, ic_c, cnt_c = eng.broad_fn(Vs32, Vr32, th, sb, sp)
    same_tree(mc, mc_c, "broad_fn mid lists")
    same_tree(ic, ic_c, "broad_fn oracle lists")
    same_tree({k: cnt[k] for k in cnt_c}, cnt_c, "broad_fn counts")
    log(f"  broad_fn (_broad_grid, dense oracle) lists and counts equal the twin "
        f"path's ({time.perf_counter() - t0:.1f}s with the twins on the CPU): "
        + ", ".join(f"{k}={int(cnt_c[k])}" for k in sorted(cnt_c)
                    if k.startswith(("m_", "c_", "g_"))))
    # friction_tables' per-stem branch, mu = 1 everywhere (f64)
    V0 = [v.double() for v in eng.step_start_world(eng.engine_state())]
    mu = torch.ones((len(sim.interactions.contact.contact_thicknesses),) * 2,
                    dtype=torch.float64, device=DEVICE)
    k64 = torch.tensor(float(sim.interactions.contact.contact_stiffness),
                       dtype=torch.float64, device=DEVICE)
    ft, fc = eng.friction_tables(*V0, th.double(), mu, k64)
    with twins_on_cpu(eng):
        ft_c, fc_c = eng.friction_tables(*V0, th.double(), mu, k64)
    same_tree(fc, fc_c, "friction counts")
    worst = 0.0
    for name, fd in ft_c.items():
        act = fd["rows"]["active"] > 0.5
        same_tree(ft[name]["conn"][act], fd["conn"][act], name + " conn")
        for r, v in fd["rows"].items():
            w = ft[name]["rows"][r][act]
            v = v[act]
            if not v.is_floating_point():
                same_tree(w, v, f"{name} {r}")
            elif v.numel():
                err = float((w.double() - v.double()).abs().max()
                            / max(float(v.double().abs().max()), 1e-300))
                worst = max(worst, err)
                assert err <= 1e-9, f"friction {name} {r}: relative error {err:.3e}"
    log("  friction_tables (grid branch, mu = 1, f64) equal the twin path's: "
        + ", ".join(f"{k}={int(v)}" for k, v in sorted(fc_c.items())
                    if k.startswith("f_")) + f", floats within {worst:.2e} (1e-9)")
    # grid against dense at the same state: a dense-mode engine of the scene
    simd, _cl, _sp = make_spinning_box(N_SCALE, "float32", broad_phase="dense")
    simd.stark._initialize()
    engd = simd.interactions.contact.engine()
    assert engd.dense_ee and engd.d_ee_allowed is not None
    _mc, ic_d, tables_d, cnt_d = shells_settled(engd, Vs32, Vr32, th, sb, sp)
    sets_g, sets_d = family_sets(tables), family_sets(tables_d)
    assert sets_g == sets_d, {k: len(sets_g[k] ^ sets_d.get(k, set())) for k in sets_g}
    hit_g = bool(eng.isect_hit(Vs32, Vr32, ic))
    assert hit_g == bool(engd.isect_hit(Vs32, Vr32, ic_d)) is False
    info["pair_sets"] = {k: len(v) for k, v in sets_g.items()}
    log(f"  grid and dense family pair sets equal: {info['pair_sets']} "
        f"(dense w_ee={int(cnt_d['w_ee'])}, m_ee={int(cnt_d['m_ee'])})")
    # ee_dd's candidate search: the grid path (K, L, G, E) against the dense
    # ball path of the combined EE grid (F over 12,434^2 pairs, G, E), both
    # launched from the host with their torch glue; F alone in a CUDA graph
    m, hh = engd._edge_balls(engd._vcat(Vs32, Vr32))
    th_e = th[engd.d_e_mesh]
    pad = engd._bound_pad(engd._vcat(Vs32, Vr32))
    Vcat = engd._vcat(Vs32, Vr32)

    def dense_ee():
        (a, b, act), _w = engd._ball_wide("w_ee", m, hh + th_e, m, hh + th_e,
                                          engd.d_ee_allowed, sb + sp + pad)
        bound = th_e[a.long()] + th_e[b.long()] + sb + sp
        _d, keep = nw.ee_distance(Vcat, engd.d_edges_all, a, b,
                                  engd.model.edge_edge_cross_norm_sq_cutoff, act, bound)
        return engd._refine(a, b, keep, engd._cap("m_ee"), "refine_ee")

    def grid_ee():
        return eng._stem_pairs("ee_dd", Vs32, Vr32, th, sb + sp, "c_ee_dd", "m_")

    info["w_et"] = et_ball_containment(eng, Vs32, Vr32, sb)
    info["ee_dd_grid_ms"] = events_ms(grid_ee, iters=5)
    info["ee_dd_dense_ms"] = events_ms(dense_ee, iters=5)
    info["ee_dd_dense_ball_ms"] = graph_ms(lambda: bw.ball_wide(
        m, hh + th_e, m, hh + th_e, engd.d_ee_allowed, sb + sp + pad,
        engd._cap("w_ee")), iters=5)
    log(f"  ee_dd candidate search: grid (K, L, G, E) {info['ee_dd_grid_ms']:.4f} ms, "
        f"dense (F, G, E) {info['ee_dd_dense_ms']:.4f} ms, of which F "
        f"{info['ee_dd_dense_ball_ms']:.4f} ms")
    # kernel B at the fused solve's product of this state: the largest
    # contact set of the smoke, so the box's block row is at its longest
    from stark_tpu_torch.tools import profile_linsolve as pl

    st = pl.linear_system(sim)
    solver = [(st.topo.conn_cat32, st.H_stat, st.topo.csr_cat)]
    if st.pool is not None:
        solver.append((st.pool.conn32, st.pool.H, st.pool.csr))
    info["hvp_bucket"] = hvp_site("phase 12 solver product", solver, st.ev.n_blocks,
                                  (-st.grad).contiguous())
    return results, info


def scale64_run(out_json: str) -> int:
    """Phases 12 and 13, run as `chip_smoke.py --scale64 OUT_JSON`:
    bench.py's 64x64 scale point in float32 (a warm-up step, then
    SCALE_SECONDS through Simulation.run), its checks, then phase 13;
    writes bench's scale fields, the path's launches and K's and L's
    records."""
    from stark_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)     # three processes share the host's cores
    t0 = time.perf_counter()
    sim, cloth, spin = make_spinning_box(N_SCALE, "float32")
    sim.add_time_event(0.0, 10.0, spin)
    lg = sim.get_logger()
    count_max, live = {}, []

    def track():
        nm = sim.stark.newton
        if nm is None or not nm._last_counts:
            return
        for k, v in nm._last_counts.items():
            count_max[k] = max(count_max.get(k, 0), int(v))
        live.append(nm.live_contact_pairs())

    build.reset_launches()
    torch.cuda.synchronize()
    t_warm = time.perf_counter()
    assert sim.run_one_time_step(), "the warm-up step failed"
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_warm
    track()
    live.clear()
    warm_newton = int(lg.get_stats("newton_iterations").total)
    t_sim = sim.get_time()
    t1 = time.perf_counter()
    ok = sim.run(duration=SCALE_SECONDS, callback=track)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    track()
    launches = dict(build.launches, **func_launches())
    launches["compact"] = sum(v for k, v in launches.items() if k.startswith("compact["))
    newton = int(lg.get_stats("newton_iterations").total) - warm_newton
    fields = {
        "ok": bool(ok), "newton_iters_per_s": newton / wall if wall else 0.0,
        "sim_sec_per_wall_hour": (sim.get_time() - t_sim) / wall * 3600.0,
        "newton_iters": newton, "wall_s": wall, "warmup_s": warm_s,
        "warmup_newton": warm_newton,
        "ms_per_newton_iter": 1e3 * wall / max(newton, 1),
        "cg_per_newton": int(lg.get_stats("cg_iterations").total)
        / max(int(lg.get_stats("newton_iterations").total), 1),
        "steps": sim.stark.current_time_step, "sim_seconds": sim.get_time(),
        "broad_rebuilds": int(lg.get_stats("broad_rebuilds").total),
        "pair_rebuilds": int(lg.get_stats("pair_rebuilds").total),
        "fused_retraces": int(lg.get_int("fused_retraces")),
        "host_syncs_per_step": int(lg.get_stats("host_syncs").total)
        / max(sim.stark.current_time_step, 1),
        "count_max": {k: v for k, v in sorted(count_max.items())
                      if k.startswith(("c_", "g_", "m_"))},
        "live_pairs_last": live[-1], "live_pairs_max": max(live),
        "solver_codes": [int(c) for c in lg.series["solver_code"]],
    }
    print("scale_64: " + json.dumps(fields), flush=True)
    print(f"launches={launches}", flush=True)
    x = cloth.point_set.get_positions()
    assert fields["ok"], "the scale run failed"
    assert np.all(np.isfinite(x)), "non-finite positions"
    assert fields["live_pairs_last"] > 0, "no live contact pairs at the end"
    assert not intersects_now(sim), "the final state intersects"
    assert_launched(launches, SCALE_KERNELS + CONTACT_KERNELS + JACOBI_KERNELS
                    + K12_KERNELS, "the 64x64 scale point")
    assert_egh_path(sim, launches, BOX_FAMILIES, "the 64x64 scale point")
    print("-- phase 13", flush=True)
    torch.set_num_threads(4)     # the twins' CPU runs
    results, info = scale64_checks(sim)
    print("-- phase 17 (the scale point's state)", flush=True)
    egh12 = egh_checks(sim, BOX_FAMILIES, "phase 12", 12)
    k12 = k12_window(sim, 1, "phase 12")
    with open(out_json, "w") as f:
        json.dump({"fields": fields, "launches": launches, "results": results,
                   "info": info, "egh": egh12, "k12": k12,
                   "seconds": time.perf_counter() - t0}, f)
    return 0


# ---------------------------------------------------------------------------
# phases 14-16: the staged solver
# ---------------------------------------------------------------------------
def bsr_of(groups, n: int):
    """The global matrix sum_e P_e^T H_e P_e of element blocks given as
    [(conn (E, b) with dummy id >= n, H (E, 3b, 3b))], as a (3n, 3n) BSR
    tensor with 3x3 blocks: the one-call PyTorch yardstick of kernel B
    (torch.sparse.mm), built once outside any timing."""
    dtype, dev = groups[0][1].dtype, groups[0][1].device
    dense = torch.zeros((3 * n, 3 * n), dtype=dtype, device=dev)
    ar = torch.arange(3, device=dev)
    for conn, H in groups:
        E, b = conn.shape
        c = conn.long()
        keep = (c[:, :, None] < n) & (c[:, None, :] < n)
        e_i, i_i, j_i = torch.nonzero(keep, as_tuple=True)
        rows = 3 * c[e_i, i_i][:, None, None] + ar[None, :, None]
        cols = 3 * c[e_i, j_i][:, None, None] + ar[None, None, :]
        vals = H.reshape(E, b, 3, b, 3)[e_i, i_i, :, j_i, :]
        dense.index_put_((rows.expand(-1, 3, 3).reshape(-1),
                          cols.expand(-1, 3, 3).reshape(-1)), vals.reshape(-1),
                         accumulate=True)
    return dense.to_sparse_bsr((3, 3))


def hvp_bound(groups, n_blocks, p, q, dtype):
    """Kernel B's bound over [(conn, H, csr)]: for each kept CSR entry (e, a)
    the 3 rows of H_e at a and in them the 3 columns of each non-dummy
    block of conn_e (9 * n_e values per entry), and each group's conn and
    CSR; p read and q written once, as the one launch does; 2 flops per
    value read."""
    h_read, other = 0, nbytes(p, q)
    for conn, H, csr in groups:
        real = (conn < n_blocks).sum(1)
        perm_k = csr.perm[:int(csr.offsets[-1])]
        e_of = perm_k.to(torch.int64) // conn.shape[1]
        n_read = 9 * int(real[e_of].sum())
        h_read += n_read
        other += nbytes(conn, perm_k, csr.offsets)
    return bound_ms(h_read * H.element_size() + other, 2.0 * h_read, dtype), h_read


def cpu_csr(csr):
    from stark_tpu_torch.ops import segment_reduce as sr

    return sr.Csr(csr.perm.cpu(), csr.offsets.cpu(), csr.seg.cpu(), csr.n_seg, csr.n_rows)


def hvp_rows(groups) -> dict:
    """Kernel B's block rows over groups [(conn, H, csr)]: entries per row
    summed over the groups (max, p99, mean); a warp walks a row 32 entries
    at a time."""
    lens = sum((csr.offsets[1:] - csr.offsets[:-1]).to(torch.int64) for _c, _H, csr in groups)
    lf = lens.double()
    return {"rows": int(lens.numel()), "entries": int(lens.sum()), "max": int(lens.max()),
            "p99": float(torch.quantile(lf, 0.99)), "mean": float(lf.mean())}


def hvp_site(label, groups, n_blocks, p32, site=None) -> dict:
    """Kernel B at one site: one launch over `groups` [(conn, H, csr)]
    against its twin on the CPU (each group's product, added in order) in
    float64 and float32 within 64 eps sum|terms|, and the same bits from
    two launches; the float32 launch timed in a CUDA graph, beside its twin
    on the card and torch.sparse.mm on the same global matrix as BSR, timed
    alike (`same_timer`)."""
    from stark_tpu_torch.ops import hvp_bucket as hb

    name = "hvp_bucket" if site is None else f"hvp_bucket[{site}]"
    rows = hvp_rows(groups)
    log(f"  {name} at the {label}: {len(groups)} groups, row lengths {json.dumps(rows)}")
    for dtype in (torch.float64, torch.float32):
        g = [(c, H.to(dtype).contiguous(), csr) for c, H, csr in groups]
        p = p32.to(dtype)
        q = hb.hvp_groups(p, g, site)
        q2 = hb.hvp_groups(p, g, site)
        gc = [(c.cpu(), H.cpu(), cpu_csr(csr)) for c, H, csr in g]
        q_ref = hb.hvp_groups_plain(p.cpu(), gc)
        q_abs = hb.hvp_groups_plain(p.cpu().abs(), [(c, H.abs(), s) for c, H, s in gc])
        torch.cuda.synchronize()
        err = check(f"{name} ({label})", dtype, (q.cpu() - q_ref).abs(), sum_tol(q_abs, dtype))
        assert torch.equal(q, q2), f"{name} ({label}, {dtype}): two launches differ"
    bnd, h_read = hvp_bound(g, n_blocks, p, q, dtype)
    # the one-call yardstick: torch.sparse.mm with the same global matrix as
    # a BSR tensor of 3x3 blocks, built outside the timing
    bsr = bsr_of([(c, H) for c, H, _s in g], n_blocks)
    pv = p.reshape(-1, 1)
    lib_q = torch.sparse.mm(bsr, pv).reshape(-1, 3)
    torch.cuda.synchronize()
    check("torch.sparse.mm (BSR) yardstick", dtype, (lib_q.cpu() - q_ref).abs(),
          sum_tol(q_abs, dtype))
    ms, lib_ms, timed = same_timer(lambda: hb.hvp_groups(p, g, site),
                                   lambda: torch.sparse.mm(bsr, pv))
    out = dict(max_abs_err=err, ms=ms,
               plain_ms=graph_ms(lambda: hb.hvp_groups_plain(p, g)),
               library_ms=lib_ms, timed=timed, bound_ms=bnd[0], bound_by=bnd[1], rows=rows,
               shape=f"{len(g)} groups, H rows {[int(c.shape[0]) for c, _H, _s in g]}, "
                     f"{h_read} values read")
    log(f"  {name} ({label}): " + json.dumps(out))
    return out


def csr_direct_rows(ev, data, hess):
    """The former design's input to kernel A's direct site, as the parent
    of this design built it: the (R, 9) payload slot pair by slot pair and
    its CSR over the n^2 block pairs (a searchsorted of n^2 + 1 queries).
    Phase 16 times it, with the segmented sum and the permute into the
    block-major layout, against the direct write."""
    from stark_tpu_torch.ops import segment_reduce as sr

    n = ev.n_blocks
    pids, payloads = [], []
    for name, H_e in hess.items():
        conn = data[name]["conn"]
        a = conn.shape[1]
        Hb = H_e.reshape(H_e.shape[0], a, 3, a, 3)
        for i in range(a):
            for j in range(a):
                pids.append(conn[:, i] * n + conn[:, j])
                payloads.append(Hb[:, i, :, j, :].reshape(-1, 9))
    return torch.cat(payloads).contiguous(), sr.build_csr(torch.cat(pids), n * n)


def direct_checks(sim):
    """Phase 16's DirectLLT part, at the final state of phase 15's DirectLLT
    cloth: kernel A's direct site (the zero fill and one write per block
    pair) against its twin on the CPU and against the former design (CSR,
    segmented sum, permute) on the card, both bit for bit, in f32 and f64
    (the f64 payload is the f32 one cast up); the f32 pass timed with its
    one-call yardstick (the zero fill and one index_add_ of the 9R scalars
    into the same matrix, indices built outside the timing), the former
    design, the whole assembly in either design, and the library Cholesky
    (upper, as JAX's cho_factor) and its solve on the assembled matrix."""
    from stark_tpu_torch.ops import segment_reduce as sr
    from stark_tpu_torch.solver import project

    nm = sim.stark.newton
    ev = nm._ev
    n, m = ev.n_blocks, 3 * ev.n_blocks
    data, glob = sim._get_data(), sim._get_glob()
    u = sim.stark._connector["get_dofs"]()
    _E, _aux, g, hess = ev.energy_grad_hess(u, data, glob, None, ev.egh_csr(data))
    hess, _n = project.project_all(hess, 1e-10, False, data, jacobi_sweeps=8,
                                   psd_names=nm._psd_names)
    pay32, ps = ev.direct_rows(data, hess)
    pay_csr, csr = csr_direct_rows(ev, data, hess)
    assert torch.equal(pay_csr, pay32)
    ps_cpu = sr.PairSort(ps.perm.cpu(), ps.key.cpu(), ps.n)
    R = ps.perm.numel()

    def csr_kernel(pay, c):
        D4 = sr.segment_reduce(pay, c, "direct_csr")
        return D4.reshape(n, n, 3, 3).permute(0, 2, 1, 3).reshape(m, m)

    results, info = {}, {}
    for dtype in (torch.float64, torch.float32):
        pay = pay32.to(dtype).contiguous()
        out = sr.dense_direct(pay, ps)
        out2 = sr.dense_direct(pay, ps)
        former = csr_kernel(pay, csr)
        ref = sr.dense_direct_plain(pay.cpu(), ps_cpu)
        torch.cuda.synchronize()
        same = (torch.equal(out.cpu(), ref), torch.equal(out, former), torch.equal(out, out2))
        log(f"  segment_reduce[direct]       {str(dtype):<14} bit for bit: twin {same[0]}, "
            f"former design {same[1]}, relaunch {same[2]}")
        assert all(same), f"kernel A's direct site ({dtype}) is not bit for bit: {same}"
        if dtype != torch.float32:
            continue
        sz = pay.element_size()
        key = ps.key.to(torch.int64)
        i, j = key // n, key % n
        rc = torch.arange(3, device=DEVICE)
        idx = ((3 * i[:, None, None] + rc[None, :, None]) * m + 3 * j[:, None, None]
               + rc[None, None, :])
        idx = torch.where((key < n * n)[:, None, None], idx,
                          torch.full_like(idx, m * m)).reshape(-1)
        vals = pay[ps.perm.to(torch.int64)].reshape(-1).contiguous()

        def lib():
            return torch.zeros(m * m + 1, dtype=dtype, device=DEVICE).index_add_(0, idx, vals)

        check("segment_reduce[direct] yardstick", dtype,
              (lib()[:m * m].view(m, m) - out).abs(),
              sum_tol(sr.dense_direct(pay.abs(), ps), dtype))
        bnd = bound_ms(m * m * sz + R * 9 * sz + nbytes(ps.perm, ps.key), R * 9, dtype)
        hess32 = {k: v.to(dtype) for k, v in hess.items()}
        results["segment_reduce[direct]"] = dict(
            max_abs_err=0.0, ms=graph_ms(lambda: sr.dense_direct(pay, ps)),
            plain_ms=graph_ms(lambda: sr.dense_direct_plain(pay, ps)),
            library_ms=graph_ms(lib), bound_ms=bnd[0], bound_by=bnd[1],
            former_ms=graph_ms(lambda: csr_kernel(pay, csr)),
            fill_ms=graph_ms(lambda: torch.zeros((m, m), dtype=dtype, device=DEVICE)),
            assembly_ms=graph_ms(lambda: ev.assemble_dense_direct(data, hess32)),
            former_assembly_ms=graph_ms(
                lambda: csr_kernel(*csr_direct_rows(ev, data, hess32))),
            shape=f"payload ({R}, 9), {int((ps.key < n * n).sum())} kept -> ({m}, {m}), "
                  f"{n} blocks")
        info["direct_times"] = {k: v for k, v in results["segment_reduce[direct]"].items()
                                if k.endswith("ms")}
        log("  segment_reduce[direct] times: " + json.dumps(info["direct_times"]))
        Hd = ev.assemble_dense_direct(data, hess)
        Hd = Hd + 1e-30 * torch.eye(m, dtype=dtype, device=DEVICE)
        U, fail = torch.linalg.cholesky_ex(Hd, upper=True)
        b = -g.reshape(-1, 1)
        info["cholesky_ms"] = events_ms(lambda: torch.linalg.cholesky_ex(Hd, upper=True),
                                        iters=10)
        info["cholesky_solve_ms"] = events_ms(
            lambda: torch.cholesky_solve(b, U, upper=True), iters=10)
        info["cholesky_info"] = int(fail)
        info["dense_n"] = m
        log(f"  cholesky_ex (upper, {m}^2 f32) {info['cholesky_ms']:.4f} ms, "
            f"cholesky_solve {info['cholesky_solve_ms']:.4f} ms, info={int(fail)}")
    return results, info


def staged_configurations(size):
    """Phase 15 in the main process: the 32x32 cloth (f32, 3 steps) under
    DirectLLT, ProjectOnDemand and Progressive, the squeezed cloth under
    Progressive, and the rigid global_point scene on DirectLLT at 2 ms for
    RIGID_STEPS steps. Returns (DirectLLT launches, runs, the DirectLLT
    cloth's simulation)."""
    from stark_tpu_torch.core.settings import LinearSolver, ProjectionToPD

    runs, launches_direct, sim_direct = {}, None, None
    for label, mode, solver, squeeze in (
            ("direct_llt", "ProjectedNewton", "DirectLLT", 1.0),
            ("project_on_demand", "ProjectOnDemand", "BDPCG", 1.0),
            ("progressive", "Progressive", "BDPCG", 1.0),
            ("progressive_squeezed", "Progressive", "BDPCG", 0.3)):
        sim, h, P = make_cloth(N_DENSE, size, "float32")
        sim.get_settings().newton.projection_mode = getattr(ProjectionToPD, mode)
        sim.get_settings().newton.linear_solver = getattr(LinearSolver, solver)
        if squeeze == 1.0:
            pin_top_corners(sim, h, P, size)
        else:
            # released unpinned from a third of its width: the compressed
            # triangles' strain Hessians are indefinite
            b, n = h.point_set.get_begin(), h.point_set.size()
            sim._dyn._x0_host[b:b + n, 0] *= squeeze
        log(f"  {label}: {mode}, {solver}" + (f", squeezed to {squeeze}" if squeeze < 1 else ""))
        launches, run = run_steps(sim, STAGED_STEPS)
        assert not sim.stark.newton._fused_eligible()
        x = h.point_set.get_positions()
        assert np.all(np.isfinite(x)), f"{label}: non-finite positions"
        ratio = sim.get_logger().series["projected_hessians_ratio"]
        run.update(projected_hessians_ratio=ratio, launches=launches,
                   newton_per_step=sim.get_logger().series["newton_iterations"])
        log(f"    projected ratio {[round(r, 4) for r in ratio]} launches={launches}")
        if solver == "DirectLLT":
            assert launches.get("segment_reduce[direct]", 0) > 0, \
                "DirectLLT's dense scatter never launched"
            run["digest"] = trajectory_digest(sim)
            log(f"    DirectLLT trajectory: {json.dumps(run['digest'])}")
            launches_direct, sim_direct = launches, sim
        else:
            assert launches.get("hvp_bucket[staged]", 0) > 0, f"{label}: B never launched"
        if squeeze < 1.0:
            assert max(ratio) > 0.0 and launches.get("pd_project", 0) > 0, \
                "the squeezed cloth never escalated the projection"
        runs[label] = run
    log("  rigid global_point on DirectLLT, 2 ms")
    runs["rigid_global_point"] = rigid_global_point()
    log("  rigid hinge on DirectLLT, 2 ms")
    runs["rigid_hinge"] = rigid_hinge()
    return launches_direct, runs, sim_direct


def rigid_global_point():
    """tests/test_rb_constraints.py::test_global_point on the card: a box held
    at a point by a global-point constraint under a constant force,
    DirectLLT, 2 ms steps, gravity off, RIGID_STEPS steps."""
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.tools import rb_scenes

    sim = Simulation(rb_scenes.settings("global_point", "float64", DEVICE, direct=True))
    box = rb_scenes.box(sim)
    constraint = sim.rigidbodies.add_constraint_global_point(box, box.get_translation())
    force = rb_scenes.PERTURBATION
    box.set_force([force, 0, 0])
    launches, run = run_steps(sim, RIGID_STEPS)
    C, f = constraint.get_violation_in_m_and_force()
    log(f"    violation {C:.3e} m (tolerance {constraint.get_tolerance_in_m():.1e}), "
        f"force {f:.4f} of {force:.4f} (the spring is still settling at 0.1 s)")
    assert np.isfinite(C) and abs(C) < constraint.get_tolerance_in_m()
    assert launches.get("segment_reduce[direct]", 0) > 0
    run.update(violation_m=C, force=f, applied=force, digest=trajectory_digest(sim))
    log(f"    DirectLLT trajectory: {json.dumps(run['digest'])}")
    return run


def rigid_hinge():
    """A hinge (a point and a direction: kernels T and U) holding a box
    under tests/test_rb_constraints.py's perturbation force and a torque as
    large (tools/rb_scenes.hinge), DirectLLT, 2 ms steps, gravity off,
    RIGID_STEPS steps: both violations within their tolerances."""
    from stark_tpu_torch.tools import rb_scenes

    sim, hinge = rb_scenes.hinge("float64", DEVICE, direct=True)
    launches, run = run_steps(sim, RIGID_STEPS)
    C, f = hinge.get_point().get_violation_in_m_and_force()
    A, t = hinge.get_direction_lock().get_violation_in_deg_and_torque()
    log(f"    point {C:.3e} m (tolerance {hinge.get_point().get_tolerance_in_m():.1e}), "
        f"force {f:.4f}; direction {A:.3e} deg, torque {t:.4f} of "
        f"{rb_scenes.PERTURBATION:.4f} (still settling at 0.1 s)")
    assert np.isfinite(C) and abs(C) < hinge.get_point().get_tolerance_in_m()
    assert np.isfinite(A) and abs(A) < hinge.get_direction_lock().get_tolerance_in_deg()
    assert_launched(launches, ("segment_reduce[direct]", "egh_joints[points]",
                               "egh_joints[directions]"), "the DirectLLT hinge")
    run.update(point_violation_m=C, force=f, direction_violation_deg=A, torque=t,
               applied=rb_scenes.PERTURBATION, digest=trajectory_digest(sim))
    log(f"    DirectLLT trajectory: {json.dumps(run['digest'])}")
    return run


def pd_project_gaps(hess, psd_names):
    """Kernel C's 8 Jacobi sweeps on one evaluation's element Hessians, each
    family in f64 and f32, against the exact projection (eigh in f64 on the
    CPU) and against the twin's 8 sweeps on the CPU: the largest gap of a
    matrix over its largest entry (or its projection's), per family. Logged and recorded, not
    gated: the sweep count is JAX's, and where a spectrum clusters the
    8-sweep result moves with the rounding of its input (PERF.md)."""
    from stark_tpu_torch.ops import pd_project as pd

    gaps = {}
    for name, H in sorted(hess.items()):
        if H.shape[-1] <= 3 or H.shape[0] == 0:
            continue
        H64 = H.double().cpu()
        exact, _ = pd.pd_project_plain(H64, 1e-10, False, jacobi_sweeps=0)
        # a padding row's zero Hessian projects to eps * I
        scale = torch.maximum(H64.abs().amax(dim=(1, 2)), exact.abs().amax(dim=(1, 2)))
        for dtype in (torch.float64, torch.float32):
            k8, _ = pd.pd_project(H.to(dtype).contiguous(), 1e-10, False, jacobi_sweeps=8)
            t8, _ = pd.pd_project_plain(H64.to(dtype), 1e-10, False, jacobi_sweeps=8)
            k8 = k8.double().cpu()

            def rel(a, b):
                return float(((a - b).abs().amax(dim=(1, 2)) / scale).max())
            key = f"{name} {str(dtype).split('.')[-1]}"
            gaps[key] = {"d": int(H.shape[-1]), "rows": int(H.shape[0]),
                         "projected_by_solver": name not in psd_names,
                         "kernel_vs_exact": rel(k8, exact),
                         "twin_vs_exact": rel(t8.double(), exact),
                         "kernel_vs_twin": rel(k8, t8.double())}
            g = gaps[key]
            log(f"  pd_project 8 sweeps {key:<40} d={g['d']:<2} rows={g['rows']:<5} "
                f"solver projects={g['projected_by_solver']!s:<5} |C-exact|/max "
                f"{g['kernel_vs_exact']:.2e} |twin-exact|/max {g['twin_vs_exact']:.2e} "
                f"|C-twin|/max {g['kernel_vs_twin']:.2e}")
    return gaps


def staged_kernel_checks(sim):
    """Phase 16 at phase 14's final state: kernel I's contact mode (K16)
    exactly against its twins on the CPU in f64 and f32, the whole contact
    refresh against the engine's twin path, kernel B at its staged site
    over the arity groups of one evaluation (contact and friction tables
    included) against the twins, under the sum tolerance; the f32 passes
    timed, B beside the one-call BSR torch.sparse.mm."""
    from stark_tpu_torch.ops import friction_pairs as fp, hvp_bucket as hb
    from stark_tpu_torch.solver import project

    eng, nm, u, Vs32, Vr32 = contact_state(sim)
    ev = nm._ev
    contact = sim.interactions.contact
    ptol = contact.edge_edge_cross_norm_sq_cutoff
    V32 = eng._vcat(Vs32, Vr32).contiguous()
    scale = 1.0 + float(V32.abs().max())
    results, info = {}, {}
    kinds = {"pt": (fp.contact_pairs_pt, fp.contact_pairs_pt_plain),
             "ee": (fp.contact_pairs_ee, fp.contact_pairs_ee_plain)}

    def grid(kind, dtype, device):
        V, th = V32.to(device=device, dtype=dtype), eng.th_vec().to(device=device, dtype=dtype)
        if kind == "pt":
            return (V, eng.d_tris_all.to(device), eng.d_pt_allowed.to(device),
                    eng.d_p_mesh32.to(device), eng.d_t_mesh32.to(device), th,
                    eng._cap("cl_pt"))
        return (V, eng.d_edges_all.to(device), eng.d_ee_allowed.to(device),
                eng.d_e_mesh32.to(device), th, eng._cap("cl_ee"), ptol)

    for dtype in (torch.float64, torch.float32):
        main = dtype == torch.float32
        log(f"-- {dtype}")
        eps = torch.finfo(dtype).eps
        for kind, (kern, plain) in kinds.items():
            args = grid(kind, dtype, DEVICE)
            out = [x.cpu() for x in kern(*args)]
            ref = plain(*grid(kind, dtype, "cpu"))
            torch.cuda.synchronize()
            cap = args[6] if kind == "pt" else args[5]
            n, n_k = int(ref[4]), int(out[4])
            assert n <= cap, f"contact_pairs[{kind}]: raise the capacity ({n} > {cap})"
            same = n_k == n and all(torch.equal(out[i], ref[i]) for i in (0, 1, 3))
            # the rows both lists hold, matched by pair key (both lists are
            # row-major, so the common rows come in the same order): their
            # thresholds equal, their distances compared below
            nt = args[1].shape[0]
            k_key = out[0][:n_k].long() * nt + out[1][:n_k].long()
            r_key = ref[0][:n].long() * nt + ref[1][:n].long()
            k_in, r_in = torch.isin(k_key, r_key), torch.isin(r_key, k_key)
            assert torch.equal(k_key[k_in], r_key[r_in])
            assert torch.equal(out[3][:n_k][k_in], ref[3][:n][r_in]), \
                f"contact_pairs[{kind}] ({dtype}): thresholds differ from the twin's"
            left_out = int((~k_in).sum()) + int((~r_in).sum())
            if not same:
                # f32: a pair whose keep verdict f32 rounding decides (its f64
                # distance within 64 eps of the scale of dhat) may be listed
                # by one side only; anything else is a fault
                assert main, f"contact_pairs[{kind}] ({dtype}) differs from its twin"
                ref64 = plain(*grid(kind, torch.float64, "cpu"))
                n64 = int(ref64[4])
                d64 = dict(zip((ref64[0][:n64].long() * nt + ref64[1][:n64].long()).tolist(),
                               (ref64[2][:n64] - ref64[3][:n64]).tolist()))
                for key in torch.cat([k_key[~k_in], r_key[~r_in]]).tolist():
                    gap = d64.get(key)
                    assert gap is None or abs(gap) <= 64 * eps * scale, \
                        f"contact_pairs[{kind}]: pair {key} is not rounding-decided"
            assert int(k_in.sum()) > 0, f"contact_pairs[{kind}]: no pair to compare"
            d_err = (out[2][:n_k][k_in] - ref[2][:n][r_in]).abs()
            err = check(f"contact_pairs[{kind}] d n={n} left_out={left_out}", dtype, d_err,
                        torch.full_like(d_err, 64 * eps * scale))
            if not main:
                continue
            # bound: the mask, vertices, table, mesh ids and th read once, the
            # (cap,) lists and the count written once; one distance per
            # allowed pair, priced by its region (I's friction pass's counts)
            table, allowed = args[1], args[2]
            meshes = args[3:5] if kind == "pt" else args[3:4]
            nq, nt = allowed.shape
            keep = allowed.bool()
            ops = ops_of(region_hist(kind, args[0], table, keep, ptol), DIST_OPS[kind],
                         REGION_OPS[kind])
            el = args[0].element_size()
            bnd = bound_ms(nq * nt + nbytes(args[0], table, *meshes, args[-2 if kind == "pt"
                                                                           else -3])
                           + cap * (8 + 2 * el) + 4, ops, dtype)
            # the friction mode of the same kernel on the same inputs with
            # mu = 1 everywhere evaluates the same pairs: timed beside it
            mu1 = torch.ones((len(contact.contact_thicknesses),) * 2, dtype=dtype,
                             device=DEVICE)
            fargs = args[:-2] + (mu1,) + args[-2:] if kind == "pt" else \
                args[:-3] + (mu1,) + args[-3:]
            fkern = fp.friction_pairs_pt if kind == "pt" else fp.friction_pairs_ee
            info[f"friction_mode_ms[{kind}]"] = graph_ms(lambda: fkern(*fargs))
            results[f"contact_pairs[{kind}]"] = dict(
                max_abs_err=err, ms=graph_ms(lambda: kern(*args)),
                plain_ms=events_ms(lambda: plain(*args), iters=3),
                library_ms=None, bound_ms=bnd[0], bound_by=bnd[1], left_out=left_out,
                shape=f"{nq}x{nt} grid, {int(keep.sum())} pairs evaluated "
                      f"({ops / max(int(keep.sum()), 1):.1f} ops each), {n} kept, cap {cap}")
            log(f"  contact_pairs[{kind}] {results[f'contact_pairs[{kind}]']['ms']:.4f} ms, "
                f"its friction mode (mu = 1) on the same inputs "
                f"{info[f'friction_mode_ms[{kind}]']:.4f} ms")

    # the whole refresh (both kinds, routing, family tables, the cut to the
    # live rows) against the engine's twin path, f32
    th = eng.th_vec()
    tables, counts = eng._settled(lambda: eng._contacts_fn(Vs32, Vr32, th))
    assert sorted(counts) == sorted(eng.contact_count_keys())
    with twins_on_cpu(eng):
        tables_c, counts_c = eng._settled(lambda: eng._contacts_fn(Vs32, Vr32, th))
    assert counts == counts_c, (counts, counts_c)
    same_tree(tables, tables_c, "refresh_contacts tables")
    info["refresh_counts"] = counts
    log("  refresh_contacts (dense branch) equals the twin path's: "
        + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))

    # B at its staged site on one evaluation's arity groups
    eng._contact_data = tables
    if eng._friction_data is None:
        eng.refresh_friction(sim.stark.dt)
    data, glob = sim._get_data(), sim._get_glob()
    # as the staged solver evaluates: the live rows (the padding's projected
    # eps * I is a diagonal term of the solver's own, outside B)
    data = nm._live_tables(data)
    _E, _aux, _g, hess = ev.energy_grad_hess(u, data, glob, None, ev.egh_csr(data))
    info["pd_project_vs_exact"] = pd_project_gaps(hess, nm._psd_names)
    hess, _n = project.project_all(hess, 1e-10, False, data, jacobi_sweeps=8,
                                   psd_names=nm._psd_names)
    groups = ev.staged_groups(data)
    rng = np.random.default_rng(16)
    p32 = torch.as_tensor(rng.normal(size=(ev.n_blocks, 3)), dtype=torch.float32,
                          device=DEVICE)
    info["staged_groups"] = {a: [list(g.names), int(g.conn32.shape[0])]
                             for a, g in groups.items()}
    # the solver's own call, then kernel B's checks over the same groups
    ctx = ev.hvp_context(groups, hess)
    trip = [(ctx[a].conn32, ctx[a].H, ctx[a].csr) for a in sorted(ctx)]
    q = ev.hvp_ctx(p32, ctx)
    assert torch.equal(q, hb.hvp_groups(p32, trip, "staged")), \
        "hvp_ctx and one launch over its groups differ"
    results["hvp_bucket[staged]"] = hvp_site("phase 16 staged groups", trip, ev.n_blocks,
                                             p32, "staged")
    return results, info


def staged_run(out_json: str, go_file: str = None) -> int:
    """Phases 14 and 16, run as `chip_smoke.py --staged OUT_JSON [GO_FILE]`:
    the 32x32 spinning box with friction in float32 through the staged
    solver for STAGED_SECONDS, its checks, then phase 16 at its final
    state; writes the fields, the main path's launches and the kernel
    records. With GO_FILE, phase 16 starts once that file exists: the main
    process writes it when the other processes are done with the card, so
    that phase 16's times are not shared with them."""
    os.environ[NO_FUSED_ENV] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)     # four processes share the host's cores
    t0 = time.perf_counter()
    sim, cloth, spin = make_spinning_box(N_SBC, "float32", mu=FRICTION_MU)
    sim.add_time_event(0.0, 10.0, spin)
    steps = int(round(STAGED_SECONDS / sim.stark.settings.simulation.max_time_step_size))
    launches, fields = run_spinning_box(sim, steps)
    launches["compact"] = sum(v for k, v in launches.items() if k.startswith("compact["))
    fields["fused_eligible"] = sim.stark.newton._fused_eligible()
    # the staged solver logs no host_syncs (its reads are not one per loop
    # test as in the fused solve's count) and no shell rebuilds
    for key in ("host_syncs_per_step", "broad_rebuilds", "pair_rebuilds",
                "fused_retraces", "count_max", "solver_codes"):
        fields.pop(key)
    print("staged run: " + json.dumps(fields), flush=True)
    print(f"launches={launches}", flush=True)
    x = cloth.point_set.get_positions()
    assert not fields["fused_eligible"], "the no-fused switch did not take"
    assert np.all(np.isfinite(x)), "non-finite positions"
    assert fields["live_pairs_last"] > 0, "no live contact pairs"
    assert fields["friction_rows_last"] > 0, "no friction rows"
    assert not intersects_now(sim), "the final state intersects"
    assert_launched(launches, STAGED_KERNELS, "the staged path")
    assert_egh_path(sim, launches, BOX_FAMILIES, "the staged path",
                    optional=[n for n in BOX_FAMILIES if n.startswith("contact_")])
    assert_egh_path(sim, launches, BOX_FRICTION_FAMILIES, "the staged path",
                    optional=BOX_FRICTION_FAMILIES)
    if go_file:
        t_wait = time.perf_counter()
        while not os.path.exists(go_file):
            assert time.perf_counter() - t_wait < 1200, "no go from the main process"
            time.sleep(0.5)
        print(f"waited {time.perf_counter() - t_wait:.1f}s for the card", flush=True)
    print("-- phase 16", flush=True)
    torch.set_num_threads(4)     # the twins' CPU runs
    results, info = staged_kernel_checks(sim)
    with open(out_json, "w") as f:
        json.dump({"fields": fields, "launches": launches, "results": results,
                   "info": info, "seconds": time.perf_counter() - t0}, f)
    return 0


# ---------------------------------------------------------------------------
# phases 18-20: rods and volumes (kernels R, S) and soft bodies on a rigid
# floor with friction (Q): upstream's example scenes at their sizes
# ---------------------------------------------------------------------------
COMPOSITE_SECONDS, COLLISIONS_SECONDS, NET_SECONDS = 0.25, 0.3, 0.25
COMPOSITE_FAMILIES = ("EnergyLumpedInertia", "EnergyPrescribedPositions",
                      "EnergySegmentStrain", "EnergyTriangleStrain", "EnergyBendingFlat",
                      "EnergyTetStrain")
COLLISIONS_FAMILIES = ("EnergyLumpedInertia", "EnergyTetStrain",
                       "EnergyRigidBodyInertia_Linear", "EnergyRigidBodyInertia_Angular",
                       "rb_constraint_global_points", "rb_constraint_global_directions")
NET_FAMILIES = ("EnergyLumpedInertia", "EnergyPrescribedPositions", "EnergySegmentStrain")
STEMS = ("pt_dd", "pt_dr", "pt_rd", "pt_rr", "ee_dd", "ee_dr", "ee_rr")
CONTACT_FAMILIES = tuple("contact_" + st for st in STEMS)
FRICTION_FAMILIES = tuple("friction_" + st for st in STEMS)
# the spinning box's friction families (cloth and box, cloth and itself)
BOX_FRICTION_FAMILIES = ("friction_pt_dd", "friction_pt_dr", "friction_pt_rd",
                         "friction_ee_dd", "friction_ee_dr")


def run_scene(sim, seconds: float, where: str):
    """Step a scene for `seconds` at its largest step (bench.py's fields,
    run_spinning_box's bookkeeping) and print the fields."""
    steps = int(round(seconds / sim.stark.settings.simulation.max_time_step_size))
    launches, fields = run_spinning_box(sim, steps)
    launches["compact"] = sum(v for k, v in launches.items() if k.startswith("compact["))
    fields["fused_eligible"] = sim.stark.newton._fused_eligible()
    print(f"{where}: " + json.dumps(fields), flush=True)
    print(f"launches={launches}", flush=True)
    return launches, fields


def volumes_run(out_json: str, go_file: str = None) -> int:
    """Phases 18-20, run as `chip_smoke.py --volumes OUT_JSON [GO_FILE]`, in
    float32: hanging_box_with_composite_material (n = 10) for
    COMPOSITE_SECONDS, deformable_and_rigid_collisions (n1 = 5, n2 = 2, mu
    = 1) for COLLISIONS_SECONDS and hanging_net (n = 20) for NET_SECONDS,
    each with bench.py's fields and its checks; then phase 17's checks of
    R and S at phase 18's end state and of Q at phase 19's (kernel against
    twin, f64 and f32), and, once GO_FILE exists (the other processes are
    done with the card), their times; writes the fields, launches and
    records."""
    from stark_tpu_torch.tools.scenes import (deformable_and_rigid_collisions,
                                              hanging_box_with_composite_material,
                                              hanging_net)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)     # five processes share the host's cores
    t0 = time.perf_counter()
    out = {"fields": {}, "launches": {}, "egh": {}}

    print("-- phase 18", flush=True)
    sim18, nodes = hanging_box_with_composite_material("float32", DEVICE)
    x_rest = nodes.get_positions().copy()
    pins = np.asarray(sim18.deformables.prescribed_positions._nodes)
    launches, fields = run_scene(sim18, COMPOSITE_SECONDS, "phase 18")
    x = nodes.get_positions()
    pin_dev = float(np.max(np.linalg.norm(x[pins] - x_rest[pins], axis=1)))
    fields["pin_deviation"] = pin_dev
    fields["mean_dz"] = float(np.mean(x[:, 2] - x_rest[:, 2]))
    assert np.all(np.isfinite(x)), "phase 18: non-finite positions"
    assert fields["mean_dz"] < 0.0, "phase 18: the box does not sag"
    assert pin_dev < 2e-3, f"phase 18: pins moved by {pin_dev}"
    assert_launched(launches, ("segment_reduce[egh]", "segment_reduce[diag]", "hvp_bucket",
                               "pd_project"), "phase 18")
    assert_egh_path(sim18, launches, COMPOSITE_FAMILIES, "phase 18")
    out["fields"]["phase18"], out["launches"]["phase18"] = fields, launches

    print("-- phase 19", flush=True)
    sim19, (h1, h2, _floor) = deformable_and_rigid_collisions("float32", DEVICE)
    launches, fields = run_scene(sim19, COLLISIONS_SECONDS, "phase 19")
    x1, x2 = h1.point_set.get_positions(), h2.point_set.get_positions()
    fields["box_min_z"] = [float(x1[:, 2].min()), float(x2[:, 2].min())]
    assert np.all(np.isfinite(x1)) and np.all(np.isfinite(x2)), "phase 19: non-finite"
    assert 0.0 < fields["box_min_z"][0] < 5e-3, \
        f"phase 19: the lower box is not on the floor: {fields['box_min_z']}"
    # the heavy upper box (1e4 kg/m^3) sinks well into the soft lower one
    # (E = 1e4 Pa): it rests on it, above its bottom, and nothing intersects
    assert fields["box_min_z"][1] > fields["box_min_z"][0] + 0.05, \
        f"phase 19: the upper box is not on the lower one: {fields['box_min_z']}"
    assert fields["live_pairs_last"] > 0 and fields["friction_rows_last"] > 0, \
        "phase 19: no live contact or friction rows"
    assert not intersects_now(sim19), "phase 19: the final state intersects"
    assert_launched(launches, CONTACT_KERNELS + FRICTION_KERNELS, "phase 19")
    assert_egh_path(sim19, launches, COLLISIONS_FAMILIES, "phase 19")
    assert_egh_path(sim19, launches, CONTACT_FAMILIES, "phase 19", optional=CONTACT_FAMILIES)
    assert_egh_path(sim19, launches, FRICTION_FAMILIES, "phase 19", optional=FRICTION_FAMILIES)
    out["fields"]["phase19"], out["launches"]["phase19"] = fields, launches

    print("-- phase 20", flush=True)
    sim20, net = hanging_net("float32", DEVICE)
    x_rest = net.point_set.get_positions().copy()
    launches, fields = run_scene(sim20, NET_SECONDS, "phase 20")
    x = net.point_set.get_positions()
    fields["min_z"] = float(x[:, 2].min())
    assert np.all(np.isfinite(x)), "phase 20: non-finite positions"
    assert fields["min_z"] < -0.01, "phase 20: the net does not sag"
    assert_launched(launches, ("segment_reduce[egh]", "hvp_bucket"), "phase 20")
    assert_egh_path(sim20, launches, NET_FAMILIES, "phase 20")
    out["fields"]["phase20"], out["launches"]["phase20"] = fields, launches

    print("-- phase 17 (phases 18 and 19's states)", flush=True)
    torch.set_num_threads(4)     # the twins' CPU runs
    out["egh"]["phase18"] = egh_checks(sim18, COMPOSITE_FAMILIES, "phase 18", 18)
    out["egh"]["phase19"] = egh_checks(
        sim19, COLLISIONS_FAMILIES + CONTACT_FAMILIES + FRICTION_FAMILIES, "phase 19", 19)
    if go_file:
        t_wait = time.perf_counter()
        while not os.path.exists(go_file):
            assert time.perf_counter() - t_wait < 1200, "no go from the main process"
            time.sleep(0.5)
        print(f"waited {time.perf_counter() - t_wait:.1f}s for the card", flush=True)
    print("-- phase 17 (times)", flush=True)
    out["times"] = {
        "phase18": egh_timings(sim18, ("EnergySegmentStrain", "EnergyTetStrain"), 18,
                               out["launches"]["phase18"]),
        "phase19": egh_timings(sim19, FRICTION_FAMILIES, 19, out["launches"]["phase19"])}
    out["seconds"] = time.perf_counter() - t0
    with open(out_json, "w") as f:
        json.dump(out, f)
    return 0


# ---------------------------------------------------------------------------
# phases 21-22: the rigid joints (kernels T, U) and full shells (kernel V)
# ---------------------------------------------------------------------------
JOINT_FAMILIES = ("rb_constraint_points", "rb_constraint_point_on_axis",
                  "rb_constraint_distances", "rb_constraint_distance_limits",
                  "rb_constraint_directions", "rb_constraint_angle_limits",
                  "rb_constraint_damped_spring", "rb_constraint_linear_velocity",
                  "rb_constraint_angular_velocity")
RIGID_FAMILIES = ("EnergyRigidBodyInertia_Linear", "EnergyRigidBodyInertia_Angular",
                  "rb_constraint_global_points", "rb_constraint_global_directions")
# simple_grasp: the cube's tets and inertia, the rigid bodies, the fixed
# hand and the two prismatic presses (a point on an axis, two directions and
# a force-capped linear velocity each)
PRESS_FAMILIES = ("rb_constraint_point_on_axis", "rb_constraint_directions",
                  "rb_constraint_linear_velocity")
GRASP_FAMILIES = ("EnergyLumpedInertia", "EnergyTetStrain_ElasticityOnly") + RIGID_FAMILIES \
    + PRESS_FAMILIES
CHAIN_FAMILIES = RIGID_FAMILIES + JOINT_FAMILIES
FULL_CLOTH_FAMILIES = ("EnergyLumpedInertia", "EnergyTriangleStrain", "EnergyDiscreteShells",
                       "EnergyPrescribedPositions")
GRASP_SECONDS, CHAIN_SECONDS, FULL_CLOTH_STEPS = 0.3, 0.3, 6
# the stems of the cube's contact with the fingers (a soft point on a
# finger's face, a finger's corner on the cube's face, an edge of each)
GRASP_STEMS = ("pt_dr", "pt_rd", "ee_dr")


def run_through_run(sim, seconds: float, where: str):
    """Step a scene through Simulation.run for `seconds` (its time events
    fire there), with run_spinning_box's fields from a callback before each
    step and from the last step; print them. The counts of the kernels are
    set to 0 just before and read just after."""
    from stark_tpu_torch.ops import build

    logger = sim.get_logger()
    count_max, live, fric, marks = {}, [], [], []

    def record():
        nm = sim.stark.newton
        if sim.stark.current_time_step > 0:
            for k, v in nm._last_counts.items():
                count_max[k] = max(count_max.get(k, 0), int(v))
            live.append(nm.live_contact_pairs())
            fric.append(nm.friction_rows())

    def before_step():
        record()
        if len(marks) == 1:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(),
                          int(logger.get_stats("newton_iterations").total)))
        elif not marks:
            marks.append(None)

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert sim.run(seconds, before_step), f"{where}: a time step failed"
    record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(build.launches, **func_launches())
    launches["compact"] = sum(v for k, v in launches.items() if k.startswith("compact["))
    t_warm, warm_newton = marks[1] if len(marks) > 1 else (t0, 0)
    fields = bench_fields(sim, (t0, t_warm, t1), warm_newton, count_max, live, fric)
    fields.update(last_counts={k: int(v) for k, v in sim.stark.newton._last_counts.items()},
                  fused_eligible=sim.stark.newton._fused_eligible())
    print(f"{where}: " + json.dumps(fields), flush=True)
    print(f"launches={launches}", flush=True)
    return launches, fields


def grasp_run():
    """Phase 21: upstream's simple_grasp at its sizes in f32 through
    Simulation.run for GRASP_SECONDS, with bench.py's fields and its checks.
    Returns (sim, launches, fields)."""
    from stark_tpu_torch.tools.scenes import simple_grasp

    print("-- phase 21", flush=True)
    sim, (cube, _hand, left, right, press_l, press_r) = simple_grasp("float32", DEVICE)
    x_rest = cube.point_set.get_positions().copy()
    gap0 = right.rigidbody.get_translation()[0] - left.rigidbody.get_translation()[0]
    launches, fields = run_through_run(sim, GRASP_SECONDS, "phase 21")
    x = cube.point_set.get_positions()
    gap = right.rigidbody.get_translation()[0] - left.rigidbody.get_translation()[0]
    presses = {}
    for label, p in (("left", press_l), ("right", press_r)):
        presses[label] = p.get_linear_velocity().get_signed_velocity_violation_and_force()
        poa = p.get_prismatic_slider().get_slider().get_point_on_axis()
        presses[label + "_axis_m"] = poa.get_violation_in_m_and_force()[0]
    fields.update(nodes=len(x), finger_gap_m=[gap0, gap],
                  cube_width_m=float(x[:, 0].max() - x[:, 0].min()),
                  cube_mean_dz_m=float(np.mean(x[:, 2] - x_rest[:, 2])), presses=presses)
    print("phase 21 presses: " + json.dumps(presses), flush=True)
    tets = sim._get_static_data()["EnergyTetStrain_ElasticityOnly"]["rows"]["active"]
    assert len(x) == 216 and int((tets > 0.5).sum()) == 625, "phase 21: not upstream's sizes"
    assert np.all(np.isfinite(x)), "phase 21: non-finite positions"
    stems = {st: fields["last_counts"].get(st, 0) for st in GRASP_STEMS}
    assert sum(stems.values()) > 0 and fields["live_pairs_last"] > 0 \
        and fields["friction_rows_last"] > 0, \
        f"phase 21: the fingers hold no live pairs or friction rows: {stems}"
    assert gap < gap0 - 0.02, f"phase 21: the fingers did not close: {gap0} -> {gap}"
    assert fields["cube_width_m"] < 0.2, "phase 21: the cube is not squeezed"
    assert not intersects_now(sim), "phase 21: the final state intersects"
    # each finger held back from its +-1 m/s by the cube, at its 5 N cap
    for label, sign in (("left", -1.0), ("right", 1.0)):
        dv, f = presses[label]
        assert np.isfinite(dv) and sign * dv > 0.0 and abs(f) == 5.0, \
            f"phase 21: {label} press violation {dv}, force {f}"
        assert presses[label + "_axis_m"] < 1e-3, f"phase 21: {label} left its axis"
    assert_launched(launches, ("segment_reduce[egh]", "segment_reduce[diag]", "hvp_bucket",
                               "pd_project") + CONTACT_KERNELS + FRICTION_KERNELS,
                    "phase 21")
    assert_egh_path(sim, launches, GRASP_FAMILIES, "phase 21")
    assert_egh_path(sim, launches, CONTACT_FAMILIES, "phase 21", optional=CONTACT_FAMILIES)
    assert_egh_path(sim, launches, FRICTION_FAMILIES, "phase 21", optional=FRICTION_FAMILIES)
    return sim, launches, fields


def rb_constraint_scenes() -> dict:
    """Phase 22a: the ten joint scenes of tests/test_rb_constraints.py on
    the fused path in f64 (tools/rb_scenes.py: 10 ms for 0.5 s, the
    distance limits for 1 s), each with its force balance."""
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.tools import rb_scenes

    out = {}
    for name in sorted(rb_scenes.SCENES):
        build.reset_launches()
        t0 = time.perf_counter()
        sim, ok, checks = rb_scenes.run(name, "float64", DEVICE)
        torch.cuda.synchronize()
        launches = dict(build.launches, **func_launches())
        out[name] = {"ok": ok, "checks": [list(c) for c in checks],
                     "steps": sim.stark.current_time_step,
                     "newton": int(sim.get_logger().get_stats("newton_iterations").total),
                     "wall_s": time.perf_counter() - t0,
                     "fused": sim.stark.newton._fused_eligible()}
        print(f"  {name}: " + ", ".join(f"{l} {v:.3e} (< {m:g})" for l, v, m in checks)
              + f"; {out[name]['steps']} steps, {out[name]['newton']} Newton, "
              f"{out[name]['wall_s']:.1f}s", flush=True)
        assert ok and out[name]["fused"], f"phase 22 {name}: the run failed"
        for label, value, limit in checks:
            assert value < limit, f"phase 22 {name}: {label} {value} over {limit}"
        fams = [f.name for f in sim.stark.global_potential.families
                if f.name in JOINT_FAMILIES and f.name in sim._get_static_data()]
        assert fams, f"phase 22 {name}: no joint family"
        assert_egh_path(sim, launches, tuple(fams), f"phase 22 {name}")
    return out


def chain_run():
    """Phase 22b: tools/scenes.rigid_joint_chain (every joint family) in f32
    for CHAIN_SECONDS. Returns (sim, launches, fields)."""
    from stark_tpu_torch.tools.scenes import rigid_joint_chain

    sim, bodies = rigid_joint_chain("float32", DEVICE)
    t_rest = [b.get_translation().copy() for b in bodies]
    launches, fields = run_scene(sim, CHAIN_SECONDS, "phase 22 chain")
    moved = [float(np.linalg.norm(b.get_translation() - t)) for b, t in zip(bodies, t_rest)]
    fields["moved_m"] = moved
    assert all(np.all(np.isfinite(b.get_translation())) for b in bodies)
    assert moved[0] < 1e-3 and max(moved[1:]) > 1e-3, f"phase 22 chain: moved {moved}"
    assert_launched(launches, ("segment_reduce[egh]", "hvp_bucket"), "phase 22 chain")
    assert_egh_path(sim, launches, CHAIN_FAMILIES, "phase 22 chain")
    return sim, launches, fields


def full_cloth_run():
    """Phase 22c: the 32x32 hanging cloth with full DiscreteShells (kernel
    V) in f32 for FULL_CLOTH_STEPS steps: finite, sagging, pins held.
    Returns (sim, launches, fields)."""
    size = 0.4
    sim, h, P = make_cloth(N_DENSE, size, "float32", flat_shells=False)
    pin_top_corners(sim, h, P, size)
    x_rest = h.point_set.get_positions().copy()
    pins = np.asarray(sim.deformables.prescribed_positions._nodes)
    launches, fields = run_steps(sim, FULL_CLOTH_STEPS)
    x = h.point_set.get_positions()
    free = np.setdiff1d(np.arange(len(x)), pins)
    fields.update(mean_free_z=float(np.mean(x[free, 2])),
                  pin_deviation=float(np.max(np.linalg.norm(x[pins] - x_rest[pins], axis=1))))
    print("phase 22 cloth: " + json.dumps(fields), flush=True)
    assert np.all(np.isfinite(x)), "phase 22 cloth: non-finite positions"
    assert fields["mean_free_z"] < 0.0, "phase 22 cloth: the cloth does not sag"
    assert fields["pin_deviation"] < 2e-3, "phase 22 cloth: the pins moved"
    assert_egh_path(sim, launches, FULL_CLOTH_FAMILIES, "phase 22 cloth")
    return sim, launches, fields


def joints_run(out_json: str, go_file: str = None) -> int:
    """Phases 21-22, run as `chip_smoke.py --joints OUT_JSON [GO_FILE]`:
    simple_grasp, the rb_constraints scenes, the joint chain and the
    full-shell cloth; then phase 17's checks of T, U and V at phase 21's and
    22's states (kernel against twin, f64 and f32) and, once GO_FILE exists
    (the other processes are done with the card), their times; writes the
    fields, launches and records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)     # six processes share the host's cores
    t0 = time.perf_counter()
    out = {"fields": {}, "launches": {}, "egh": {}}
    sim21, out["launches"]["phase21"], out["fields"]["phase21"] = grasp_run()

    print("-- phase 22", flush=True)
    out["fields"]["rb_constraints"] = rb_constraint_scenes()
    sim22, out["launches"]["chain"], out["fields"]["chain"] = chain_run()
    sim22c, out["launches"]["cloth"], out["fields"]["cloth"] = full_cloth_run()

    print("-- phase 17 (phases 21 and 22's states)", flush=True)
    torch.set_num_threads(4)     # the twins' CPU runs
    out["egh"]["phase21"] = egh_checks(
        sim21, GRASP_FAMILIES + CONTACT_FAMILIES + FRICTION_FAMILIES, "phase 21", 21)
    out["egh"]["chain"] = egh_checks(sim22, CHAIN_FAMILIES, "phase 22", 22)
    out["egh"]["cloth"] = egh_checks(sim22c, FULL_CLOTH_FAMILIES, "phase 22", 23)
    if go_file:
        t_wait = time.perf_counter()
        while not os.path.exists(go_file):
            assert time.perf_counter() - t_wait < 1200, "no go from the main process"
            time.sleep(0.5)
        print(f"waited {time.perf_counter() - t_wait:.1f}s for the card", flush=True)
    print("-- phase 17 (times)", flush=True)
    out["times"] = {
        "phase21": egh_timings(sim21, PRESS_FAMILIES, 21, out["launches"]["phase21"]),
        "chain": egh_timings(sim22, tuple(n for n in JOINT_FAMILIES
                                          if n not in PRESS_FAMILIES), 22,
                             out["launches"]["chain"]),
        "cloth": egh_timings(sim22c, ("EnergyDiscreteShells",), 23, out["launches"]["cloth"])}
    out["seconds"] = time.perf_counter() - t0
    with open(out_json, "w") as f:
        json.dump(out, f)
    return 0


# ---------------------------------------------------------------------------
# phase 23: upstream's attachments example (kernel W) with frame output
# ---------------------------------------------------------------------------
ATTACH_FAMILIES = ("EnergyAttachments_d_d_p_p", "EnergyAttachments_d_d_p_e",
                   "EnergyAttachments_d_d_p_t", "EnergyAttachments_d_d_e_e",
                   "EnergyAttachments_rb_d")
# the example's other families: two Cotton_Fabric cloths (M, P's flat
# shells and lumped inertia), A's two pins and the box's inertia (P)
ATTACH_SCENE_FAMILIES = ("EnergyLumpedInertia", "EnergyTriangleStrain", "EnergyBendingFlat",
                         "EnergyPrescribedPositions", "EnergyRigidBodyInertia_Linear",
                         "EnergyRigidBodyInertia_Angular")
N_ATTACH, ATTACH_SECONDS = 20, 0.4
ATTACH_LABELS = ("A", "B", "box")
FRAMES_DIR = os.path.join(OUT_DIR, "frames", "attachments")


def expected_frames(fps: float, t_end: float) -> int:
    """Frames core/stark.py writes from t = 0 to t_end at `fps`: the first,
    then one each time the clock passes the next frame time."""
    eps = 100.0 * np.finfo(np.float64).eps
    return 1 + sum(1 for k in range(1, int(t_end * fps) + 2) if t_end > k / fps + eps)


def attachments_run(out_json: str, go_file: str = None) -> int:
    """Phase 23, run as `chip_smoke.py --attachments OUT_JSON [GO_FILE]`:
    upstream's attachments example at its sizes, built through
    stark_tpu_torch.examples, in float32 through Simulation.run for
    ATTACH_SECONDS with VTK frames under FRAMES_DIR; its checks; then
    phase 17's checks of kernel W (and the scene's other kernels) at its end
    state and, once GO_FILE exists (the other processes are done with the
    card), W's times; writes the fields, launches and records."""
    import shutil

    from stark_tpu_torch import examples
    from stark_tpu_torch.utils.vtk import read_vtk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)     # seven processes share the host's cores
    t0 = time.perf_counter()
    out = {"fields": {}, "launches": {}, "egh": {}}
    print("-- phase 23", flush=True)
    shutil.rmtree(FRAMES_DIR, ignore_errors=True)
    s = examples.base_settings("attachments")
    s.output.output_directory = FRAMES_DIR
    s.output.enable_output = False
    s.device.device = DEVICE
    s.device.dtype = "float32"
    sim, h = examples.build_attachments(s, N_ATTACH)
    att = sim.interactions.attachments
    rows = {k: len(att._elems[k]) for k in ATTACH_FAMILIES}
    with_rows = tuple(k for k in ATTACH_FAMILIES if rows[k])
    print("phase 23 rows: " + json.dumps(rows), flush=True)
    dyn = sim._dyn
    sets = {"A": h.a.point_set.all_global_indices(), "B": h.b.point_set.all_global_indices()}
    x_rest = dyn.host_x_all().copy()
    box_rest = h.box.rigidbody.get_translation().copy()
    pins = np.asarray(sim.deformables.prescribed_positions._nodes)
    launches, fields = run_through_run(sim, ATTACH_SECONDS, "phase 23")

    x = dyn.host_x_all()
    box_t = h.box.rigidbody.get_translation()
    gaps = {}
    for k in with_rows:
        g = att.gaps(k, current=True)
        tol = np.asarray([att.groups[k][e["group"]]["tolerance"] for e in att._elems[k]])
        gaps[k] = {"max_gap_m": float(g.max()), "tolerance_m": float(tol.min()),
                   "stiffness": [grp["stiffness"] for grp in att.groups[k]]}
        assert np.all(g <= tol), f"phase 23: {k} gaps {float(g.max())} past {float(tol.min())}"
    frames = sim.get_frame()
    fps = s.output.fps
    n_expected = expected_frames(fps, sim.get_time())
    fields.update(rows=rows, gaps=gaps, frames=frames, frames_expected=n_expected,
                  pin_deviation=float(np.max(np.linalg.norm(x[pins] - x_rest[pins], axis=1))),
                  b_mean_dz_m=float(np.mean(x[sets["B"], 2] - x_rest[sets["B"], 2])),
                  box_dz_m=float(box_t[2] - box_rest[2]))
    print("phase 23 checks: " + json.dumps({k: fields[k] for k in (
        "rows", "gaps", "frames", "frames_expected", "pin_deviation", "b_mean_dz_m",
        "box_dz_m")}), flush=True)
    assert len(sets["A"]) == len(sets["B"]) == (N_ATTACH + 1) ** 2, \
        "phase 23: not upstream's sizes"
    assert set(with_rows) == {"EnergyAttachments_d_d_p_e", "EnergyAttachments_d_d_p_t",
                              "EnergyAttachments_rb_d"}, f"phase 23: rows {rows}"
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(box_t)), "phase 23: non-finite"
    assert fields["pin_deviation"] < 2e-3, f"phase 23: A's pins moved {fields['pin_deviation']}"
    assert fields["b_mean_dz_m"] < 0.0 and fields["box_dz_m"] < 0.0, \
        "phase 23: B or the box did not move down"
    # every label's frames, each read back finite; the last one holds the
    # simulation's positions
    files = sorted(f for f in os.listdir(FRAMES_DIR) if f.endswith(".vtk"))
    assert frames == n_expected and len(files) == len(ATTACH_LABELS) * frames, \
        f"phase 23: {len(files)} frame files, {frames} frames, {n_expected} expected"
    for label in ATTACH_LABELS:
        for i in range(frames):
            V, C = read_vtk(os.path.join(FRAMES_DIR, f"attachments_{label}_{i}.vtk"))
            assert np.all(np.isfinite(V)) and len(C) > 0, f"phase 23: frame {label} {i}"
        if label == "box":
            R1, t1 = sim._rb_dyn.R1[h.box.rigidbody.get_idx()], sim._rb_dyn.t1[
                h.box.rigidbody.get_idx()]
            want = h.box.vertices @ R1.T + t1
        else:
            want = x[sets[label]]
        assert np.array_equal(V, np.asarray(want, dtype=np.float64)), \
            f"phase 23: the last {label} frame is not the simulation's positions"
    assert_launched(launches, ("segment_reduce[egh]", "segment_reduce[diag]",
                               "segment_reduce[dense]", "hvp_bucket", "pd_project",
                               "block3_inverse", "block3_apply") + K12_KERNELS, "phase 23")
    assert_egh_path(sim, launches, ATTACH_SCENE_FAMILIES + with_rows, "phase 23")
    out["fields"]["phase23"], out["launches"]["phase23"] = fields, launches

    print("-- phase 17 (phase 23's state)", flush=True)
    torch.set_num_threads(4)     # the twins' CPU runs
    out["egh"]["phase23"] = egh_checks(sim, ATTACH_SCENE_FAMILIES + with_rows, "phase 23", 24)
    if go_file:
        t_wait = time.perf_counter()
        while not os.path.exists(go_file):
            assert time.perf_counter() - t_wait < 1200, "no go from the main process"
            time.sleep(0.5)
        print(f"waited {time.perf_counter() - t_wait:.1f}s for the card", flush=True)
    print("-- phase 17 (times)", flush=True)
    out["times"] = {"phase23": egh_timings(sim, with_rows, 24, launches)}
    out["k12"] = k12_window(sim, K12_SOLVES, "phase 23", profiled=True)
    out["seconds"] = time.perf_counter() - t0
    with open(out_json, "w") as f:
        json.dump(out, f)
    return 0


# ---------------------------------------------------------------------------
# on demand, not part of the smoke: `chip_smoke.py --witness` (writes
# chiprun_out/witness/)
# ---------------------------------------------------------------------------
WITNESS_DIR = os.path.join(ROOT, "chiprun_out", "witness")


def _row_distances(fam, u, conn, rows, glob):
    """Per row of a contact family, the distance d its energy reads (the
    barrier and the edge-edge mollifier swapped for d and 1)."""
    from torch.func import vmap

    from stark_tpu_torch.collision import narrow_phase as nph
    from stark_tpu_torch.models.interactions import contact_energies as ce

    saved = ce.barrier, nph.edge_edge_mollifier
    ce.barrier = lambda d, dhat, k, barrier_type, active: d
    nph.edge_edge_mollifier = lambda *a: torch.ones((), dtype=u.dtype, device=u.device)
    try:
        return vmap(fam.energy_fn, in_dims=(0, 0, None))(u[conn], rows, glob)
    finally:
        ce.barrier, nph.edge_edge_mollifier = saved


def _rel_rows(out, ref):
    """Per row, max |out - ref| over the row's largest |ref| (inf where the
    reference row is zero and the output is not)."""
    n = out.shape[0]
    o, r = out.double().reshape(n, -1), ref.double().reshape(n, -1).to(out.device)
    s, e = r.abs().amax(dim=1), (o - r).abs().amax(dim=1)
    return torch.where(s > 0, e / s.clamp_min(1e-300),
                       torch.where(e > 0, torch.full_like(e, float("inf")),
                                   torch.zeros_like(e)))


def witness_contact_rows(sim, names, seed: int) -> dict:
    """At a scene's state (egh_state's tables and iterate), per contact
    family: each live row's gap dhat - d (float64), its kernel-against-twin
    distances in float64 and float32, and the float64 twin's move under
    input rounding at float32 and float64 precision (f64_spread); logs the
    rows that sit closest to dhat and those farthest from their twin, and
    saves the tables and outputs."""
    from stark_tpu_torch.ops import egh
    from stark_tpu_torch.tools.egh_cases import f64_spread

    ev, data, glob, u, _topo = egh_state(sim, seed)
    eps32 = torch.finfo(torch.float32).eps
    dump, out = {"u": u.cpu(), "glob": {k: v.cpu() for k, v in glob.items()}}, {}
    for name in names:
        if name not in data:
            continue
        fam, conn, rows = ev.fam_by_name[name], data[name]["conn"], data[name]["rows"]
        u64, rows64, glob64 = u.double(), _cast(rows, torch.float64), _cast(glob, torch.float64)
        u32, rows32, glob32 = u.float(), _cast(rows, torch.float32), _cast(glob, torch.float32)
        k64, t64 = fam.kernel(u64, conn, rows64, glob64, True), egh.plain(
            fam.energy_fn, u64, conn, rows64, glob64)
        k32, t32 = fam.kernel(u32, conn, rows32, glob32, True), egh.plain(
            fam.energy_fn, u32, conn, rows32, glob32)
        gap = rows64["dhat"] - _row_distances(fam, u64, conn, rows64, glob64)
        sp32 = f64_spread(fam.energy_fn, u64, conn, rows64, glob64)
        sp64 = f64_spread(fam.energy_fn, u64, conn, rows64, glob64,
                          eps=torch.finfo(torch.float64).eps)
        live = torch.nonzero(rows["active"] > 0.5).flatten()
        n = conn.shape[0]
        H64s = t64[2].reshape(n, -1).abs().amax(dim=1)
        err64 = torch.maximum(_rel_rows(k64[1], t64[1]), _rel_rows(k64[2], t64[2]))
        abs64 = (k64[2] - t64[2]).reshape(n, -1).abs().amax(dim=1)
        d32 = (k32[2].double() - t32[2].double()).reshape(n, -1).abs().amax(dim=1)
        d3264 = (k32[2].double() - t64[2]).reshape(n, -1).abs().amax(dim=1)
        tol32 = 64.0 * eps32 * t32[2].double().reshape(n, -1).abs().amax(dim=1)
        ratio32 = d32 / (tol32 + torch.finfo(torch.float32).tiny)
        rows_out = []

        def row(i, why):
            r = {"row": int(i), "why": why, "gap": float(gap[i]), "H64_max": float(H64s[i]),
                 "f64_rel": float(err64[i]), "f64_abs_H": float(abs64[i]),
                 "f64_spread_eps64_H": float(sp64[2][i]),
                 "f32_H_kernel_max": float(k32[2][i].abs().max()),
                 "f32_H_twin32_max": float(t32[2][i].abs().max()),
                 "f32_kernel_vs_twin32": float(d32[i]), "f32_kernel_vs_twin64": float(d3264[i]),
                 "f32_ratio_64eps": float(ratio32[i]),
                 "f64_spread_eps32_H": float(sp32[2][i])}
            rows_out.append(r)
            log("    " + json.dumps(r))

        g_live = gap[live]
        log(f"  {name}: {n} rows, {live.numel()} live; gap (dhat - d, m) min "
            f"{float(g_live.min()) if live.numel() else 0:.3e} max "
            f"{float(g_live.max()) if live.numel() else 0:.3e}; live rows with |gap| < "
            f"1e-6: {int((g_live.abs() < 1e-6).sum())}, < 1e-5: "
            f"{int((g_live.abs() < 1e-5).sum())}")
        for i in live[torch.argsort(err64[live], descending=True)[:4]]:
            row(i, "largest f64 error")
        for i in live[torch.argsort(ratio32[live], descending=True)[:4]]:
            row(i, "largest f32 error")
        for i in live[torch.argsort(g_live.abs())[:4]]:
            row(i, "closest to dhat")
        out[name] = {"rows": n, "live": int(live.numel()), "gaps_live": g_live.tolist(),
                     "examined": rows_out}
        dump[name] = {"conn": conn.cpu(), "rows": {k: v.cpu() for k, v in rows.items()},
                      "k64": [t.cpu() for t in k64], "t64": [t.cpu() for t in t64],
                      "k32": [t.cpu() for t in k32], "t32": [t.cpu() for t in t32]}
    torch.save(dump, os.path.join(WITNESS_DIR, f"rows_seed{seed}.pt"))
    return out


def witness_scene(make, seconds: float, label: str, twins=(), sweeps=None,
                  moved: bool = False) -> dict:
    """One run of a scene (make() -> (sim, point set handler, event or
    None)) for `seconds`: with the families of `twins` on their torch.func
    twins, kernel C's Jacobi at `sweeps`, and, if `moved`, the handler's
    start positions moved by one float32 ulp each (random signs); Newton
    iterations per step and the run's fields."""
    from stark_tpu_torch.ops import build

    sim, ps, event = make()
    if event is not None:
        sim.add_time_event(0.0, 10.0, event)
    if sweeps is not None:
        sim.stark.settings.device.jacobi_sweeps = sweeps
    for fam in sim.stark.global_potential.families:
        if fam.name in twins:
            fam.kernel = None
    if moved:
        dyn = ps._dyn
        b, e = dyn.intervals[ps.idx]
        x = dyn._x0_host[b:e]
        sign = np.random.default_rng(0).choice([-1.0, 1.0], x.shape)
        dyn._x0_host[b:e] = x + sign * np.spacing(np.abs(x).astype(np.float32))
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert sim.run(duration=seconds - 1e-9), f"{label}: the run failed"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lg = sim.get_logger()
    newton = [int(v) for v in lg.series["newton_iterations"]]
    r = {"label": label, "newton_per_step": newton, "newton": sum(newton),
         "cg_per_step": [int(v) for v in lg.series["cg_iterations"]],
         "solver_codes": [int(c) for c in lg.series["solver_code"]],
         "cg_per_newton": int(lg.get_stats("cg_iterations").total) / max(sum(newton), 1),
         "ms_per_newton": 1e3 * wall / max(sum(newton), 1), "wall_s": wall,
         "func_on_card": dict(build.func_on_card)}
    log(f"  {label}: " + json.dumps(r))
    return r, sim


def witness_run() -> int:
    """`chip_smoke.py --witness`: (1) phase 19's scene and, at its end
    state, the floor's contact rows (witness_contact_rows); (2) phases 18
    and 19 with kernel C's Jacobi at the card's default 8 sweeps and at
    16; (3) phase 10's friction box with kernel Q, with Q's families on
    their torch.func twins, and with kernel Q from a start moved by one
    float32 ulp. Writes chiprun_out/witness/witness.json."""
    from stark_tpu_torch.tools.scenes import (deformable_and_rigid_collisions,
                                              hanging_box_with_composite_material)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(WITNESS_DIR, exist_ok=True)
    log(card_line())
    out = {"card": card_line()}
    boxes = lambda: (lambda s, h: (s, h[0].point_set, None))(
        *deformable_and_rigid_collisions("float32", DEVICE))
    composite = lambda: (lambda s, n: (s, n, None))(
        *hanging_box_with_composite_material("float32", DEVICE))
    friction_box = lambda: (lambda s, c, spin: (s, c.point_set, spin))(
        *make_spinning_box(N_SBC, "float32", mu=FRICTION_MU))
    log("-- the soft boxes (phase 19), then their contact rows")
    r19, sim19 = witness_scene(boxes, COLLISIONS_SECONDS, "phase 19, 8 sweeps")
    out["rows"] = witness_contact_rows(
        sim19, ("contact_pt_dr", "contact_ee_dr", "contact_pt_dd", "contact_ee_dd"), 19)
    log("-- kernel C's sweeps (phases 18, 19)")
    out["sweeps"] = [r19, witness_scene(boxes, COLLISIONS_SECONDS, "phase 19, 16 sweeps",
                                        sweeps=16)[0],
                     witness_scene(composite, COMPOSITE_SECONDS, "phase 18, 8 sweeps")[0],
                     witness_scene(composite, COMPOSITE_SECONDS, "phase 18, 16 sweeps",
                                   sweeps=16)[0]]
    log("-- the friction box (phase 10): kernel Q, Q's twins, a moved start")
    out["friction_box"] = [
        witness_scene(friction_box, FRICTION_SECONDS, "kernel Q")[0],
        witness_scene(friction_box, FRICTION_SECONDS, "Q's twins",
                      twins=BOX_FRICTION_FAMILIES)[0],
        witness_scene(friction_box, FRICTION_SECONDS, "kernel Q, start moved one ulp",
                      moved=True)[0]]
    with open(os.path.join(WITNESS_DIR, "witness.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps({"ok": True}))
    return 0


def witness_b_run() -> int:
    """`chip_smoke.py --witness-b`: phase 7's scene (the N_SBC spinning box,
    float32, SBC_SECONDS) three times: with kernel B, with kernel B from a
    start moved by one float32 ulp, and with B's twin on the card
    (`hvp_groups_plain`, whose index_add_ adds with atomics, in no fixed
    order) in place of the kernel; Newton and CG iterations per step of
    each. Writes chiprun_out/witness/witness_b.json."""
    from stark_tpu_torch.ops import hvp_bucket as hb
    from stark_tpu_torch.solver import assembly

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(WITNESS_DIR, exist_ok=True)
    log(card_line())
    box = lambda: (lambda s, c, spin: (s, c.point_set, spin))(
        *make_spinning_box(N_SBC, "float32"))
    out = {"card": card_line(), "runs": [
        witness_scene(box, SBC_SECONDS, "phase 7, kernel B")[0],
        witness_scene(box, SBC_SECONDS, "phase 7, kernel B, start moved one ulp",
                      moved=True)[0]]}
    kernel = assembly._hvp_kernel
    assembly._hvp_kernel = lambda p, groups, site=None: hb.hvp_groups_plain(p, groups)
    try:
        out["runs"].append(witness_scene(box, SBC_SECONDS, "phase 7, B's twin on the card")[0])
    finally:
        assembly._hvp_kernel = kernel
    with open(os.path.join(WITNESS_DIR, "witness_b.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps({"ok": True}))
    return 0


def et_ball_containment(eng, Vs, Vr, slack):
    """ROADMAP Queue 3 item 2 at the scale point's state: kernel F's oracle
    ball pairs (w_et) from the card's torch glue (balls, radii, pad) against
    those the CPU glue gives from the same state. Logs both differences
    under JAX's pad (8 sqrt(eps) scale), and asserts that the card's list
    under the port's pad (BOUND_PAD_ULPS more) contains the CPU's under
    JAX's: K2's contract that F's list contains JAX's."""
    from stark_tpu_torch.ops import ball_wide as bw

    Vcat = eng._vcat(Vs, Vr)
    eps = torch.finfo(Vcat.dtype).eps
    cap = 4 * eng._cap("w_et")
    Nt = eng.d_tris_all.shape[0]

    def pairs(device, pad_of):
        V = Vcat.to(device)
        m, h = eng._balls_of_edges(V, eng.d_edges_all.to(device))
        c, r = eng._balls_of_tris(V, eng.d_tris_all.to(device))
        fn = bw.ball_wide if device == DEVICE else bw.ball_wide_plain
        extra = torch.as_tensor(slack).to(device) + pad_of(V)
        q, t, cnt = fn(m, h, c, r, eng.d_et_allowed.to(device), extra, cap)
        n = int(cnt)
        assert n <= cap
        return set((q[:n].long() * Nt + t[:n].long()).cpu().tolist())

    def jax_pad(V):
        return 8.0 * float(np.sqrt(eps)) * (1.0 + torch.max(torch.abs(V)))

    card_jax, cpu_jax = pairs(DEVICE, jax_pad), pairs("cpu", jax_pad)
    card_port = pairs(DEVICE, eng._bound_pad)
    out = {"w_et_card_jax_pad": len(card_jax), "w_et_cpu_jax_pad": len(cpu_jax),
           "card_only": len(card_jax - cpu_jax), "cpu_only": len(cpu_jax - card_jax),
           "w_et_card_port_pad": len(card_port),
           "cpu_missing_from_card_port_pad": len(cpu_jax - card_port)}
    log("  w_et (oracle ball pairs) card vs CPU glue: " + json.dumps(out))
    assert cpu_jax <= card_port, "the card's ball list misses a pair of the CPU's"
    return out


# ---------------------------------------------------------------------------
# phase 17: kernels M-S (element energies, gradients, Hessians) against
# their twins
# ---------------------------------------------------------------------------
# the families of the main path: bench.py's spinning box (12) and the
# hanging cloth's prescribed positions
CLOTH_FAMILIES = ("EnergyLumpedInertia", "EnergyTriangleStrain", "EnergyBendingFlat",
                  "EnergyPrescribedPositions")
BOX_FAMILIES = ("EnergyLumpedInertia", "EnergyTriangleStrain", "EnergyBendingFlat",
                "EnergyRigidBodyInertia_Linear", "EnergyRigidBodyInertia_Angular",
                "rb_constraint_global_points", "rb_constraint_global_directions",
                "contact_pt_dd", "contact_pt_dr", "contact_pt_rd", "contact_ee_dd",
                "contact_ee_dr")
# the kernel families no scene of the smoke runs, and kernel Q under both
# friction types (the scenes run C0): seeded tables (tools/egh_cases.py)
OFF_PATH_FAMILIES = ("EnergyTriangleStrain_ElasticityOnly", "contact_pt_rr",
                     "contact_ee_rr", "EnergySegmentStrain_ElasticityOnly",
                     "EnergyTetStrain_ElasticityOnly", "friction_pt_dd", "friction_pt_dr",
                     "friction_pt_rd", "friction_pt_rr", "friction_ee_dd", "friction_ee_dr",
                     "friction_ee_rr", "EnergyAttachments_d_d_p_p",
                     "EnergyAttachments_d_d_e_e")
# the families timed on seeded tables because no scene of the smoke runs
# them (phase 23's W families without rows are added where they have none)
SEEDED_TIMED = ("EnergyTriangleStrain_ElasticityOnly", "EnergySegmentStrain_ElasticityOnly",
                "EnergyTetStrain_ElasticityOnly", "contact_pt_rr", "contact_ee_rr",
                "friction_pt_rr", "friction_ee_rr", "EnergyAttachments_d_d_p_p",
                "EnergyAttachments_d_d_e_e")
_ENERGIES = "stark_tpu/models/deformables/energies.py:"
_CONTACT = "stark_tpu/models/interactions/contact_energies.py:"
_JOINTS = "stark_tpu/models/rigidbodies/constraints.py:"
EGH_REPLACES = {
    "EnergyTriangleStrain": _ENERGIES + "468",
    "EnergyLumpedInertia": _ENERGIES + "88",
    "EnergyPrescribedPositions": _ENERGIES + "214",
    "EnergyBendingFlat": _ENERGIES + "596",
    "EnergyRigidBodyInertia_Linear": "stark_tpu/models/rigidbodies/inertia.py:43",
    "EnergyRigidBodyInertia_Angular": "stark_tpu/models/rigidbodies/inertia.py:57",
    "rb_constraint_global_points": "stark_tpu/models/rigidbodies/constraints.py:216",
    "rb_constraint_global_directions": "stark_tpu/models/rigidbodies/constraints.py:224",
    "contact_pt_dd": _CONTACT + "161", "contact_pt_dr": _CONTACT + "165",
    "contact_pt_rd": _CONTACT + "170", "contact_ee_dd": _CONTACT + "180",
    "contact_ee_dr": _CONTACT + "186",
    "EnergySegmentStrain": _ENERGIES + "349", "EnergyTetStrain": _ENERGIES + "733",
    "friction_pt_dd": _CONTACT + "208", "friction_pt_dr": _CONTACT + "213",
    "friction_pt_rd": _CONTACT + "218", "friction_pt_rr": _CONTACT + "223",
    "friction_ee_dd": _CONTACT + "228", "friction_ee_dr": _CONTACT + "233",
    "friction_ee_rr": _CONTACT + "239",
    "rb_constraint_points": _JOINTS + "231", "rb_constraint_point_on_axis": _JOINTS + "240",
    "rb_constraint_distances": _JOINTS + "253",
    "rb_constraint_distance_limits": _JOINTS + "262",
    "rb_constraint_directions": _JOINTS + "274", "rb_constraint_angle_limits": _JOINTS + "283",
    "rb_constraint_damped_spring": _JOINTS + "294",
    "rb_constraint_linear_velocity": _JOINTS + "310",
    "rb_constraint_angular_velocity": _JOINTS + "318",
    "EnergyDiscreteShells": _ENERGIES + "581",
    "EnergyTriangleStrain_ElasticityOnly": _ENERGIES + "485",
    "EnergySegmentStrain_ElasticityOnly": _ENERGIES + "360",
    "EnergyTetStrain_ElasticityOnly": _ENERGIES + "757",
    "contact_pt_rr": _CONTACT + "175", "contact_ee_rr": _CONTACT + "195",
}
_ATTACH = "stark_tpu/models/interactions/attachments.py:"
EGH_REPLACES.update({
    "EnergyAttachments_d_d_p_p": _ATTACH + "89", "EnergyAttachments_d_d_p_e": _ATTACH + "94",
    "EnergyAttachments_d_d_p_t": _ATTACH + "100", "EnergyAttachments_d_d_e_e": _ATTACH + "106",
    "EnergyAttachments_rb_d": _ATTACH + "113"})


def func_launches():
    """The evaluations on CUDA tensors that went through torch.func, by
    family, beside the kernel counts of a run."""
    from stark_tpu_torch.ops import build

    return {f"torch_func[{k}]": v for k, v in build.func_on_card.items()}


def assert_egh_path(sim, launches, names, where: str, optional=()):
    """Every family named launched its kernel (e, g, H and the value-only
    form) in the run, and no family ran torch.func on the card. A family in
    `optional` may have had no rows in the run (the staged solve reads the
    live contact rows only; a scene may have no pair of a stem), but then
    none of `optional` may be missing together."""
    fams = {f.name: f for f in sim.stark.global_potential.families}
    empty = []
    for n in names:
        site = fams[n].kernel.site
        assert launches.get(f"torch_func[{n}]", 0) == 0, \
            f"{n} ran torch.func on the card on {where}"
        if n in optional and launches.get(site, 0) == 0:
            empty.append(n)
            continue
        for s in (site, site[:-1] + ":e]"):
            assert launches.get(s, 0) > 0, f"{s} never launched on {where}"
    assert not optional or len(empty) < len(optional), f"no contact rows on {where}"
    on_card = {k: v for k, v in launches.items() if k.startswith("torch_func[")}
    assert not on_card, f"torch.func ran on the card on {where}: {on_card}"
    log(f"  {where}: every kernel family launched{' but ' + str(empty) + ' (no rows)' if empty else ''}; "
        f"torch.func on the card: none")


def egh_state(sim, seed: int):
    """The tables one energy evaluation of the solve sees at the current
    state (the static tables, the contact tables the pair shell builds
    there and, with friction, the lagged tables of a step starting there)
    and a seeded random iterate u ~ N(0, 0.01) m/s: (evaluators, data,
    glob, u, static topology)."""
    nm = sim.stark.newton
    ev = nm._ev
    static = sim._get_static_data()
    data = dict(static)
    eng = sim.interactions.contact.engine()
    if eng is not None:
        eng, _nm, _u0, Vs, Vr = contact_state(sim)
        f = lambda x: torch.as_tensor(x, dtype=sim.stark.dtype, device=DEVICE)
        th = eng.th_vec()
        mc, _ic, _c = eng.broad_fn(Vs, Vr, th, f(0.016), f(0.002))
        tables, _c = eng.pairs_fn(Vs, Vr, th, mc, f(0.002))
        data.update(tables)
        if eng.friction_enabled_now():
            # the lagged tables of a step starting here (the fused solve's)
            eglob = eng.glob_entries()
            Vs0, Vr0 = eng.step_start_world(eng.engine_state())
            fric, _c = eng.friction_tables(Vs0, Vr0, th, eglob["mu_mat"], eglob["contact_k"])
            data.update(fric)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(0.0, 0.01, (nm.n_blocks, 3)), dtype=sim.stark.dtype,
                        device=DEVICE)
    return ev, data, sim._get_glob(), u, ev.topology(static, dense=False)


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return x.to(dtype) if x.is_floating_point() else x


def _f64_err(out, ref, part) -> float:
    from stark_tpu_torch.tools.egh_cases import f64_err

    return f64_err(out.cpu().numpy(), ref.cpu().numpy(), part)


# the family whose twin cannot be reproduced to 1e-10 in float64 at a
# physical state: full DiscreteShells near flat edges (tools/egh_cases.
# f64_ratio); every other family is held to 1e-10 on every row
F64_FLOOR_FAMILIES = ("EnergyDiscreteShells",)


def hold_egh(fam, u, conn, rows, glob, what: str) -> dict:
    """One family's kernel against its twin on the card: f64 within 1e-10
    by tools/egh_cases.f64_err (g and H: of each element's largest entry;
    for F64_FLOOR_FAMILIES, rows whose twin moves farther under float64
    rounding of the positions within twice that move, tools/egh_cases.
    f64_ratio, counted), f32 within tools/egh_cases.f32_ratio (element by
    element; the rows held to the float32 floor are counted), the
    value-only e bit for bit the derivative form's in both."""
    from stark_tpu_torch.ops import egh
    from stark_tpu_torch.tools.egh_cases import (dihedral_spread, f32_ratio, f64_ratio,
                                                 f64_spread)

    u64, rows64, glob64 = u.double(), _cast(rows, torch.float64), _cast(glob, torch.float64)
    k64 = fam.kernel(u64, conn, rows64, glob64, True)
    v64 = fam.kernel(u64, conn, rows64, glob64, False)
    t64 = egh.plain(fam.energy_fn, u64, conn, rows64, glob64)
    spread = f64_spread(fam.energy_fn, u64, conn, rows64, glob64)
    u32, rows32, glob32 = u.float(), _cast(rows, torch.float32), _cast(glob, torch.float32)
    k32 = fam.kernel(u32, conn, rows32, glob32, True)
    v32 = fam.kernel(u32, conn, rows32, glob32, False)
    t32 = egh.plain(fam.energy_fn, u32, conn, rows32, glob32)
    torch.cuda.synchronize()
    assert torch.equal(v64, k64[0]) and torch.equal(v32, k32[0]), \
        f"{fam.name} ({what}): the value-only e is not the egh e bit for bit"
    err64 = max(_f64_err(k, t, part) for part, k, t in zip("egH", k64, t64))
    ratio64, wide64, floor64 = err64 / 1e-10, (0, 0, 0), ""
    if err64 > 1e-10 and fam.name in F64_FLOOR_FAMILIES:
        # how far two evaluations of the f64 twin lie apart: under f64
        # rounding of the positions, under 4 ulps of the dihedral angles'
        # cosines, and on the CPU against the card
        spread64 = f64_spread(fam.energy_fn, u64, conn, rows64, glob64, draws=8,
                              eps=float(torch.finfo(torch.float64).eps))
        c64 = dihedral_spread(fam.energy_fn, u64, conn, rows64, glob64)
        on_cpu = egh.plain(fam.energy_fn, u64.cpu(), conn.cpu(),
                           {k: v.cpu() for k, v in rows64.items()},
                           {k: v.cpu() for k, v in glob64.items()})
        parts64, wide64, floors = [], [], []
        for part, k, t, a, b, c in zip("egH", k64, t64, spread64, c64, on_cpu):
            n = t.shape[0]
            apart = (t.cpu() - c).reshape(n, -1).abs().amax(dim=1).double()
            floor = torch.maximum(torch.maximum(a.cpu(), b.cpu()), apart)
            r, w = f64_ratio(k.cpu(), t.cpu(), part, floor)
            parts64.append(r)
            wide64.append(w)
            scale = t.cpu().reshape(n, -1).abs().amax(dim=1).double()
            rel = lambda x: float((x / torch.where(scale > 0, scale, 1.0)).max())
            floors.append(f"{part} {r:.2f} (spread {rel(a.cpu()):.1e} c {rel(b.cpu()):.1e} "
                          f"cpu {rel(apart):.1e})")
        ratio64 = max(parts64)
        floor64 = " [f64 floor: " + "; ".join(floors) + "]"
    parts32, wide = zip(*[f32_ratio(k, t, r, part, s)
                          for part, k, t, r, s in zip("egH", k32, t32, t64, spread)])
    ratio32 = max(parts32)
    abs32 = max(float((k.double() - t.double()).abs().max()) if k.numel() else 0.0
                for k, t in zip(k32, t32))
    rows_n, live = conn.shape[0], int((rows["active"] > 0.5).sum())
    ok = ratio64 <= 1.0 and ratio32 <= 1.0
    if floor64:
        floor64 = f" (err/tol {ratio64:.3f}, rows by the f64 floor e {wide64[0]} g " \
            f"{wide64[1]} H {wide64[2]}){floor64}"
    log(f"  {fam.kernel.site:<36} {what:<9} rows={rows_n:<6} live={live:<6} "
        f"f64 rel err={err64:.2e}{floor64}  f32 err/tol={ratio32:.3f} "
        f"(e {parts32[0]:.2f} g {parts32[1]:.2f} H {parts32[2]:.2f}; rows by the "
        f"floor e {wide[0]} g {wide[1]} H {wide[2]})  {'ok' if ok else 'FAIL'}")
    return {"rows": rows_n, "live_rows": live, "f64_rel_err": err64,
            "f64_err_over_tol": ratio64, "f64_rows_by_floor": list(wide64),
            "f64_floor": floor64,
            "f32_err_over_tol": ratio32, "f32_rows_by_floor": list(wide),
            "max_abs_err": abs32, "ok": ok}


def egh_checks(sim, names, what: str, seed: int) -> dict:
    """Phase 17's checks at a scene's state: each family of `names`
    (float32 state, cast to float64) against its twin, and the whole
    energy_grad_hess E bit for bit energy()'s E in both dtypes."""
    ev, data, glob, u, topo = egh_state(sim, seed)
    out = {}
    for name in names:
        if name not in data:
            continue      # a stem with no table at this state
        fd = data[name]
        out[name] = hold_egh(ev.fam_by_name[name], u, fd["conn"], fd["rows"], glob, what)
    bad = [n for n, r in out.items() if not r["ok"]]
    assert not bad, f"{what}: {bad} disagree with their twins"
    for dtype in (torch.float32, torch.float64):
        d, g, uu = _cast(data, dtype), _cast(glob, dtype), u.to(dtype)
        E_egh = ev.energy_grad_hess(uu, d, g, topo, ev.egh_csr(d))[0]
        E_en = ev.energy(uu, d, g)
        assert torch.equal(E_egh, E_en), f"{what} {dtype}: egh's E {float(E_egh)!r} " \
            f"is not energy()'s {float(E_en)!r}"
        log(f"  {what} {str(dtype):<13} egh E == energy() E bit for bit: {float(E_en)!r}")
    return out


def off_path_checks() -> dict:
    """The kernel families no scene of the smoke runs, on seeded tables
    (tools/egh_cases.py, both barriers for the contact ones, both friction
    types for the friction ones)."""
    from stark_tpu_torch.tools import egh_cases as ec

    out = {}
    for name in OFF_PATH_FAMILIES:
        modes = (("Cubic", "Log") if name.startswith("contact_") else
                 ("C0", "C1") if name.startswith("friction_") else ("Cubic",))
        for mode in modes:
            case = ec.make_case(name, sum(map(ord, name + mode)))
            glob, u, conn, rows = ec.to_torch(*case, device=DEVICE)
            fam = ec.port_families(*(("Cubic", mode) if mode in ("C0", "C1")
                                     else (mode,)))[name]
            out[f"{name}[{mode}]"] = hold_egh(fam, u, conn, rows, glob, "seeded")
    bad = [n for n, r in out.items() if not r["ok"]]
    assert not bad, f"seeded tables: {bad} disagree with their twins"
    return out


# the operations one live row of a family needs, counted from the energy's
# formula (csrc/egh_*.cu, the port's energies): (the energy's value, the
# distinct values of its Hessian where they are fewer than d(d+1)/2: c I3
# blocks, the 4x4 Bergou product, a symmetric 3x3). A rigid point adds its
# rotation (~69: the quaternion step, its normalisation, R) and ~18 per
# local point; a soft point its x0 + dt u (6). To these the bound adds one
# multiply-add per gradient entry and per distinct Hessian value, the least
# any form of e, g and H must do: a lower count than any kernel's.
EGH_OPS = {
    "lumped": (56, 1), "prescribed": (16, 1), "shells_flat": (53, 10),
    "rb_linear": (35, 1), "rb_angular": (73, 6),
    "global_points": (103, None), "global_directions": (94, None),
    # F, C = F^T F, log J, the Neo-Hookean terms, the strain rate against
    # F0, the 2x2 eigenvalues and cubic limit, inflation
    "strain": (180, None), "strain_eo": (104, None),
    # 4 points, the region test (~40), the region's distance (~17), the
    # barrier (~8); EE adds the mollifier (~34)
    "pt_dd": (98, None), "pt_dr": (209, None), "pt_rd": (185, None),
    "pt_rr": (296, None), "ee_dd": (132, None), "ee_dr": (231, None),
    "ee_rr": (330, None),
    # R: x1 and d (15), |d| (6), the stretch (~10), the cubic limit (~7),
    # the rate against x0's strain (~17); H is [[A, -A], [-A, A]], A a
    # symmetric 3x3
    "segment": (55, 6), "segment_eo": (31, 6),
    # S: x1 (24), Dx and F = Dx DXinv (54), det (17), Ic (17), the Stable
    # Neo-Hookean terms (~21); full adds F0 (54), F^T F twice (90), the
    # Green strains and their rate (54), the deviator's norm and the
    # limit (~32)
    "tet": (363, None), "tet_eo": (133, None),
    # Q: the sides' velocities (soft: weights ~15; rigid: the rotation 69
    # and ~27 per local point for v + w x R loc), vb - va (3), ut = T v dt
    # + pert (14), |ut| (4) and the potential (~6)
    "friction_pt_dd": (42, None), "friction_pt_dr": (192, None),
    "friction_pt_rd": (138, None), "friction_pt_rr": (288, None),
    "friction_ee_dd": (45, None), "friction_ee_dr": (168, None),
    "friction_ee_rr": (291, None),
    # T: two rigid points (2 x 87), b1 - a1 (3) and the energy: |d|^2 (6),
    # point on axis with side a's axis (15), the cross and quotient (~25);
    # the norm (6) and the quadratic (~4), the limits' compares (~8); the
    # spring's x0 points (2 x ~45) and the damper (~6)
    "points": (183, None), "point_on_axis": (214, None), "distances": (187, None),
    "distance_limits": (191, None), "damped_spring": (283, None),
    # U: two rotated directions (2 x 84) and |db - da|^2 (8), the cube of
    # the limit (~10); one direction (84), the velocity difference and dot
    # (8) and the controller (~6)
    "directions": (176, None), "angle_limits": (186, None),
    "linear_velocity": (98, None), "angular_velocity": (98, None),
    # V: x1 (24), the edges (9), two crosses (18), two normalisations (18),
    # the dot and acos (~12), the same at x0 (~80) and the energy (~12)
    "shells": (173, None),
    # W: x1 of each soft point (6), the weighted sums (3 per weight), d (3),
    # d.d (5) and the energy (2); H is (w w^T) x I3, arity(arity + 1) / 2
    # distinct values; the rigid point adds the rotation and local point (87)
    "att_pp": (22, 3), "att_pe": (37, 6), "att_pt": (49, 10), "att_ee": (52, 10),
    "att_rbd": (103, None),
}


def egh_bound(fam, u, conn, rows, glob, outs) -> tuple:
    """(bytes, operations) the derivative form of a family's kernel must
    move and do on these rows: e, g and H written once for every row and
    `active` read once; on the live rows only, the row tables the entry
    reads (its `spec`) and conn read once each, the distinct DOF blocks of u
    they touch read once, and of each global the rows of those blocks (all
    of a global of at most 16 values); EGH_OPS's count per live row."""
    live = rows["active"] > 0.5
    n_live = int(live.sum())
    el = u.element_size()
    a = conn.shape[1]
    d = 3 * a
    blocks = int(torch.unique(conn[live]).numel())
    row_bytes = lambda t: (t[0].numel() if t.dim() else 1) * (
        el if t.is_floating_point() else 8)
    b = nbytes(*outs) + conn.shape[0] * el + n_live * 8 * a + blocks * 3 * el
    for spec in fam.kernel.spec:
        if spec is None:
            continue
        src, key = spec
        if src == "r":
            b += n_live * row_bytes(rows[key])
        elif key in glob:
            t = glob[key]
            b += t.numel() * el if t.numel() <= 16 else min(t.shape[0], blocks) * row_bytes(t)
    v_ops, h = EGH_OPS[fam.kernel.family]
    h = d * (d + 1) // 2 if h is None else h
    return b, n_live * (v_ops + 2 * d + 2 * h)


def time_family(fam, u, conn, rows, glob, launches: dict, where: str = "") -> dict:
    """One family's kernel (e, g, H and value-only forms; 20 launches in a
    CUDA graph, replayed 5 times) against its torch.func twin (host
    launches), with the bound from these rows and the path's launches."""
    from stark_tpu_torch.ops import egh

    e, g, H = fam.kernel(u, conn, rows, glob, True)
    E = conn.shape[0]
    n_bytes, flops = egh_bound(fam, u, conn, rows, glob, (e, g, H))
    bnd = bound_ms(n_bytes, flops, u.dtype)
    site = fam.kernel.site
    r = dict(
        site=site, launches=launches.get(site, 0),
        launches_e=launches.get(site[:-1] + ":e]", 0),
        ms=graph_ms(lambda: fam.kernel(u, conn, rows, glob, True)),
        ms_e=graph_ms(lambda: fam.kernel(u, conn, rows, glob, False)),
        plain_ms=events_ms(lambda: egh.plain(fam.energy_fn, u, conn, rows, glob),
                           iters=5, warmup=2),
        plain_ms_e=events_ms(lambda: egh.plain(fam.energy_fn, u, conn, rows, glob,
                                               False), iters=5, warmup=2),
        bound_ms=bnd[0], bound_by=bnd[1], flops=flops, bytes=n_bytes,
        shape=f"{where}{E} rows ({int((rows['active'] > 0.5).sum())} live), "
              f"H {tuple(H.shape)}")
    log(f"  {site:<36} {r['ms']:.4f} ms (e only {r['ms_e']:.4f}) twin "
        f"{r['plain_ms']:.3f} ms (e only {r['plain_ms_e']:.3f}); bound "
        f"{r['bound_ms']:.2e} ms ({r['bound_by']}); {r['shape']}")
    return r


def egh_timings(sim, names, seed: int, launches: dict) -> dict:
    """Phase 17's times at a scene's state, on the idle card (float32): per
    family the kernel (e, g, H and value-only forms; 20 launches in a CUDA
    graph, replayed 5 times) against its torch.func twin (host launches),
    the bound from this run's rows, and the whole energy_grad_hess and
    energy() with the kernels and with the twins."""
    ev, data, glob, u, topo = egh_state(sim, seed)
    csr = ev.egh_csr(data)
    out = {}
    for name in names:
        if name in data:
            out[name] = time_family(ev.fam_by_name[name], u, data[name]["conn"],
                                    data[name]["rows"], glob, launches)
    whole = {"egh_ms": events_ms(lambda: ev.energy_grad_hess(u, data, glob, topo, csr),
                                 iters=10),
             "energy_ms": events_ms(lambda: ev.energy(u, data, glob), iters=10)}
    kept = {n: f.kernel for n, f in ev.fam_by_name.items() if f.kernel is not None}
    try:
        for n in kept:
            ev.fam_by_name[n].kernel = None
        whole["egh_twins_ms"] = events_ms(
            lambda: ev.energy_grad_hess(u, data, glob, topo, csr), iters=3, warmup=1)
        whole["energy_twins_ms"] = events_ms(lambda: ev.energy(u, data, glob), iters=3,
                                             warmup=1)
    finally:
        for n, k in kept.items():
            ev.fam_by_name[n].kernel = k
    log(f"  whole: energy_grad_hess {whole['egh_ms']:.3f} ms with the kernels, "
        f"{whole['egh_twins_ms']:.3f} ms with the twins; energy() "
        f"{whole['energy_ms']:.3f} ms, {whole['energy_twins_ms']:.3f} ms")
    return {"families": out, "whole": whole}


def seeded_timings(names, launches: dict) -> dict:
    """Times (time_family) of families on their seeded tables
    (tools/egh_cases.py, C0 for kernel Q), float32, beside the launches of
    the path that ran them."""
    from stark_tpu_torch.tools import egh_cases as ec

    out = {}
    for name in names:
        case = ec.make_case(name, sum(map(ord, name + "C0")))
        glob, u, conn, rows = ec.to_torch(*case, dtype=torch.float32, device=DEVICE)
        fam = ec.port_families("Cubic", "C0")[name]
        out[name] = time_family(fam, u, conn, rows, glob, launches, "seeded, ")
    return out


# the mangled name of each family's float32 derivative kernel
_SPILL_KEYS = {"strain": "9FamStrainILb1EEfLb1E", "lumped": "9FamLumpedfLb1E",
               "prescribed": "13FamPrescribedfLb1E", "shells_flat": "13FamShellsFlatfLb1E",
               "rb_linear": "11FamRbLinearfLb1E", "rb_angular": "12FamRbAngularfLb1E",
               "global_points": "15FamGlobalPointsfLb1E",
               "global_directions": "19FamGlobalDirectionsfLb1E",
               "pt_dd": "10FamContactILb0ELb0ELb0EEfLb1E",
               "pt_dr": "10FamContactILb0ELb0ELb1EEfLb1E",
               "pt_rd": "10FamContactILb0ELb1ELb0EEfLb1E",
               "ee_dd": "10FamContactILb1ELb0ELb0EEfLb1E",
               "ee_dr": "10FamContactILb1ELb1ELb0EEfLb1E",
               "segment": "10FamSegmentILb1EEfLb1E", "segment_eo": "10FamSegmentILb0EEfLb1E",
               "tet": "6FamTetILb1EEfLb1E", "tet_eo": "6FamTetILb0EEfLb1E"}
_SPILL_KEYS.update({
    "points": "10FamTwoBodyI6PointsLi6EEfLb1E",
    "point_on_axis": "10FamTwoBodyI11PointOnAxisLi9EEfLb1E",
    "distances": "10FamTwoBodyI9DistancesLi6EEfLb1E",
    "distance_limits": "10FamTwoBodyI14DistanceLimitsLi6EEfLb1E",
    "damped_spring": "10FamTwoBodyI12DampedSpringLi6EEfLb1E",
    "directions": "13FamDirectionsILb0EEfLb1E", "angle_limits": "13FamDirectionsILb1EEfLb1E",
    "linear_velocity": "11FamVelocityILb1EEfLb1E",
    "angular_velocity": "11FamVelocityILb0EEfLb1E", "shells": "9FamShellsfLb1E",
    "strain_eo": "9FamStrainILb0EEfLb1E", "pt_rr": "10FamContactILb0ELb1ELb1EEfLb1E",
    "ee_rr": "10FamContactILb1ELb1ELb1EEfLb1E",
    "att_pp": "9FamAttachILi0EEfLb1E", "att_pe": "9FamAttachILi1EEfLb1E",
    "att_pt": "9FamAttachILi2EEfLb1E", "att_ee": "9FamAttachILi3EEfLb1E",
    "att_rbd": "12FamAttachRbdfLb1E"})
_SPILL_KEYS.update({"friction_" + stem: "11FamFrictionILb%dELb%dELb%dEEfLb1E" % flags
                    for stem, flags in (("pt_dd", (0, 0, 0)), ("pt_dr", (0, 0, 1)),
                                        ("pt_rd", (0, 1, 0)), ("pt_rr", (0, 1, 1)),
                                        ("ee_dd", (1, 0, 0)), ("ee_dr", (1, 1, 0)),
                                        ("ee_rr", (1, 1, 1)))})


def spill_of(spills: dict, site: str):
    """The spill stores of a site's float32 derivative kernel (and, for
    N and O, of the shared per-lane function it calls), or None."""
    family = site.split("[")[1][:-1]
    out = [v for k, v in spills.items() if _SPILL_KEYS[family] in k]
    if site.startswith("egh_contact"):
        kind = "contact_pair_eghIfLb%dE" % family.startswith("ee")
        out += [v for k, v in spills.items() if kind in k]
    return sum(out) if out else None


def ptxas_spills(ptxas: dict) -> dict:
    """Spill stores (bytes) of each egh kernel and function in the ptxas
    report: {symbol: spill stores}."""
    out = {}
    for src, text in ptxas.items():
        if not src.startswith("egh_"):
            continue
        name = None
        for line in text.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                name = line.split("'")[1] if "'" in line else line.split()[-1]
            elif name and "spill stores" in line:
                out[name] = int(line.split("bytes spill stores")[0].split(",")[-1])
    return out


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
    # the hash-grid broad phase (phase 12): the grid build and the row-K
    # candidate selection of _grid_stage1 (:613) and _rowk_topk (:586)
    ("grid_build", "stark_tpu_torch/csrc/grid_build.cu",
     "stark_tpu/collision/broad_phase.py:48"),
    ("rowk_select", "stark_tpu_torch/csrc/rowk_select.cu",
     "stark_tpu/models/interactions/contact_engine.py:586"),
    # the staged solver (phases 14-15): q = H p per arity group (hvp_ctx),
    # DirectLLT's dense scatter, and the contact refresh's dense branch
    ("hvp_bucket[staged]", "stark_tpu_torch/csrc/hvp_bucket.cu",
     "stark_tpu/solver/assembly.py:186"),
    ("segment_reduce[direct]", "stark_tpu_torch/csrc/segment_reduce.cu",
     "stark_tpu/solver/newton.py:190"),
    ("contact_pairs[pt]", "stark_tpu_torch/csrc/friction_pairs.cu",
     "stark_tpu/models/interactions/contact_engine.py:1019"),
    ("contact_pairs[ee]", "stark_tpu_torch/csrc/friction_pairs.cu",
     "stark_tpu/models/interactions/contact_engine.py:1031"),
]
CONTACT_KERNELS = ("compact", "ball_wide", "pt_ee_distance[pt]",
                   "pt_ee_distance[ee]", "segment_triangle_any")
FRICTION_KERNELS = ("friction_pairs[pt]", "friction_pairs[ee]", "friction_rows[pt]",
                    "friction_rows[ee]")
SOLVER_KERNELS = ("segment_reduce[egh]", "segment_reduce[diag]", "segment_reduce[dense]",
                  "hvp_bucket", "pd_project", "block3_inverse", "block3_apply")
# K12 (phase 24): the graph's loop control and the PCG step; every fused
# phase's capture launches them (a launch inside the captured graph counts
# once per capture, its replays are the device's)
K12_KERNELS = ("graph_ctl", "pcg_step[1]", "pcg_step[2]")
# the staged path of phase 14: no shells, so kernel G's EE distance does not
# run there (the contact mode of I measures every EE pair itself); the
# oracle's ball pairs (F), lower bounds (G[pt]) and any-hit (H) run in the
# line search's [inv] stage
STAGED_KERNELS = ("segment_reduce[egh]", "segment_reduce[diag]", "hvp_bucket[staged]",
                  "pd_project", "block3_inverse", "block3_apply", "compact", "ball_wide",
                  "pt_ee_distance[pt]", "segment_triangle_any", "contact_pairs[pt]",
                  "contact_pairs[ee]") + FRICTION_KERNELS
STAGED_RUN_KERNELS = ("hvp_bucket[staged]", "contact_pairs[pt]", "contact_pairs[ee]")


def egh_record(name, t, c, spills, **extra) -> dict:
    """The kernels line's record of a family's egh kernel: its times and
    launches `t` (time_family), its check `c` (hold_egh)."""
    kind = t["site"].split("[")[0]
    return {"name": t["site"], "route": "cuda", "source": f"stark_tpu_torch/csrc/{kind}.cu",
            "replaces": EGH_REPLACES[name], "launches": t["launches"],
            "max_abs_err": c["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"], **extra, "launches_value_only": t["launches_e"],
            "ms_value_only": t["ms_e"], "plain_ms_value_only": t["plain_ms_e"],
            "spill_stores": spill_of(spills, t["site"])}


# ---------------------------------------------------------------------------
# phase 24: K12, the fused solve as one CUDA graph (kernels X and Y)
# ---------------------------------------------------------------------------
K12_SOLVES = 3
X_LOOP = 1000


def k12_window(sim, solves: int, where: str, profiled: bool = False) -> dict:
    """At a phase's final state: `solves` more time steps through the
    captured graph, recorded; then each solve again from its inputs and
    capacities under the eager driver, u, stats, counts and M bit for bit,
    with the captures, the capture time, ms per Newton of both on graph
    replays and (`profiled`, phases 7 and 23) the last timed solve's eager
    kernel time under torch.profiler beside both drivers' ms on it."""
    from stark_tpu_torch.tools import k12_checks

    res = k12_checks.window(sim, solves, profiled=profiled)
    print(f"phase 24 ({where}): " + json.dumps(res), flush=True)
    assert res["solves"] >= solves and all(res["bitwise_equal"]), \
        f"{where}: the graph and the eager driver differ"
    return res


def k12_kernel_checks(sim) -> dict:
    """Kernel X's nested WHILE/IF/WHILE check and one WHILE iteration's
    latency, graph against the eager driver; kernel Y against its twin at
    the scene's state (the Newton system as the solve forms it) and its two
    halves timed in CUDA graphs beside the twin's."""
    from stark_tpu_torch.ops import pcg_step as Y
    from stark_tpu_torch.solver.pcg import pcg_init
    from stark_tpu_torch.solver.program import Program
    from stark_tpu_torch.tools import k12_checks

    out = {}
    nested = k12_checks.nested_check(torch.device(DEVICE))
    log("  X nested WHILE/IF/WHILE: " + json.dumps(nested))
    assert nested["ok"], "kernel X: the nested nodes disagree"
    n0 = torch.zeros((), dtype=torch.int64, device=DEVICE)
    n_loop = torch.full((), X_LOOP, dtype=torch.int64, device=DEVICE)
    g = Program(k12_checks.loop_program, (n0,), graph=True)
    e = Program(k12_checks.loop_program, (n0,), graph=False)
    x_ms = events_ms(lambda: g((n_loop,)), iters=5, warmup=1) / X_LOOP
    x_plain = events_ms(lambda: e((n_loop,)), iters=2, warmup=1) / X_LOOP
    assert int(g((n_loop,))) == X_LOOP
    g.release()
    out["graph_ctl"] = {"max_abs_err": 0.0, "ms": x_ms, "plain_ms": x_plain,
                        "bound_ms": bound_ms(1, 0, torch.float32)[0], "bound_by": "bytes",
                        "library_ms": None, "shape": f"WHILE x {X_LOOP}",
                        "nested": nested["cases"]}
    A, Minv, b = k12_checks.newton_system(sim)
    chk = k12_checks.pcg_step_check(A, Minv, b)
    log("  Y against its twin: " + json.dumps(chk))
    assert chk["flags_equal"] and chk["max_err_ratio"] <= 1.0, "kernel Y disagrees"
    x, r, p, sf, si = pcg_init(Minv, b, torch.zeros((), dtype=b.dtype, device=DEVICE), 1)
    Ap, z = A(p).contiguous(), Minv(r).contiguous()
    b1, b2 = k12_checks.pcg_step_bytes(b.numel(), b.dtype)
    for half, kern, plain, nb in (
            ("pcg_step[1]", lambda: Y.pcg_step1(p, Ap, x, r, sf, si, False, 0.0),
             lambda: Y.pcg_step1_plain(p, Ap, x, r, sf, si, False, 0.0), b1),
            ("pcg_step[2]", lambda: Y.pcg_step2(z, r, p, sf, si, 1 << 30),
             lambda: Y.pcg_step2_plain(z, r, p, sf, si, 1 << 30), b2)):
        out[half] = {"max_abs_err": chk["max_abs_err"], "ms": graph_ms(kern),
                     "plain_ms": graph_ms(plain), "bound_ms": bound_ms(nb, 0, b.dtype)[0],
                     "bound_by": "bytes", "library_ms": None,
                     "shape": f"{tuple(b.shape)} {chk['dtype']}",
                     "err_ratio": chk["max_err_ratio"]}
    log("  X and Y: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 25: K15's helpers (kernels AA-AC) behind the linear-solve profiler,
# and kernel Z (exact eigh on the card, blocks over 64 DOFs)
# ---------------------------------------------------------------------------
SWEEPS0_SECONDS = 0.05
Z_SEEDED_D = 96
LINSOLVE_KERNELS = ("gather_tables[scatter_table]", "gather_tables[scatter_table_rows]",
                    "gather_tables[direct_tables]", "hvp_table", "dense_runs[perm]",
                    "dense_runs[direct]")
PHASE25_KERNELS = [
    # name, source, the TPU-shaped JAX function it replaces
    ("pd_project_z", "stark_tpu_torch/csrc/pd_project.cu", "stark_tpu/solver/project.py:116"),
    ("gather_tables[scatter_table]", "stark_tpu_torch/csrc/gather_tables.cu",
     "stark_tpu/solver/assembly.py:214"),
    ("gather_tables[scatter_table_rows]", "stark_tpu_torch/csrc/gather_tables.cu",
     "stark_tpu/solver/assembly.py:524"),
    ("gather_tables[direct_tables]", "stark_tpu_torch/csrc/gather_tables.cu",
     "stark_tpu/solver/assembly.py:604"),
    ("hvp_table", "stark_tpu_torch/csrc/hvp_table.cu", "stark_tpu/solver/assembly.py:239"),
    ("dense_runs[perm]", "stark_tpu_torch/csrc/dense_runs.cu",
     "stark_tpu/solver/assembly.py:642"),
    ("dense_runs[direct]", "stark_tpu_torch/csrc/dense_runs.cu",
     "stark_tpu/solver/assembly.py:789"),
]


def same_timer(kernel, library):
    """(kernel ms, library ms, "graph" or "events"): both timed in a CUDA
    graph, or both from host launches with CUDA events where the library
    call cannot be captured."""
    try:
        lib_ms = graph_ms(library)
    except RuntimeError as exc:
        log(f"  the library call cannot be captured ({str(exc).splitlines()[0]}): "
            f"both timed from host launches")
        torch.cuda.synchronize()
        return events_ms(kernel), events_ms(library), "events"
    return graph_ms(kernel), lib_ms, "graph"


def hold_exact(name, got, want):
    """Integer tables bit for bit, overflow signals included."""
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(a.cpu().to(torch.int64), b.cpu().to(torch.int64))]
    log(f"  {name:<36} {len(got)} outputs bit for bit: {'ok' if not bad else f'FAIL {bad}'}")
    assert not bad, f"{name} disagrees with its twin in outputs {bad}"


def linsolve_checks(sim) -> dict:
    """Kernels AA-AC against their twins at the simulation's state (phase
    7's, in JAX's single bucket): the tables bit for bit, the hvp and both
    dense layouts within 64 eps sum|terms|; kernel B at the fused solve's
    product (the static bucket and the live pool, `hvp_site`). Each kernel timed in a CUDA
    graph, its twin from host launches (kernel E's twin, torch.nonzero,
    reads the host), with its one-call PyTorch yardstick and its bound on
    this state's data."""
    from stark_tpu_torch.ops import dense_runs as dr, hvp_bucket as hb, hvp_table as htb
    from stark_tpu_torch.ops import tables as tb
    from stark_tpu_torch.tools import profile_linsolve as pl

    st = pl.linear_system(sim)
    n, conn, H = st.ev.n_blocks, st.conn, st.H
    dtype, sz = H.dtype, H.element_size()
    E, b = conn.shape
    rows = conn.reshape(-1).to(torch.int32)
    R, N1 = rows.numel(), n + 1
    K, HC, K2, SC = pl.K, pl.HOT_CAP, pl.K2, pl.SLOT_CAP
    ids = torch.arange(n, dtype=torch.int32, device=DEVICE)

    def lib_tables(keys):
        srt = torch.sort(keys, stable=True)
        return torch.searchsorted(srt.values, ids)

    out = {}
    # ---- AA
    got = tb.gather_table(rows, n, K)
    hold_exact("gather_tables[scatter_table]", got, tb.gather_table_plain(rows, n, K))
    bnd = bound_ms(4 * R + 4 * n * K + 4, 0, dtype)
    out["gather_tables[scatter_table]"] = dict(
        max_abs_err=0.0, ms=graph_ms(lambda: tb.gather_table(rows, n, K)),
        plain_ms=events_ms(lambda: tb.gather_table_plain(rows, n, K), iters=5),
        library_ms=graph_ms(lambda: lib_tables(rows)), bound_ms=bnd[0], bound_by=bnd[1],
        shape=f"rows ({R},), table ({n}, {K}), max_len {int(got[1])}")
    got = tb.gather_table_rows(rows, n, K, HC, K2)
    hold_exact("gather_tables[scatter_table_rows]", got,
               tb.gather_table_rows_plain(rows, n, K, HC, K2))
    bnd = bound_ms(4 * R + 4 * n * K + 4 * HC * (K2 + 1) + 8, 0, dtype)
    out["gather_tables[scatter_table_rows]"] = dict(
        max_abs_err=0.0, ms=graph_ms(lambda: tb.gather_table_rows(rows, n, K, HC, K2)),
        plain_ms=events_ms(lambda: tb.gather_table_rows_plain(rows, n, K, HC, K2), iters=5),
        library_ms=graph_ms(lambda: lib_tables(rows)), bound_ms=bnd[0], bound_by=bnd[1],
        shape=f"rows ({R},), ({n}, {K}) + ({HC}, {K2}), hot_n {int(got[3])}, "
              f"max_deg {int(got[4])}")
    dtab = tb.direct_tables(conn, n, SC)
    hold_exact("gather_tables[direct_tables]", dtab, tb.direct_tables_plain(conn, n, SC))
    R2 = dtab.order.numel()
    pid = tb._pair_keys_plain(conn, n)
    bnd = bound_ms(4 * E * b + 5 * R2 + 8 * SC + 4, 0, dtype)
    out["gather_tables[direct_tables]"] = dict(
        max_abs_err=0.0, ms=graph_ms(lambda: tb.direct_tables(conn, n, SC)),
        plain_ms=events_ms(lambda: tb.direct_tables_plain(conn, n, SC), iters=5),
        library_ms=graph_ms(lambda: torch.sort(pid, stable=True)), bound_ms=bnd[0],
        bound_by=bnd[1], shape=f"conn ({E}, {b}), {R2} pairs, {int(dtab.n_slots)} slots "
                               f"of {SC}")
    # ---- AB against its twin; the yardstick: the same matrix as BSR
    p = (-st.grad).contiguous()
    entry = got[0]
    groups = [(conn, H)]
    q = htb.hvp_table(p, groups, entry)
    q2 = htb.hvp_table(p, groups, entry)
    ref = htb.hvp_table_plain(p, groups, entry)
    absref = htb.hvp_table_plain(p.abs(), [(conn, H.abs())], entry)
    torch.cuda.synchronize()
    err = check("hvp_table", dtype, (q - ref).abs(), sum_tol(absref, dtype))
    assert torch.equal(q, q2), "hvp_table: two launches differ"
    p64, g64 = p.double(), [(conn, H.double())]
    q64 = htb.hvp_table(p64, g64, entry)
    torch.cuda.synchronize()
    check("hvp_table", torch.float64, (q64 - htb.hvp_table_plain(p64, g64, entry)).abs(),
          sum_tol(htb.hvp_table_plain(p64.abs(), [(conn, H.double().abs())], entry),
                  torch.float64))
    assert torch.equal(q64, htb.hvp_table(p64, g64, entry)), "hvp_table: f64 launches differ"
    kept = int((entry < R).sum())
    nb = kept * 9 * b * sz + 4 * (n * K + kept * b) + 2 * p.numel() * sz
    bnd = bound_ms(nb, 2.0 * kept * 9 * b, dtype)
    bsr = bsr_of(groups, n)
    pv = p.reshape(-1, 1)
    ms, lib_ms, timed = same_timer(lambda: htb.hvp_table(p, groups, entry),
                                   lambda: torch.sparse.mm(bsr, pv))
    out["hvp_table"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=graph_ms(lambda: htb.hvp_table_plain(p, groups, entry)),
        library_ms=lib_ms, timed=timed, bound_ms=bnd[0], bound_by=bnd[1],
        shape=f"H ({E}, {3 * b}, {3 * b}), {kept} table entries, p ({n}, 3)")
    # ---- B at the fused solve's product: the static bucket and the pool
    solver = [(st.topo.conn_cat32, st.H_stat, st.topo.csr_cat)]
    if st.pool is not None:
        solver.append((st.pool.conn32, st.pool.H, st.pool.csr))
    q_ev = st.ev.hvp_bucket(p, st.H_stat, st.topo, st.pool)
    assert torch.equal(q_ev, hb.hvp_groups(p, solver)), \
        "Evaluators.hvp_bucket and one launch over its buckets differ"
    out["hvp_bucket[solver]"] = hvp_site("phase 7 solver product", solver, n, p)
    # ---- AC, both layouts; the yardstick: index_add_ of the pair values
    vals = dr.pair_values(H)
    pid_l = pid.to(torch.int64)

    def lib_add():
        return torch.zeros((N1 * N1, 9), dtype=dtype, device=DEVICE).index_add_(0, pid_l, vals)

    for layout, name, m in ((dr.PERM, "dense_runs[perm]", 3 * N1),
                            (dr.DIRECT, "dense_runs[direct]", 3 * n)):
        got = dr.dense_runs(H, dtab, n, layout)
        ref = dr.dense_runs_plain(H, dtab, n, layout)
        if layout == dr.PERM:
            tol = sum_tol(dr.dense_runs_plain(H.abs().double(), dtab, n, layout), dtype)
        else:
            # the twin differences JAX's f64 cumsum: its error scales with
            # the prefix's sum |terms|, the kernel's with the run's
            run_abs, prefix_abs = dr.direct_sum_scales(H, dtab, n)
            tol = sum_tol(run_abs, dtype) + sum_tol(prefix_abs, torch.float64)
        torch.cuda.synchronize()
        err = check(name, dtype, (got.double() - ref.double()).abs(), tol)
        bnd = bound_ms(R2 * (9 * sz + 4) + 8 * SC + m * m * sz, R2 * 9, dtype)
        out[name] = dict(
            max_abs_err=err, ms=graph_ms(lambda: dr.dense_runs(H, dtab, n, layout)),
            plain_ms=events_ms(lambda: dr.dense_runs_plain(H, dtab, n, layout), iters=5),
            library_ms=graph_ms(lib_add), bound_ms=bnd[0], bound_by=bnd[1],
            shape=f"{R2} block pairs, {int(dtab.n_slots)} runs, ({m}, {m})")
    return out


def z_checks(sim) -> dict:
    """Kernel Z against its twin at phase 7's d = 3 rows (the box's fix,
    rb_constraint_global_directions, JAX's exact-eigh branch) and on a
    seeded d = 96 stack (the shared wide layout) in float32 and float64,
    converged: within 2000 eps max|H_e| per matrix, every matrix
    converged, at d = 96 after the twin's sweeps; timed with eigh as its
    yardstick (from host launches: eigh reads the host)."""
    from stark_tpu_torch.ops import pd_project as pd
    from stark_tpu_torch.tools import profile_linsolve as pl

    st = pl.linear_system(sim)
    H3 = st.hess["rb_constraint_global_directions"].contiguous()
    rng = np.random.default_rng(96)
    A = rng.normal(size=(8, Z_SEEDED_D, Z_SEEDED_D))
    H96 = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), dtype=H3.dtype, device=DEVICE)
    out = {}
    for label, H in (("d3", H3), ("d96", H96), ("d96_f64", H96.double())):
        E, d, _ = H.shape
        unconv = torch.zeros((), dtype=torch.int32, device=DEVICE)
        sweeps = torch.zeros((E,), dtype=torch.int32, device=DEVICE)
        got, ch = pd.pd_project_z(H, 1e-10, False, None, 0, unconv, sweeps)
        ref, ch_ref = pd.pd_project_z_plain(H, 1e-10, False, None, 0)
        sw = pd._jacobi_eigh_converged(H)[3]
        torch.cuda.synchronize()
        assert int(unconv) == 0 and torch.equal(ch, ch_ref), f"kernel Z at {label}"
        # the wide layouts round their rotations as the twin does; the warp
        # layout contracts FMAs, which can move a stop test by a sweep
        same = torch.equal(sweeps.long(), sw)
        log(f"  pd_project_z[{label}] ({pd.z_layout(d, H.dtype)}): sweeps {sweeps.tolist()}, "
            f"the twin's {sw.tolist()}")
        assert same or d <= pd.KERNEL_WIDE_MAX_D, \
            f"kernel Z at {label}: other sweeps than the twin"
        tol = 2000.0 * torch.finfo(H.dtype).eps * H.abs().amax(dim=(1, 2), keepdim=True)
        err = check(f"pd_project_z[{label}]", H.dtype, (got - ref).abs(),
                    tol + torch.finfo(H.dtype).tiny)
        n_rounds = d if d % 2 else d - 1
        flops = float(sw.sum()) * n_rounds * 9 * d * d + E * 3 * d ** 3
        bnd = bound_ms(nbytes(H, got, ch), flops, H.dtype)
        out[label] = dict(
            max_abs_err=err, ms=graph_ms(lambda: pd.pd_project_z(H, 1e-10, False, None, 0)),
            plain_ms=events_ms(lambda: pd.pd_project_z_plain(H, 1e-10, False, None, 0),
                               iters=3),
            library_ms=events_ms(lambda: torch.linalg.eigh(H), iters=5),
            bound_ms=bnd[0], bound_by=bnd[1], layout=pd.z_layout(d, H.dtype),
            shape=f"H {tuple(H.shape)}, converged in {int(sw.min())}-{int(sw.max())} sweeps")
    log("  Z: " + json.dumps(out))
    return out


def sweeps0_run() -> dict:
    """Phase 19's soft boxes at jacobi_sweeps = 0 (JAX's exact eigh: kernel
    Z converged for every family) for SWEEPS0_SECONDS through the fused
    solve's graph: finite, every step successful, one host read per solve."""
    from stark_tpu_torch.tools.scenes import deformable_and_rigid_collisions

    sim, (h1, h2, _floor) = deformable_and_rigid_collisions("float32", DEVICE)
    sim.stark.settings.device.jacobi_sweeps = 0
    launches, fields = run_scene(sim, SWEEPS0_SECONDS, "phase 25 (soft boxes, sweeps 0)")
    x = np.concatenate([h1.point_set.get_positions(), h2.point_set.get_positions()])
    assert np.all(np.isfinite(x)), "phase 25: non-finite positions at sweeps 0"
    codes = fields["solver_codes"]
    assert codes and codes[-1] == 1, f"phase 25: solver codes {codes} at sweeps 0"
    syncs = int(sim.get_logger().get_stats("host_syncs").total)
    assert syncs == len(codes) + fields["fused_retraces"], \
        f"phase 25: {syncs} host reads for {len(codes)} solves at sweeps 0"
    assert launches.get("pd_project_z", 0) > 0 and launches.get("pd_project", 0) == 0, \
        f"phase 25: the sweeps-0 projections did not all take kernel Z: {launches}"
    assert sim.stark.newton._fused.captures >= 1
    return fields


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

    # phases 9, 10, 12-13, 14, 18-20, 21-22 and 23 run beside phases 3-8, each in a
    # process of its own: the work is host-bound (one Python thread each) and
    # the card mostly idle
    children = [start_child("--golden-sbc16", "golden_sbc16"),
                start_child("--friction", "friction"),
                start_child("--scale64", "scale64"),
                start_child("--staged", "staged", os.path.join(OUT_DIR, "staged.go")),
                start_child("--volumes", "volumes", os.path.join(OUT_DIR, "volumes.go")),
                start_child("--joints", "joints", os.path.join(OUT_DIR, "joints.go")),
                start_child("--attachments", "attachments",
                            os.path.join(OUT_DIR, "attachments.go"))]
    try:
        return phases_3_to_11(card, t_start, *children)
    finally:
        for proc, _path, logf in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()


def phases_3_to_11(card, t_start, golden_child, friction_child, scale_child,
                   staged_child, volumes_child, joints_child, attachments_child) -> int:
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
    assert_egh_path(sim64, launches64, CLOTH_FAMILIES, "the 64x64 cloth")

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
    # the box's fix (rb_constraint_global_directions, d = 3) takes kernel Z
    assert_launched(launches_sbc, CONTACT_KERNELS + SOLVER_KERNELS + K12_KERNELS
                    + ("pd_project_z",), "the contact path")
    assert_egh_path(sbc, launches_sbc, BOX_FAMILIES, "the contact path")

    # ---- 8 ----
    log("phase 8: kernels E-H (and C on the live pool) against their twins")
    results.update(contact_kernel_checks(sbc))

    # ---- 15: the other staged configurations ----
    log(f"phase 15: the staged solver's other configurations ({N_DENSE}x{N_DENSE} "
        f"cloth, float32, {STAGED_STEPS} steps each; rigid global_point, "
        f"{RIGID_STEPS} steps)")
    launches_direct, runs15, sim_direct = staged_configurations(size64)
    log("phase 16 (DirectLLT): kernel A's direct site against its twin, the Cholesky")
    r16, info16 = direct_checks(sim_direct)
    results.update(r16)

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

    # ---- 12-13: the 64x64 scale point (its own process, started with 9's)
    log(f"phase 12: spinning_box_cloth {N_SCALE}x{N_SCALE}, float32, cuda, warm-up "
        f"step + {SCALE_SECONDS} s (bench.py's scale point; EE on the hash grid)")
    r12 = finish_child(scale_child, "the 64x64 scale point")
    with open(os.path.join(OUT_DIR, "scale64.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(("scale_64:", "launches=", "-- ", "  ")):
                log("  " + line.strip())
    log(f"  {r12['seconds']:.2f}s (beside phases 3-10)")
    launches_scale = r12["launches"]
    results.update(r12["results"])
    # every other process is done with the card: phase 16 may time it
    open(os.path.join(OUT_DIR, "staged.go"), "w").close()

    # ---- 14 and 16: the staged spinning box (its own process, started with 9's)
    log(f"phase 14: spinning_box_cloth {N_SBC}x{N_SBC} with friction mu={FRICTION_MU}, "
        f"float32, cuda, {STAGED_SECONDS} s through the staged solver ({NO_FUSED_ENV}=1)")
    r14 = finish_child(staged_child, "the staged run")
    with open(os.path.join(OUT_DIR, "staged.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(("staged run:", "launches=", "-- ", "  ", "waited")):
                log("  " + line.strip())
    log(f"  {r14['seconds']:.2f}s (beside phases 3-13)")
    launches_staged = r14["launches"]
    results.update(r14["results"])
    # phase 16 is done with the card: phase 17's times at 18's and 19's states
    open(os.path.join(OUT_DIR, "volumes.go"), "w").close()

    # ---- 18-20: rods and volumes (their own process, started with 9's)
    log(f"phases 18-20: hanging_box_with_composite_material 10 ({COMPOSITE_SECONDS} s), "
        f"deformable_and_rigid_collisions 5/2 mu=1 ({COLLISIONS_SECONDS} s), hanging_net "
        f"20 ({NET_SECONDS} s), float32, cuda; kernels R, S, Q against their twins")
    r18 = finish_child(volumes_child, "the rods-and-volumes run")
    with open(os.path.join(OUT_DIR, "volumes.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(("phase 18:", "phase 19:", "phase 20:", "launches=", "-- ",
                                "  ", "waited")):
                log("  " + line.strip())
    log(f"  {r18['seconds']:.2f}s (beside phases 3-16)")
    # phases 18-20 are done with the card: phase 17's times at 21's and 22's states
    open(os.path.join(OUT_DIR, "joints.go"), "w").close()

    # ---- 21-22: the joints and full shells (their own process, started with 9's)
    log(f"phases 21-22: simple_grasp ({GRASP_SECONDS} s, f32), tests/test_rb_constraints.py's "
        f"ten joint scenes (f64), rigid_joint_chain ({CHAIN_SECONDS} s, f32), the "
        f"{N_DENSE}x{N_DENSE} cloth with full shells ({FULL_CLOTH_STEPS} steps, f32); "
        f"kernels T, U, V against their twins")
    r21 = finish_child(joints_child, "the joints run")
    with open(os.path.join(OUT_DIR, "joints.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(("phase 21", "phase 22", "launches=", "-- ", "  ", "waited")):
                log("  " + line.strip())
    log(f"  {r21['seconds']:.2f}s (beside phases 3-20)")
    # phases 21-22 are done with the card: phase 17's times at 23's state
    open(os.path.join(OUT_DIR, "attachments.go"), "w").close()

    # ---- 23: upstream's attachments example (its own process, started with 9's)
    log(f"phase 23: attachments (two 20x20 cloths glued by distance, a box glued to "
        f"one; {ATTACH_SECONDS} s, f32, frames under {os.path.relpath(FRAMES_DIR, ROOT)}); "
        f"kernel W against its twins")
    r23 = finish_child(attachments_child, "the attachments run")
    with open(os.path.join(OUT_DIR, "attachments.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(("phase 23", "launches=", "-- ", "  ", "waited")):
                log("  " + line.strip())
    log(f"  {r23['seconds']:.2f}s (beside phases 3-22)")

    # ---- 17: kernels M-S, on the idle card (every child is done)
    log("phase 17: kernels M-W against their twins (f64 and f32) at phase 4's, 7's, "
        "10's, 12's and 18-23's states, and on seeded tables for the families no "
        "scene runs and kernel Q under C0 and C1")
    r17 = {"phase4": egh_checks(sim64, CLOTH_FAMILIES, "phase 4", 4),
           "phase7": egh_checks(sbc, BOX_FAMILIES, "phase 7", 7),
           "phase10": r10["egh"], "phase12": r12["egh"], "phase18": r18["egh"]["phase18"],
           "phase19": r18["egh"]["phase19"], "phase21": r21["egh"]["phase21"],
           "phase22_chain": r21["egh"]["chain"], "phase22_cloth": r21["egh"]["cloth"],
           "phase23": r23["egh"]["phase23"], "off_path": off_path_checks()}
    # kernel Q's families that phase 19 leaves without live rows but phase
    # 10 runs (the box's corners on the cloth: friction_pt_rd): times on
    # seeded tables, launches from phase 10
    t19 = r18["times"]["phase19"]["families"]
    seeded_q = [n for n in BOX_FRICTION_FAMILIES
                if n not in t19 or r17["phase19"][n]["live_rows"] == 0]
    log(f"phase 17 (times): {seeded_q} on seeded tables, float32")
    tq = seeded_timings(seeded_q, launches_fric)
    # the families no scene of the smoke runs (kernel W's without rows in
    # phase 23 among them): times on seeded tables
    t23 = r23["times"]["phase23"]["families"]
    seeded_off = [n for n in SEEDED_TIMED if n not in t23]
    log(f"phase 17 (times): {seeded_off} on seeded tables, float32")
    t_off = seeded_timings(seeded_off, r23["launches"]["phase23"])
    log("phase 17 (times): the 32x32 spinning box at phase 7's end, float32")
    # ---- 24: K12 on the idle card, at phase 7's final state
    log("phase 24: K12, kernels X and Y at phase 7's state, the graph against "
        "the eager driver")
    r24 = k12_kernel_checks(sbc)
    r24["phase7"] = k12_window(sbc, K12_SOLVES, "phase 7", profiled=True)
    for where, r in (("phase 10", r10.get("k12")), ("phase 12", r12.get("k12")),
                     ("phase 23", r23.get("k12"))):
        log(f"  {where}: captures={r['captures']} capture_s={r['capture_s']:.2f} "
            f"timed solves={r['timed_solves']} "
            f"graph ms/newton={r['graph_ms_per_newton']} "
            f"eager ms/newton={r['eager_ms_per_newton']} "
            f"bit for bit {r['bitwise_equal']}")
    fs7 = sbc.stark.newton._fused
    log(f"  phase 7: captures={fs7.captures} capture_s={fs7.capture_seconds:.2f}")

    # ---- 25: K15's helpers behind the linear-solve profiler, and kernel Z
    log("phase 25: tools/profile_linsolve at phase 7's state (kernels AA-AC), kernel Z "
        f"at its d = 3 rows and a seeded d = {Z_SEEDED_D} stack, the soft boxes at "
        f"jacobi_sweeps = 0 for {SWEEPS0_SECONDS} s")
    from stark_tpu_torch.tools import profile_linsolve

    t25 = time.perf_counter()
    build.reset_launches()
    prof25 = profile_linsolve.profile(sbc)
    launches25 = dict(build.launches)
    log("phase 25 profile_linsolve: " + json.dumps(prof25))
    log(f"  launches={launches25}")
    assert_launched(launches25, LINSOLVE_KERNELS, "the linear-solve profiler")
    assert prof25["dense_inverse_ok"] and prof25["direct_solve_ok"], "phase 25: a factorization failed"
    r25 = linsolve_checks(sbc)
    r25["pd_project_z"] = z_checks(sbc)
    fields25 = sweeps0_run()
    log(f"  phase 25: {time.perf_counter() - t25:.1f}s")

    t7 = egh_timings(sbc, BOX_FAMILIES, 7, launches_sbc)
    log("phase 17 (times): the 64x64 cloth at phase 4's end, float32")
    t4 = egh_timings(sim64, CLOTH_FAMILIES, 4, launches64)
    spills = ptxas_spills(build.build_info["ptxas"])

    # ---- 11 ----
    kernels = []
    for name, source, replaces in KERNELS:
        r = results[name]
        if name in SCALE_KERNELS:
            launches = launches_scale.get(name, 0)
        elif name in STAGED_RUN_KERNELS:
            launches = launches_staged.get(name, 0)
        elif name == "segment_reduce[direct]":
            launches = launches_direct.get(name, 0)
        elif name in FRICTION_KERNELS:
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
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        **({"left_out": r["left_out"]} if "left_out" in r else {})})
    for name, replaces in (("graph_ctl", "stark_tpu/solver/fused.py:593"),
                           ("pcg_step[1]", "stark_tpu/solver/pcg.py:99"),
                           ("pcg_step[2]", "stark_tpu/solver/pcg.py:99")):
        src = "graph_ctl.cu" if name == "graph_ctl" else "pcg_step.cu"
        kernels.append({"name": name, "route": "cuda", "source": "stark_tpu_torch/csrc/" + src,
                        "replaces": replaces, "launches": launches_sbc.get(name, 0),
                        **r24[name]})
    for name, source, replaces in PHASE25_KERNELS:
        if name == "pd_project_z":
            r = dict(r25[name]["d3"], seeded_d96=r25[name]["d96"],
                     seeded_d96_f64=r25[name]["d96_f64"])
            launches = launches_sbc.get(name, 0)
        else:
            r, launches = r25[name], launches25.get(name, 0)
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, **r})
    for name in BOX_FAMILIES + ("EnergyPrescribedPositions",):
        cloth = name == "EnergyPrescribedPositions"
        kernels.append(egh_record(name, (t4 if cloth else t7)["families"][name],
                                  r17["phase4" if cloth else "phase7"][name], spills))
    # kernels R and S at phase 18's state, Q at phase 19's (or seeded)
    t18 = r18["times"]["phase18"]["families"]
    for name in ("EnergySegmentStrain", "EnergyTetStrain") + FRICTION_FAMILIES:
        if name in t18:
            t, c, where = t18[name], r17["phase18"][name], "phase 18"
        elif name in t19 and r17["phase19"][name]["live_rows"] > 0:
            t, c, where = t19[name], r17["phase19"][name], "phase 19"
        elif name in tq:
            t, c, where = tq[name], r17["off_path"][f"{name}[C0]"], "seeded"
        else:
            continue
        kernels.append(egh_record(name, t, c, spills, state=where))
    # kernels T and U at phase 21's state (the presses' families) and the
    # chain's (the others), V at the full-shell cloth's
    for name in JOINT_FAMILIES + ("EnergyDiscreteShells",):
        for part, state in (("phase21", "phase21"), ("chain", "phase22_chain"),
                            ("cloth", "phase22_cloth")):
            t = r21["times"][part]["families"].get(name)
            if t is not None:
                kernels.append(egh_record(name, t, r17[state][name], spills,
                                          state=state.replace("_", " ")))
                break
    # kernel W at phase 23's state where its family has rows, else seeded
    # (the other families no scene runs keep their seeded times in
    # summary.json's seeded_times)
    for name in ATTACH_FAMILIES:
        if name in t23:
            kernels.append(egh_record(name, t23[name], r17["phase23"][name], spills,
                                      state="phase23"))
        elif name in t_off:
            mode = "C0" if name.startswith("friction_") else "Cubic"
            kernels.append(egh_record(name, t_off[name], r17["off_path"][f"{name}[{mode}]"],
                                      spills, state="seeded"))
    log("phase 17 spill stores (bytes, ptxas, float32 derivative kernels): " + json.dumps(
        {k["name"]: k["spill_stores"] for k in kernels if "spill_stores" in k}))
    # Newton iterations of the scenes whose CG products go through kernel B
    newton = {"phase 7": fields["newton_iters"], "phase 10": r10["fields"]["newton_iters"],
              "phase 12": r12["fields"]["newton_iters"],
              "phase 14": r14["fields"]["newton_iters"],
              "phase 15": {k: r.get("newton_per_step") for k, r in runs15.items()}}
    log("Newton iterations: " + json.dumps(newton))
    summary = {"card": card, "newton": newton, "runs": {"cloth64_f32": run64,
                                      "cloth32_f32": run32,
                                      "spinning_box32_f32": fields,
                                      "spinning_box32_friction_f32": r10["fields"],
                                      "scale_64_f32": r12["fields"]},
               "scale_64_launches": launches_scale, "scale_64_phase13": r12["info"],
               "staged_spinning_box32_friction_f32": r14["fields"],
               "staged_launches": launches_staged, "staged_phase16": r14["info"],
               "staged_configurations": runs15, "direct_llt_phase16": info16,
               "spinning_box_launches": launches_sbc,
               "friction_launches": launches_fric,
               "golden16_f64_max_dev": worst, "egh_phase17": r17,
               "egh_times": {"spinning_box32": t7, "cloth64": t4,
                             "composite_box": r18["times"]["phase18"],
                             "soft_boxes": r18["times"]["phase19"], "seeded_q": tq},
               "egh_spills": spills,
               "volumes_runs": r18["fields"], "volumes_launches": r18["launches"],
               "joints_runs": r21["fields"], "joints_launches": r21["launches"],
               "joints_times": r21["times"],
               "attachments_runs": r23["fields"], "attachments_launches": r23["launches"],
               "attachments_times": r23["times"], "seeded_times": t_off,
               "build_s_by_source": build.build_info.get("seconds_by_source"),
               "spinning_box_golden16_f64_devs": devs, "kernels": kernels,
               "linsolve_phase25": {"profile": prof25, "launches": launches25,
                                    "kernels": r25, "soft_boxes_sweeps0": fields25},
               "k12_phase24": r24, "k12_windows": {"phase10": r10.get("k12"),
                                                   "phase12": r12.get("k12"),
                                                   "phase23": r23.get("k12")},
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
    if len(sys.argv) == 3 and sys.argv[1] == "--scale64":
        sys.exit(scale64_run(sys.argv[2]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--staged":
        sys.exit(staged_run(*sys.argv[2:]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--volumes":
        sys.exit(volumes_run(*sys.argv[2:]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--joints":
        sys.exit(joints_run(*sys.argv[2:]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--attachments":
        sys.exit(attachments_run(*sys.argv[2:]))
    if len(sys.argv) == 2 and sys.argv[1] == "--witness":
        sys.exit(witness_run())
    if len(sys.argv) == 2 and sys.argv[1] == "--witness-b":
        sys.exit(witness_b_run())
    sys.exit(main())
