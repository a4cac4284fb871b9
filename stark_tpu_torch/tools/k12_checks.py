"""Checks of K12 on the card, shared by `chip_smoke.py` (phase 24) and
tests/test_torch_cuda.py: kernel X's nested WHILE/IF nodes, kernel Y
against its twin on a scene's Newton system, and the captured fused solve
against the eager driver from the same inputs, bit for bit.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ..ops import pcg_step as Y
from ..solver import assembly
from ..solver.fused import build_fused_solve
from ..solver.pcg import pcg_init
from ..solver.program import Program


# ---------------------------------------------------------------------------
# kernel X
# ---------------------------------------------------------------------------
def count_program(n_in, ctl):
    """WHILE i < n: IF i is even: WHILE j < 3: acc += 0.5 (torch ops in the
    innermost body); i += 1. Returns (i, acc): n and 1.5 ceil(n / 2)."""
    dev = n_in.device
    i = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.float64, device=dev)

    def outer():
        def even():
            j = torch.zeros((), dtype=torch.int64, device=dev)

            def inner():
                acc.add_(torch.full((4,), 0.125, dtype=torch.float64, device=dev).sum())
                j.add_(1)

            ctl.while_(lambda: j < 3, inner)

        ctl.if_((i % 2) == 0, even)
        i.add_(1)

    ctl.while_(lambda: i < n_in, outer)
    return i, acc


def nested_check(device, ns=(5, 0, 1, 8)) -> dict:
    """The count program captured once and replayed for each n, against the
    eager driver: {n: (i, acc)} of both, and whether all agree."""
    n0 = torch.zeros((), dtype=torch.int64, device=device)
    graph = Program(count_program, (n0,), graph=True)
    eager = Program(count_program, (n0,), graph=False)
    out = {}
    ok = True
    for n in ns:
        arg = (torch.full((), n, dtype=torch.int64, device=device),)
        gi, ga = (float(t) for t in graph(arg))
        ei, ea = (float(t) for t in eager(arg))
        want = (float(n), 1.5 * ((n + 1) // 2))
        ok &= (gi, ga) == want == (ei, ea)
        out[n] = {"graph": (gi, ga), "eager": (ei, ea), "want": want}
    graph.release()
    return {"ok": ok, "cases": out}


def loop_program(n_in, ctl):
    """WHILE i < n: i += 1, the least body a WHILE node can run."""
    i = torch.zeros((), dtype=torch.int64, device=n_in.device)
    ctl.while_(lambda: i < n_in, lambda: i.add_(1))
    return i


# ---------------------------------------------------------------------------
# kernel Y
# ---------------------------------------------------------------------------
def newton_system(sim):
    """(A, Minv, b) of the Newton system at the simulation's state, as the
    fused solve forms it (tools/profile_linsolve.linear_system): kernel B's
    operator and kernel D's block-Jacobi preconditioner."""
    from .profile_linsolve import linear_system

    st = linear_system(sim)
    ev, topo, pool = st.ev, st.topo, st.pool
    Dinv = assembly.precondition_inverse(ev.diag_bucket(st.H_stat, topo, pool))
    return (lambda p: ev.hvp_bucket(p, st.H_stat, topo, pool),
            lambda r: assembly.apply_preconditioner(Dinv, r), (-st.grad).contiguous())


def _ratio(out, ref, tol):
    return float(torch.max(torch.abs(out - ref) / tol))


def pcg_step_check(A, Minv, b, steps: int = 3, k: float = 64.0) -> dict:
    """Kernel Y against its twin over `steps` CG iterations from b: at each
    iteration both halves of the kernel on the card and the twin on the
    same inputs on the CPU; the iteration goes on from the kernel's state.
    The dots obey the sum rule (k eps sum |terms|); x, r and p move with
    alpha and beta, so their bound is k eps |value| plus the step's
    relative dot error times |alpha p|, |alpha Ap| and |beta p|, alpha,
    beta and p taken before the step. Returns
    the worst error/bound ratio and the flags' agreement."""
    dtype = b.dtype
    eps = torch.finfo(dtype).eps
    abs_tol = torch.zeros((), dtype=dtype, device=b.device)
    x, r, p, sf, si = pcg_init(Minv, b, abs_tol, 1 << 30)
    worst, flags_ok, max_abs = 0.0, True, 0.0
    for _ in range(steps):
        Ap = A(p).contiguous()
        cpu = [t.cpu().clone() for t in (p, Ap, x, r, sf, si)]
        Y.pcg_step1_plain(*cpu, False, 0.0)
        Y.pcg_step1(p, Ap, x, r, sf, si, False, 0.0)
        p0, Ap0 = cpu[0].double(), cpu[1].double()
        pAp_terms = float(torch.sum(torch.abs(p0 * Ap0)))
        pAp = float(torch.sum(p0 * Ap0))
        rel = k * eps * pAp_terms / max(abs(pAp), 1e-300)
        alpha = float(cpu[4][Y.RZ]) / pAp
        tol_x = k * eps * torch.abs(cpu[2]) + rel * abs(alpha) * torch.abs(cpu[0]) \
            + torch.finfo(dtype).tiny
        tol_r = k * eps * torch.abs(cpu[3]) + rel * abs(alpha) * torch.abs(cpu[1]) \
            + torch.finfo(dtype).tiny
        worst = max(worst, _ratio(x.cpu(), cpu[2], tol_x), _ratio(r.cpu(), cpu[3], tol_r))
        max_abs = max(max_abs, float(torch.max(torch.abs(x.cpu() - cpu[2]))),
                      float(torch.max(torch.abs(r.cpu() - cpu[3]))))
        flags_ok &= torch.equal(si.cpu()[Y.STOP_INDEF:Y.PRED], cpu[5][Y.STOP_INDEF:Y.PRED])
        z = Minv(r).contiguous()
        cpu = [t.cpu().clone() for t in (z, r, p, sf, si)]
        # the step's beta and p are the values before it: p = z + beta p_old
        p_old, rz_old = cpu[2].clone(), float(cpu[3][Y.RZ])
        Y.pcg_step2_plain(*cpu, 1 << 30)
        Y.pcg_step2(z, r, p, sf, si, 1 << 30)
        z0, r0 = cpu[0].double(), cpu[1].double()
        rz_terms = float(torch.sum(torch.abs(r0 * z0)))
        rz_new = float(torch.sum(r0 * z0))
        rel_b = k * eps * rz_terms / max(abs(rz_new), 1e-300)
        beta = float(cpu[3][Y.RZ]) / max(abs(rz_old), 1e-300)
        tol_p = k * eps * torch.abs(cpu[2]) + rel_b * abs(beta) * torch.abs(p_old) \
            + torch.finfo(dtype).tiny
        max_abs = max(max_abs, float(torch.max(torch.abs(p.cpu() - cpu[2]))))
        worst = max(worst, _ratio(p.cpu(), cpu[2], tol_p),
                    abs(float(sf.cpu()[Y.RZ]) - float(cpu[3][Y.RZ])) / (k * eps * rz_terms))
        flags_ok &= torch.equal(si.cpu(), cpu[4])
    return {"max_err_ratio": worst, "max_abs_err": max_abs, "flags_equal": bool(flags_ok),
            "n": int(b.numel()), "dtype": str(dtype).replace("torch.", "")}


def pcg_step_bytes(n: int, dtype) -> tuple:
    """(bytes of Y1, bytes of Y2): each vector read once, each written once."""
    s = torch.finfo(dtype).bits // 8
    return 6 * n * s, 4 * n * s


# ---------------------------------------------------------------------------
# the graph against the eager driver
# ---------------------------------------------------------------------------
def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_clone(v) for v in tree)
    return tree


class SolveRecorder:
    """Stands in for nm._fused and keeps each call's inputs, outputs
    (cloned), wall time (to a synchronize), the engine's capacities and
    whether the call captured (its time then holds the warm-up and the
    capture); every other attribute is the wrapped FusedSolve's."""

    def __init__(self, fused, engine):
        self._f = fused
        self._engine = engine
        self.records = []

    def __call__(self, *args):
        caps = None if self._engine is None else dict(self._engine._caps)
        captures = self._f.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._f(*args)
        torch.cuda.synchronize()
        self.records.append(Record(_clone(args), _clone(out), caps,
                                   time.perf_counter() - t0,
                                   self._f.captures != captures))
        return out

    def __getattr__(self, name):
        return getattr(self._f, name)


class Record(NamedTuple):
    args: tuple
    out: tuple
    caps: Optional[dict]
    seconds: float
    captured: bool


def record(nm) -> SolveRecorder:
    """Wrap nm's fused solve (building it first if need be) in a recorder."""
    if nm._fused is None:
        nm._build_fused()
    rec = SolveRecorder(nm._fused, nm._engine())
    nm._fused = rec
    return rec


def stop_recording(nm, rec: SolveRecorder):
    nm._fused = rec._f


def _timed(fn, args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _per_newton(ms_total, newton):
    return ms_total / newton if newton else None


def graph_vs_eager(nm, rec: SolveRecorder, profiled: bool = False) -> dict:
    """Each recorded solve (a capacity overflow's first call included) again
    from its recorded inputs and capacities under the eager driver on the
    card: u, the stats, the counts and M against the graph's, bit for bit.
    Times come from graph replays only: a call that captured is timed
    again as a replay where its capacities are the current ones (then
    also held bit for bit), else left out of both drivers' times. Each
    time is wall time per Newton iteration (binding and the device work,
    to a synchronize; the solve's one read is the caller's). `profiled`:
    the last timed solve again under the eager driver in torch.profiler,
    its kernel time the bound of the graph on that solve, given beside
    both drivers' ms on the same solve. The profiler does not see the
    kernels inside a graph's conditional bodies, so the graph's busy share
    is inferred: that kernel time over the graph's wall time. The eager
    driver's reads are counted apart."""
    eng = nm._engine()
    caps_now = None if eng is None else dict(eng._caps)
    captures, capture_s = nm._fused.captures, nm._fused.capture_seconds
    eager, _keys = build_fused_solve(nm, eng, eager=True)
    equal, newton, timed = [], [], []
    try:
        for idx, r in enumerate(rec.records):
            if r.caps is not None:
                eng._caps = dict(r.caps)
            e_out, te = _timed(eager, r.args)
            equal.append(all(torch.equal(x, y) for x, y in zip(r.out, e_out)))
            newton.append(int(r.out[1][1]))
            tg = r.seconds
            if r.captured:
                if r.caps != caps_now:
                    continue
                c0 = nm._fused.captures
                g_out, tg = _timed(nm._fused, r.args)
                if nm._fused.captures != c0:
                    continue
                equal[-1] &= all(torch.equal(x, y) for x, y in zip(g_out, e_out))
            timed.append((idx, newton[-1], tg, te))
        prof = None
        if profiled and timed:
            idx, n_last, tg, te = timed[-1]
            if rec.records[idx].caps is not None:
                eng._caps = dict(rec.records[idx].caps)
            bs = busy_share(eager, rec.records[idx].args)
            k = max(n_last, 1)
            prof = {"solve": idx, "newton": n_last,
                    "graph_ms_per_newton": 1e3 * tg / k,
                    "eager_ms_per_newton": 1e3 * te / k,
                    "kernel_ms_per_newton": bs["device_ms"] / k,
                    "eager_busy_share": bs["device_ms"] / bs["wall_ms"],
                    "graph_busy_share_inferred": bs["device_ms"] / (1e3 * tg)}
    finally:
        if eng is not None:
            eng._caps = caps_now
        eager.release()
    n = sum(t[1] for t in timed)
    out = {"solves": len(equal), "bitwise_equal": equal, "newton": newton,
           "timed_solves": [t[0] for t in timed], "timed_newton": n,
           "driver_reads": eager.driver_reads,
           "graph_ms_per_newton": _per_newton(1e3 * sum(t[2] for t in timed), n),
           "eager_ms_per_newton": _per_newton(1e3 * sum(t[3] for t in timed), n),
           "captures": captures, "capture_s": capture_s}
    if profiled:
        out["profile"] = prof
    return out


def busy_share(fn, args) -> dict:
    """Wall and device time of fn(*args) under torch.profiler: the device's
    busy share, and the summed kernel time (rows without CPU time: kernels,
    copies and fills)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.self_cpu_time_total == 0)
    return {"wall_ms": 1e3 * wall, "device_ms": dev_us / 1e3}


def window(sim, solves: int, profiled: bool = True) -> dict:
    """`solves` more time steps of a scene, recorded, then graph_vs_eager
    on them."""
    nm = sim.stark.newton
    rec = record(nm)
    try:
        for _ in range(solves):
            if not sim.run_one_time_step():
                raise AssertionError("a time step of the K12 window failed")
    finally:
        stop_recording(nm, rec)
    return graph_vs_eager(nm, rec, profiled=profiled)
