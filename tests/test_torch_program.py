"""The fused solve as one device program (K12) on the CPU: the program under
EagerControl (the plain version of the card's CUDA graph, kernel X) against
`stark_tpu`'s fused solve, its host reads, its input binder, a capacity
overflow, and PCG with kernel Y's twin against the loop it replaced."""
import math
from importlib import import_module

import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu_torch.solver import fused as tfused
from stark_tpu_torch.solver.pcg import solve_pcg
from stark_tpu_torch.solver.program import EagerControl, Program, flatten, unflatten


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(pkg, cpu, dt=1 / 30):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = "float64"
    s.simulation.max_time_step_size = dt
    if cpu:
        s.device.device = "cpu"
    return s


def _spinning_box(pkg, n, cpu, adaptive=True):
    P = import_module(pkg.__name__ + ".presets.presets")
    C = import_module(pkg.__name__ + ".models.interactions.contact")
    s = _settings(pkg, cpu)
    s.simulation.use_adaptive_time_step = adaptive
    sim = pkg.Simulation(s)
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (n, n), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    sim.add_time_event(0.0, 10.0, lambda t: fix.set_transformation(
        [0.0, 0.0, -0.08 - 0.1 * math.sin(t)], angle_deg=90.0 * t,
        axis=[0.0, 0.0, 1.0]))
    return sim, cloth


def _hanging_cloth(pkg, n, cpu):
    E = import_module(pkg.__name__ + ".models.deformables.energies")
    P = import_module(pkg.__name__ + ".presets.presets")
    s = _settings(pkg, cpu, dt=1 / 60)
    s.simulation.init_frictional_contact = False
    s.newton.residual_tolerance_abs = 1e-6
    sim = pkg.Simulation(s)
    h = sim.presets.deformables.add_surface_grid(
        "", (0.3, 0.3), (n, n), P.SurfaceParams.Cotton_Fabric())
    sim.deformables.prescribed_positions.add(h.point_set, [0, n],
                                             E.PrescribedPositionsParams())
    return sim, h


def _last(sim, key):
    return sim.get_logger().series[key][-1]


@pytest.mark.parametrize("scene", ["spinning_box_8", "hanging_cloth_8"])
def test_program_tracks_stark_tpu(scene):
    """Three f64 steps: the same codes, Newton counts and count vector as
    stark_tpu's fused solve, positions within 1e-6 m, one host read per
    solve (the program's tests are device predicates). The ball
    prefilter's raw counts (w_ keys) agree within 0.1%: their thresholds
    carry the port's own rounding pad (contact_engine._bound_pad), and at
    step 2 of the box w_et is 3,083 against JAX's 3,084 (as before K12);
    every list the solve keeps is equal."""
    make = (lambda pkg, cpu: _spinning_box(pkg, 8, cpu)) if scene == "spinning_box_8" \
        else (lambda pkg, cpu: _hanging_cloth(pkg, 8, cpu))
    js, jc = make(stark_tpu, False)
    ts, tc = make(stark_tpu_torch, True)
    for step in range(3):
        assert js.run_one_time_step()
        assert ts.run_one_time_step()
        assert _last(ts, "solver_code") == _last(js, "solver_code"), step
        assert _last(ts, "newton_iterations") == _last(js, "newton_iterations"), step
        tcnt, jcnt = ts.stark.newton._last_counts, js.stark.newton._last_counts
        assert sorted(tcnt) == sorted(jcnt), step
        for k, v in jcnt.items():
            if k.startswith("w_"):
                assert abs(tcnt[k] - v) <= 1e-3 * v, (step, k, tcnt[k], v)
            else:
                assert tcnt[k] == v, (step, k, tcnt[k], v)
        dev = np.max(np.abs(np.asarray(jc.point_set.get_positions())
                            - tc.point_set.get_positions()))
        assert dev < 1e-6, f"step {step}: deviation {dev:.3e}"
        assert ts.stark.newton.stats.host_syncs == 1
        assert _last(ts, "driver_reads") > _last(ts, "newton_iterations")


def test_program_makes_no_host_read_inside_a_body(monkeypatch):
    """A strict EagerControl makes Evaluators.to_host raise inside a body;
    the fused solve of a contact scene runs under it, and its host_syncs is
    the one read at the solve's end."""
    build = tfused.build_fused_solve
    monkeypatch.setattr(tfused, "build_fused_solve",
                        lambda nm, engine=None, **kw: build(nm, engine, strict=True))
    sim, cloth = _spinning_box(stark_tpu_torch, 6, True)
    for step in range(3):
        assert sim.run_one_time_step()
        assert sim.stark.newton.stats.host_syncs == 1, step
    nm = sim.stark.newton
    assert nm._fused._strict_ev is nm._ev
    assert nm.live_contact_pairs() > 0
    ctl = EagerControl(strict_ev=nm._ev)
    with pytest.raises(RuntimeError, match="host read inside a body"):
        ctl.if_(torch.ones((), dtype=torch.bool),
                lambda: nm._ev.to_host(torch.zeros(())))
    assert nm._ev.forbid_reads == 0


def test_binder_gives_the_direct_trajectory(monkeypatch):
    """Five steps of the 4x4 spinning box with adaptive dt (the moving fix
    changes the static tables and glob at every step) through the binder
    give the trajectory of the same program called on the arguments
    themselves, bit for bit."""
    def run():
        sim, cloth = _spinning_box(stark_tpu_torch, 4, True)
        out = []
        for _ in range(5):
            assert sim.run_one_time_step()
            out.append((cloth.point_set.get_positions().copy(),
                        _last(sim, "newton_iterations"), sim.stark.dt))
        return out

    with_binder = run()
    with monkeypatch.context() as m:
        m.setattr(tfused.FusedSolve, "__call__",
                  lambda self, *args: self.program(*args, ctl=EagerControl()))
        direct = run()
    assert with_binder[-1][1] > 0
    for (xa, na, dta), (xb, nb, dtb) in zip(with_binder, direct):
        assert na == nb and dta == dtb
        assert np.array_equal(xa, xb)


def test_binder_keys_and_buffers():
    """flatten/unflatten round-trip a solve's argument tree; a Program keeps
    its buffers and refuses another key."""
    args = ({"a": torch.arange(3.0), "b": [torch.ones(2), 4]},
            (torch.zeros(1), "x", 2.5))
    leaves, spec = flatten(args)
    assert len(leaves) == 3
    back = unflatten(spec, leaves)
    assert back[0]["b"][1] == 4 and back[1][1:] == ("x", 2.5)
    assert back[0]["a"] is leaves[0]
    prog = Program(lambda t, ctl: t * 2.0, (torch.ones(3),), graph=False)
    buf = prog.inputs[0]
    assert torch.equal(prog((torch.full((3,), 2.0),)), torch.full((3,), 4.0))
    assert prog.inputs[0] is buf and torch.equal(buf, torch.full((3,), 2.0))
    with pytest.raises(ValueError):
        prog((torch.ones(4),))


SMALL = {"w_pt": 16, "m_pt": 16, "w_ee": 16, "m_ee": 16, "pt_dd": 4,
         "pt_dr": 4, "ee_dd": 4, "ee_dr": 4}


def test_overflow_rebinds_the_program_and_reads_twice():
    """A forced capacity overflow at the first contact step re-solves with
    the bumped capacities (a new key: the program is bound again) and
    counts two host reads; a run that starts the step with those
    capacities gives the same positions, bit for bit, with one."""
    a, ca = _spinning_box(stark_tpu_torch, 6, True, adaptive=False)
    b, cb = _spinning_box(stark_tpu_torch, 6, True, adaptive=False)
    for _ in range(2):
        assert a.run_one_time_step() and b.run_one_time_step()
    nm_a = a.stark.newton
    eng_a = a.interactions.contact.engine()
    eng_a.set_caps(SMALL)
    nm_a._pool_cap = 8
    key0 = nm_a._fused._key
    assert a.run_one_time_step()
    retraces = a.get_logger().get_int("fused_retraces")
    assert retraces >= 1
    assert nm_a.stats.host_syncs == 1 + retraces
    assert nm_a._fused._key != key0
    b.interactions.contact.engine().set_caps(dict(eng_a._caps))
    b.stark.newton._pool_cap = nm_a._pool_cap
    assert b.run_one_time_step()
    assert b.get_logger().get_int("fused_retraces") == 0
    assert b.stark.newton.stats.host_syncs == 1
    assert _last(a, "newton_iterations") == _last(b, "newton_iterations")
    assert np.array_equal(ca.point_set.get_positions(), cb.point_set.get_positions())


def _pcg_loop(A, Minv, b, abs_tol, rel_tol, max_iter, stop_on_indef):
    """The port's PCG loop before K12 (a Python loop with one host read per
    iteration), kept here as the reference of kernel Y's twin."""
    def _dot(a, c):
        return torch.sum(a * c)

    b_norm_sq = _dot(b, b)
    zero_rhs = b_norm_sq < abs_tol * abs_tol
    r = b
    z0 = Minv(r)
    rz = _dot(r, z0)
    err0 = torch.sqrt(torch.clamp_min(_dot(r, r) / torch.clamp_min(b_norm_sq, 1e-300), 0.0))
    x = torch.zeros_like(b)
    p = z0
    it = 0
    error = err0
    done = torch.logical_or(zero_rhs, err0 < abs_tol)
    converged = done
    indefinite = torch.zeros((), dtype=torch.bool)
    while it < max_iter and not done.item():
        Ap = A(p)
        pAp = _dot(p, Ap)
        indef = pAp <= 0.0
        stop_indef = indef & stop_on_indef
        alpha = rz / torch.where(pAp == 0.0, torch.full_like(pAp, 1e-300), pAp)
        x_new = x + alpha * p
        r = r - alpha * Ap
        err = torch.sqrt(_dot(r, r) / torch.clamp_min(b_norm_sq, 1e-300))
        conv = torch.logical_or(err < abs_tol,
                                err / torch.clamp_min(err0, 1e-300) < rel_tol)
        z = Minv(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0.0, torch.full_like(rz, 1e-300), rz)
        p = z + beta * p
        x = torch.where(stop_indef, x, x_new)
        error = torch.where(stop_indef, error, err)
        done = torch.logical_or(conv, stop_indef)
        converged = conv & torch.logical_not(stop_indef)
        indefinite = indefinite | indef
        rz = rz_new
        it += 1
    return x, converged, it, error, indefinite


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["spd", "indefinite", "max_iter"])
def test_pcg_with_kernel_y_twin_matches_the_loop(dtype, case):
    """solve_pcg over EagerControl (kernel Y's twin) against the loop it
    replaced, on a seeded block system: the same iterations, flags, error
    and x, bit for bit."""
    rng = np.random.default_rng(11)
    n = 40
    Q = rng.normal(size=(3 * n, 3 * n))
    K = Q @ Q.T + 3 * n * np.eye(3 * n) * (0.01 if case == "indefinite" else 1.0)
    if case == "indefinite":
        K -= 2.0 * np.diag(rng.uniform(0.5, 1.5, 3 * n)) * np.abs(K).max()
    K = torch.as_tensor(K, dtype=dtype)
    Dinv = torch.as_tensor(1.0 / np.abs(np.diag(K.numpy().astype(np.float64))),
                           dtype=dtype).reshape(n, 3)
    b = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype)

    def A(p):
        return (K @ p.reshape(-1)).reshape(n, 3)

    def Minv(r):
        return Dinv * r

    max_iter = 5 if case == "max_iter" else 500
    abs_tol = torch.as_tensor(1e-12, dtype=dtype)
    ref = _pcg_loop(A, Minv, b, abs_tol, 1e-6, max_iter, True)
    ctl = EagerControl()
    got = solve_pcg(A, Minv, b, abs_tol, 1e-6, max_iter, True, ctl=ctl)
    assert int(got.n_iterations) == ref[2] > 0
    # one read per test of the WHILE predicate, the last one false
    assert ctl.reads == ref[2] + 1
    assert bool(got.converged) == bool(ref[1])
    assert bool(got.found_indefiniteness) == bool(ref[4])
    assert torch.equal(got.error, ref[3])
    assert torch.equal(got.x, ref[0])
    if case == "indefinite":
        assert bool(got.found_indefiniteness) and not bool(got.converged)
    elif case == "spd":
        assert bool(got.converged)
    else:
        assert int(got.n_iterations) == max_iter and not bool(got.converged)
