"""The port's staged Newton solver against `stark_tpu`'s, with contact: the
per-evaluation contact refresh (`ContactEngine._contacts_fn`, K16) on a
frozen state in both of its branches, and whole staged steps of the
spinning box with friction. Both packages run on the CPU (the port's
kernels by their plain twins); the JAX package's staged path is reached
with its own STARK_TPU_NO_FUSED switch, set here per test only. The
solver-only cases are in tests/test_torch_staged.py.
"""
import math
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu_torch.utils.from_jax import set_contact_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def staged(monkeypatch):
    """Both packages' no-fused switches on for this test only."""
    monkeypatch.setenv("STARK_TPU_NO_FUSED", "1")
    monkeypatch.setenv("STARK_TPU_TORCH_NO_FUSED", "1")


# ---------------------------------------------------------------------------
# K16: the staged contact refresh on one frozen state
# ---------------------------------------------------------------------------
def _box_under_cloth(pkg, broad_phase, n=6):
    """tests/test_torch_contact.py's frozen scene: an n x n cloth 3 mm above
    a box turned 30 degrees."""
    P = import_module(pkg.__name__ + ".presets.presets")
    C = import_module(pkg.__name__ + ".models.interactions.contact")
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = "float64"
    s.simulation.max_time_step_size = 1 / 30
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    sim.interactions.contact.broad_phase = broad_phase
    sim.presets.deformables.add_surface_grid(
        "cloth", (0.1, 0.1), (n, n), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_rotation(30.0, [0.0, 0.0, 1.0])
    box.rigidbody.add_translation([0.01, -0.005, -0.043])
    sim.stark._initialize()
    return sim


def _eq(t, j, what):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j), err_msg=what)


@pytest.mark.parametrize("broad_phase,n", [("dense", 6), ("grid", 6), ("dense", 2)])
def test_contacts_fn_matches_jax(broad_phase, n):
    """_contacts_fn on one frozen state: the same family tables row for row
    and the same counts key for key, in the dense branch (kernel I's
    contact mode, then E) and the per-stem branch (every stem on the hash
    grid: L, K, G, E). Every row at its capacity has JAX's connectivity,
    activity and mesh entries, the padding past a count included (a
    projection makes its zero Hessian eps * I on those blocks); the live
    rows also have JAX's thresholds. The 2x2 cloth has fewer triangles and
    edges than the box, so JAX's padding rows of pt_dr, ee_dr and ee_rr
    wrap to a rigid triangle or edge other than 0. The dense branch adds the counts of its two flat lists,
    cl_pt and cl_ee. refresh_contacts keeps the same tables."""
    js = _box_under_cloth(stark_tpu, broad_phase, n)
    ts = _box_under_cloth(stark_tpu_torch, broad_phase, n)
    jeng = js.interactions.contact._engine
    teng = ts.interactions.contact.engine()
    assert teng._all_dense() == (broad_phase == "dense")
    u = np.random.default_rng(21).normal(0.0, 0.02, (js.stark.newton.n_blocks, 3))
    dt = 1.0 / 30.0
    jglob = jeng.glob_from_u(jnp.asarray(u), jeng.engine_state(), jnp.asarray(dt))
    tables_j, cnt_j = jax.jit(jeng._contacts_fn)(jglob, jeng._th_vec())
    jc = js.interactions.contact
    set_contact_state(ts.interactions.contact, jc.contact_thicknesses,
                      jc.contact_stiffness, caps=dict(jeng._caps))
    Vs, Vr = teng.world_from_u(torch.as_tensor(u), teng.engine_state(),
                               torch.as_tensor(dt, dtype=torch.float64))
    tables_t, cnt_t = teng._contacts_fn(Vs, Vr, teng.th_vec())

    assert sorted(cnt_j) == sorted(jeng.contact_count_keys())
    assert sorted(cnt_t) == sorted(teng.contact_count_keys())
    extra = {"cl_pt", "cl_ee"} if broad_phase == "dense" else set()
    assert set(cnt_t) == set(cnt_j) | extra
    for k in cnt_j:
        assert int(cnt_t[k]) == int(cnt_j[k]), k
    for kind in extra:
        assert int(cnt_t[kind]) == sum(int(cnt_j[s]) for s in teng._blocks()
                                       if s.startswith(kind[3:]))
    if n == 6:
        assert int(cnt_j["pt_dr"]) > 0 and int(cnt_j["ee_dr"]) > 0
    else:
        assert teng.n_tr > teng.n_ts and teng.n_er > teng.n_es
    assert sorted(tables_t) == sorted(tables_j)
    for name, fd_j in tables_j.items():
        fd_t = tables_t[name]
        act = np.asarray(fd_j["rows"]["active"]) > 0.5
        _eq(fd_t["rows"]["active"], fd_j["rows"]["active"], name + " active")
        _eq(fd_t["conn"], fd_j["conn"], name + " conn")
        assert sorted(fd_t["rows"]) == sorted(fd_j["rows"]), name
        for r, v in fd_j["rows"].items():
            rows = act if r == "dhat" else slice(None)
            _eq(fd_t["rows"][r][rows], np.asarray(v)[rows], f"{name} {r}")

    # refresh_contacts: the same tables at the current DOFs
    ts._set_dofs(torch.as_tensor(u))
    teng.refresh_contacts(dt)
    assert sorted(teng._contact_data) == sorted(tables_t)
    for name, fd in teng._contact_data.items():
        _eq(fd["conn"], tables_t[name]["conn"], name)
        _eq(fd["rows"]["active"], tables_t[name]["rows"]["active"], name)
    assert ts.stark.newton.live_contact_pairs() == sum(
        int(cnt_j[s]) for s in teng._blocks())


# ---------------------------------------------------------------------------
# whole staged steps with contact and friction
# ---------------------------------------------------------------------------
def _friction_box(pkg, n, mu=1.0):
    """bench.py's spinning_box_cloth at n x n with Coulomb friction mu
    between the cloth and the box and of the cloth with itself, f64."""
    P = import_module(pkg.__name__ + ".presets.presets")
    C = import_module(pkg.__name__ + ".models.interactions.contact")
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (n, n), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    if mu > 0.0:
        cloth.contact.set_friction(box.contact, mu)
        cloth.contact.set_friction(cloth.contact, mu)
    sim.add_time_event(0.0, 10.0, lambda t: fix.set_transformation(
        [0.0, 0.0, -0.08 - 0.1 * math.sin(t)], angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0]))
    return sim, cloth


def _track(n, steps, bound, same_live=True):
    """Both staged solvers on the friction box, step by step: equal Newton
    and line-search counts, cloth within `bound` m, the same stiffness, and
    with same_live the same live contact pairs; returns the port's live
    contact pairs and friction rows per step."""
    js, jc = _friction_box(stark_tpu, n)
    ts, tc = _friction_box(stark_tpu_torch, n)
    live, fric = [], []
    for step in range(steps):
        assert js.run_one_time_step()
        assert ts.run_one_time_step()
        lj, lt = js.get_logger(), ts.get_logger()
        dev = np.max(np.abs(np.asarray(jc.point_set.get_positions())
                            - tc.point_set.get_positions()))
        print(f"step {step}: newton {lj.series['newton_iterations'][-1]} (JAX) "
              f"{lt.series['newton_iterations'][-1]} (port), deviation {dev:.3e} m, "
              f"live pairs {js.stark.newton.live_contact_pairs()} (JAX) "
              f"{ts.stark.newton.live_contact_pairs()} (port)")
        for key in ("newton_iterations", "ls_inv", "ls_bt"):
            assert lt.series[key] == lj.series[key], (step, key)
        assert dev < bound, f"step {step}: deviation {dev:.3e}"
        assert abs(ts.interactions.contact.contact_stiffness
                   - js.interactions.contact.contact_stiffness) < 1e-9
        live.append(ts.stark.newton.live_contact_pairs())
        if same_live:
            assert live[-1] == js.stark.newton.live_contact_pairs(), step
        fric.append(ts.stark.newton.friction_rows())
    assert not ts.stark.newton._fused_eligible()
    return live, fric


def test_staged_friction_box_tracks_stark_tpu(staged):
    """A 3x3 cloth onto the spinning box with friction mu = 1 through both
    staged solvers, f64, five steps (contact from step 2, friction rows from
    step 3): equal Newton and line-search counts, within 1e-10 m (the
    capacity-padded contact and friction rows count as in JAX: without
    them the two part by 1e-8 m)."""
    live, fric = _track(3, 5, 1e-10)
    assert live[0] == 0 and max(live) > 0
    assert fric[0] == 0 and fric[-1] > 0


@pytest.mark.slow
def test_staged_spinning_box_cloth_8_friction_tracks_stark_tpu(staged):
    """bench.py's scene at 8x8 with mu = 1 through both staged solvers, f64,
    seven steps through first contact: equal Newton and line-search counts,
    within 1e-6 m. The live pair counts are not compared: at the end of
    step 0 two edges of one cloth row, 5 cm apart and nearly collinear
    (sin^2 above the f64 parallel cutoff 1e-20, their D = ac - b^2 below
    its own rounding), get JAX's line-line region and a distance near
    zero (XLA:CPU contracts a*c - b*b into an FMA), the port's
    point-point region and 0.05 m (ROADMAP Queue 3 item 1)."""
    live, fric = _track(8, 7, 1e-6, same_live=False)
    assert max(live) > 0 and fric[-1] > 0


def test_live_counts_follow_the_last_solve(staged):
    """live_contact_pairs and friction_rows read the path that solved last:
    with a fused solve's counts still held from before (here a stand-in
    far above any real count), staged steps of the 3x3 friction box report
    the active rows of their own contact and friction tables."""
    ts, _tc = _friction_box(stark_tpu_torch, 3)
    ts.stark._initialize()
    nm = ts.stark.newton
    eng = ts.interactions.contact.engine()
    live, fric = [], []
    for _ in range(4):
        nm._last_counts = {"n_live_pt_dd": 10 ** 6, "f_pt": 10 ** 6}
        assert ts.run_one_time_step()
        assert not nm._fused_eligible()
        live.append(nm.live_contact_pairs())
        fric.append(nm.friction_rows())
        assert live[-1] == sum(int(torch.sum(fd["rows"]["active"] > 0.5))
                               for fd in eng._contact_data.values())
        assert fric[-1] == sum(int(torch.sum(fd["rows"]["active"] > 0.5))
                               for fd in (eng._friction_data or {}).values())
    assert max(live) > 0 and fric[-1] > 0
