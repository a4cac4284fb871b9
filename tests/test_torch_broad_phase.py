"""The port's hash-grid broad phase against `stark_tpu`, and the port's grid
path against its own dense path.

The JAX package's `tests/test_broad_phase.py` checks its grid against its
dense path; this file holds the port to JAX's grid code on the CPU (the
port's kernels K and L take their plain twins here): `grid_candidates`,
`pick_cell_size` and `_rowk_topk` on random inputs, then the contact
engine's grid branches (broad shell mid lists, intersection candidates,
pair tables, friction tables, count keys) on one frozen state, row for row.
Grid and dense modes of the port are compared as pair SETS: the two paths
sum the same rows in another order and orientation, so a Newton solve's
rounding, and with it the trajectory, differs between them (the JAX
package's own trajectory check of this kind fails for that reason; ROADMAP
Queue 3). Inputs are made with numpy from seeds; both packages get them.
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
from stark_tpu.collision import broad_phase as jbp
from stark_tpu.models.interactions.contact_engine import ContactEngine as JEngine
from stark_tpu_torch.collision import broad_phase as tbp
from stark_tpu_torch.ops import rowk_select as trk
from stark_tpu_torch.utils.from_jax import set_contact_state

GEO_TOL = 1e-12
DT = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# grid_candidates, pick_cell_size, _rowk_topk
# ---------------------------------------------------------------------------
def _spheres(seed, Q, T, lo=-1.0, hi=1.0, rq=(0.01, 0.05), rt=(0.01, 0.3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (Q, 3)), rng.uniform(*rq, (Q,)),
            rng.uniform(lo, hi, (T, 3)), rng.uniform(*rt, (T,)))


# (seed, Q, T, centre range, ins_slots, occ_cap, table_size): the shapes of
# tests/test_broad_phase.py's unit test; even Q and T (the median averages
# the middle two); negative cells only; a small table with truncated
# insertions and bucket scans (max_cells > ins, max_occ > occ_cap)
GRID_CASES = [(3, 200, 300, (-1.0, 1.0), 4096, 512, 4096),
              (7, 64, 90, (-3.0, -1.0), 512, 128, 256),
              (11, 151, 97, (-0.5, 0.5), 8, 16, 256)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_candidates_match_jax(case, dtype):
    """The same cell size, candidate grid, validity and maxima as JAX; the
    valid candidates hold every true sphere overlap and no duplicate (when
    nothing was truncated)."""
    seed, Q, T, (lo, hi), ins, occ, tsz = case
    td, jd = DT[dtype]
    qc, qr, tc, tr = _spheres(seed, Q, T, lo, hi)
    hj = jbp.pick_cell_size(jnp.asarray(qr, jd), jnp.asarray(tr, jd))
    tid_j, valid_j, cells_j, occ_j = jbp.grid_candidates(
        jnp.asarray(qc, jd), jnp.asarray(qr, jd), jnp.asarray(tc, jd),
        jnp.asarray(tr, jd), hj, ins, occ, tsz)
    t = [torch.as_tensor(x, dtype=td) for x in (qc, qr, tc, tr)]
    ht = tbp.pick_cell_size(t[1], t[3])
    assert ht.dtype == td and float(ht) == float(hj)
    tid_t, valid_t, cells_t, occ_t = tbp.grid_candidates(*t, ht, ins, occ, tsz)
    np.testing.assert_array_equal(tid_t.numpy(), np.asarray(tid_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert int(cells_t) == int(cells_j) and int(occ_t) == int(occ_j)
    if int(cells_t) > ins or int(occ_t) > occ:
        return
    cand = set()
    for q in range(Q):
        row = tid_t[q][valid_t[q]].tolist()
        assert len(row) == len(set(row)), "duplicate candidates"
        cand.update((q, i) for i in row)
    d = np.linalg.norm(qc[:, None, :] - tc[None, :, :], axis=-1)
    for q, i in zip(*np.nonzero(d <= qr[:, None] + tr[None, :])):
        assert (q, i) in cand, f"missed true overlap ({q},{i})"


@pytest.mark.parametrize("xs", [[1.0, 2.0, 3.0, 10.0], [4.0, 1.0, 9.0], [0.25]])
def test_pick_cell_size_median_matches_jax(xs):
    """jnp.median averages the two middle values of an even-length input
    (torch.median would take the lower one)."""
    j = float(jbp.pick_cell_size(jnp.asarray(xs), jnp.asarray(xs[::-1])))
    t = float(tbp.pick_cell_size(torch.tensor(xs, dtype=torch.float64),
                                 torch.tensor(xs[::-1], dtype=torch.float64)))
    assert t == j
    assert tbp.pick_cell_size(torch.zeros(0, dtype=torch.float64),
                              torch.tensor(xs, dtype=torch.float64)) == \
        float(jbp.pick_cell_size(jnp.zeros(0), jnp.asarray(xs)))


@pytest.mark.parametrize("Nq,M,K,p", [(40, 300, 16, 0.3),   # rows over K
                                      (25, 10, 64, 0.5),    # K > M
                                      (12, 0, 16, 0.5),     # empty M
                                      (0, 30, 16, 0.5)])
def test_rowk_topk_matches_jax(Nq, M, K, p):
    """The K smallest ids of each row's true entries, padded with nt, and
    the largest row count, as JAX's top_k on the f32 key nt - tid."""
    rng = np.random.default_rng(Nq * 1000 + M)
    mask = rng.random((Nq, M)) < p
    nt = M + 7
    tids = np.asarray([rng.permutation(nt)[:M] for _ in range(Nq)],
                      dtype=np.int32).reshape(Nq, M)
    tid_j, row_j = JEngine._rowk_topk(jnp.asarray(mask), jnp.asarray(tids), K, nt)
    tid_t, row_t = trk.rowk_topk_plain(torch.as_tensor(mask), torch.as_tensor(tids),
                                       K, nt)
    assert tid_t.dtype == torch.int32 and tid_t.shape == (Nq, K)
    np.testing.assert_array_equal(tid_t.numpy(), np.asarray(tid_j))
    assert int(row_t) == int(row_j)


# ---------------------------------------------------------------------------
# the contact engine's grid branches on one frozen state
# ---------------------------------------------------------------------------
def _contact_mods(pkg):
    return (import_module(pkg.__name__ + ".presets.presets"),
            import_module(pkg.__name__ + ".models.interactions.contact"))


def _box_under_cloth(pkg, broad_phase):
    """tests/test_torch_contact.py's frozen scene: a 6x6 cloth 3 mm above a
    box turned 30 degrees, in the given broad-phase mode."""
    P, C = _contact_mods(pkg)
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
        "cloth", (0.1, 0.1), (6, 6), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_rotation(30.0, [0.0, 0.0, 1.0])
    box.rigidbody.add_translation([0.01, -0.005, -0.043])
    sim.stark._initialize()
    return sim


def _frozen_u(n_blocks):
    return np.random.default_rng(21).normal(0.0, 0.02, (n_blocks, 3))


SLACKS = [(0.02, 0.002), (0.0, 0.002)]


@pytest.fixture(scope="module")
def grid_pair():
    """JAX and port engines in "grid" mode at one frozen state, and JAX's
    grid-path results there. JAX's calls are jitted: eagerly, its grid path
    compiles op by op for minutes."""
    js = _box_under_cloth(stark_tpu, "grid")
    ts = _box_under_cloth(stark_tpu_torch, "grid")
    jeng = js.interactions.contact._engine
    teng = ts.interactions.contact.engine()
    u = _frozen_u(js.stark.newton.n_blocks)
    dt = 1.0 / 30.0
    jV = jeng.world_from_u(jnp.asarray(u), jeng.engine_state(), jnp.asarray(dt))
    tV = teng.world_from_u(torch.as_tensor(u), teng.engine_state(),
                           torch.as_tensor(dt, dtype=torch.float64))
    jth = jeng._th_vec()
    mu = jnp.asarray([[0.0, 0.6], [0.6, 0.4]])
    k = 1e6
    broad = jax.jit(jeng.broad_fn)
    pairs = jax.jit(jeng.pairs_fn)
    hit = jax.jit(jeng._isect_exact)
    res = {}
    for sb, sp in SLACKS:
        mc, ic, cnt = broad(*jV, jth, sb, sp)
        res[sb] = (mc, ic, cnt, pairs(*jV, jth, mc, sp), bool(hit(*jV, ic)))
    fric = jax.jit(jeng.friction_tables)(*jV, jth, mu, k)
    jc = js.interactions.contact
    set_contact_state(ts.interactions.contact, jc.contact_thicknesses,
                      jc.contact_stiffness, caps=dict(jeng._caps))
    return dict(jeng=jeng, teng=teng, tV=tV, res=res, fric=fric, mu=mu, k=k)


def _eq(t, j, what):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j), err_msg=what)


def _counts_equal(cnt_t, cnt_j):
    assert sorted(cnt_t) == sorted(cnt_j)
    for k in cnt_j:
        assert int(cnt_t[k]) == int(cnt_j[k]), k


def _tables_equal(tab_t, tab_j, tol=0.0):
    """Live rows equal (floats within tol relative, ints exactly); the
    padding past the count is inactive in both and is not compared."""
    assert sorted(tab_t) == sorted(tab_j)
    for name, fd_j in tab_j.items():
        fd_t = tab_t[name]
        act = np.asarray(fd_j["rows"]["active"]) > 0.5
        _eq(fd_t["rows"]["active"], fd_j["rows"]["active"], name + " active")
        _eq(fd_t["conn"][act], np.asarray(fd_j["conn"])[act], name + " conn")
        assert sorted(fd_t["rows"]) == sorted(fd_j["rows"]), name
        for r, v in fd_j["rows"].items():
            v = np.asarray(v)[act]
            w = fd_t["rows"][r].numpy()[act]
            if np.issubdtype(v.dtype, np.integer) or tol == 0.0:
                np.testing.assert_array_equal(w, v, f"{name} {r}")
            elif v.size:
                assert _rel(w, v) < tol, f"{name} {r}"


@pytest.mark.parametrize("slack_b,slack_p", SLACKS)
def test_grid_broad_shell_matches_jax(grid_pair, slack_b, slack_p):
    """broad_fn on the grid (every stem and every intersection block on the
    hash grid): the same per-stem mid segments in global ids, the same
    intersection candidates, every count key with the same value; then
    pairs_fn's family tables row for row."""
    g = grid_pair
    teng, (tVs, tVr) = g["teng"], g["tV"]
    mc_j, ic_j, cnt_j, (tab_j, pcnt_j), hit_j = g["res"][slack_b]
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)
    th = teng.th_vec()
    mc_t, ic_t, cnt_t = teng.broad_fn(tVs, tVr, th, f64(slack_b), f64(slack_p))
    assert not teng.dense_pt and not teng.dense_ee and not teng.dense_et
    _counts_equal(cnt_t, cnt_j)
    assert list(teng.broad_count_keys()) == list(g["jeng"].broad_count_keys())
    assert any(k.startswith("g_") for k in cnt_t)
    assert int(cnt_j["m_pt_dr"]) > 0 and int(cnt_j["m_ee_dr"]) > 0
    for kind in ("pt", "ee"):
        for x, y, what in zip(mc_t[kind], mc_j[kind], ("q", "t", "act")):
            _eq(x, y, f"mid {kind} {what}")
    for x, y, what in zip(ic_t["et"], ic_j["et"], ("e", "t", "act", "overflow")):
        _eq(x, y, f"isect {what}")
    # an overflowed capacity reports a hit (JAX's capacities are small here)
    assert bool(teng.isect_hit(tVs, tVr, ic_t)) == hit_j
    tab_t, pcnt_t = teng.pairs_fn(tVs, tVr, th, mc_t, f64(slack_p))
    _counts_equal(pcnt_t, pcnt_j)
    assert int(pcnt_j["pt_dr"]) > 0 and int(pcnt_j["ee_dr"]) > 0
    _tables_equal(tab_t, tab_j)


def test_grid_friction_tables_match_jax(grid_pair):
    """friction_tables' per-stem branch (stage 1 under cf_ capacities with
    mu in the predicate, stage 2 under f_, kernel J's rows): the same
    families, rows and counts (cf_, f_, g_), anchors and bases to 1e-12."""
    g = grid_pair
    teng, (tVs, tVr) = g["teng"], g["tV"]
    tab_j, cnt_j = g["fric"]
    tab_t, cnt_t = teng.friction_tables(tVs, tVr, teng.th_vec(),
                                        torch.as_tensor(np.array(g["mu"])),
                                        torch.tensor(g["k"], dtype=torch.float64))
    _counts_equal(cnt_t, cnt_j)
    assert list(teng.friction_count_keys()) == list(g["jeng"].friction_count_keys())
    assert int(cnt_j["f_pt_dr"]) > 0
    _tables_equal(tab_t, tab_j, tol=GEO_TOL)


def _family_sets(tables):
    out = {}
    for name, fd in tables.items():
        act = fd["rows"]["active"].numpy() > 0.5
        out[name] = set(map(tuple, fd["conn"].numpy()[act].tolist()))
    return out


def _pair_sets(eng, Vs, Vr, slack_b=0.02, slack_p=0.002):
    """Both shells and the oracle at (Vs, Vr), rebuilt with bumped
    capacities until no list overflows (as the solve does): the family pair
    sets and the intersection verdict."""
    f64 = lambda x: torch.as_tensor(x, dtype=Vs.dtype)
    th = eng.th_vec()
    while True:
        mc, ic, cnt = eng.broad_fn(Vs, Vr, th, f64(slack_b), f64(slack_p))
        tables, pcnt = eng.pairs_fn(Vs, Vr, th, mc, f64(slack_p))
        cnt.update(pcnt)
        keys = sorted(cnt)
        if not eng._check_overflow(keys, [int(cnt[k]) for k in keys]):
            return _family_sets(tables), bool(eng.isect_hit(Vs, Vr, ic))


def test_grid_and_dense_pair_sets_agree_on_a_frozen_state():
    """The port's grid and dense modes at one state: the same family pair
    sets (the ee_dr rows hold the same pairs; the grid queries rigid edges,
    the dense path soft edges first) and the same intersection verdict."""
    grid = _box_under_cloth(stark_tpu_torch, "grid").interactions.contact.engine()
    dense = _box_under_cloth(stark_tpu_torch, "dense").interactions.contact.engine()
    assert grid.d_pt_allowed is None and dense.d_pt_allowed is not None
    u = torch.as_tensor(_frozen_u(grid.layout.n_blocks))
    dt = torch.as_tensor(1.0 / 30.0, dtype=torch.float64)
    Vs, Vr = dense.world_from_u(u, dense.engine_state(), dt)
    for slack_b in (0.02, 0.0):
        sets_g, hit_g = _pair_sets(grid, Vs, Vr, slack_b)
        sets_d, hit_d = _pair_sets(dense, Vs, Vr, slack_b)
        assert sets_g == sets_d
        assert hit_g == hit_d is False
        assert sum(len(v) for v in sets_g.values()) > 0


# ---------------------------------------------------------------------------
# the port's grid and dense modes along a trajectory (the JAX package's
# tests/test_broad_phase.py, on the port; slow like it: a minute each)
# ---------------------------------------------------------------------------
def _drop_scene(broad_phase):
    """tests/test_broad_phase.py's scene: a 6x6 cloth falling on a fixed
    box 1 mm below it, 4 mm contact thickness."""
    P, C = _contact_mods(stark_tpu_torch)
    s = stark_tpu_torch.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = "cpu"
    s.device.dtype = "float64"
    sim = stark_tpu_torch.Simulation(s)
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.004
    sim.interactions.contact.set_global_params(gp)
    sim.interactions.contact.broad_phase = broad_phase
    sim.presets.deformables.add_surface_grid(
        "cloth", (0.3, 0.3), (6, 6), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.041])
    sim.rigidbodies.add_constraint_fix(box.rigidbody)
    return sim


def _state_world(sim):
    eng = sim.interactions.contact.engine()
    u = sim.stark._connector["get_dofs"]()
    dt = torch.as_tensor(sim.stark.dt, dtype=torch.float64)
    return eng.world_from_u(u, eng.engine_state(), dt)


@pytest.mark.slow
def test_grid_matches_dense_pairs():
    """Six steps of the falling cloth in each mode. At every step's end
    state of the dense run, the grid engine's and the dense engine's family
    pair sets are equal. The DOF deviation between the two runs is printed,
    not bounded: it is rounding, amplified by Newton's exit tests (ROADMAP
    Queue 3)."""
    sim_d, sim_g = _drop_scene("dense"), _drop_scene("grid")
    devs = []
    for _ in range(6):
        assert sim_d.run_one_time_step() and sim_g.run_one_time_step()
        Vs, Vr = _state_world(sim_d)
        sets_d, hit_d = _pair_sets(sim_d.interactions.contact.engine(), Vs, Vr)
        sets_g, hit_g = _pair_sets(sim_g.interactions.contact.engine(), Vs, Vr)
        assert sets_g == sets_d and hit_g == hit_d
        xd = sim_d.stark._connector["get_dofs"]().numpy()
        xg = sim_g.stark._connector["get_dofs"]().numpy()
        devs.append(float(np.max(np.abs(xd - xg))))
    assert sum(len(v) for v in sets_d.values()) > 0, "no contact pairs formed"
    assert np.all(np.isfinite(devs))
    print("max |DOF_dense - DOF_grid| per step:", devs)


@pytest.mark.slow
def test_grid_intersection_oracle_matches():
    """has_intersection on the two modes' end states after six steps, and
    each engine's verdict on the other's state."""
    sims = {m: _drop_scene(m) for m in ("dense", "grid")}
    for sim in sims.values():
        for _ in range(6):
            assert sim.run_one_time_step()
    engs = {m: s.interactions.contact.engine() for m, s in sims.items()}
    verdicts = {m: e.has_intersection(sims[m].stark.dt) for m, e in engs.items()}
    assert verdicts["dense"] == verdicts["grid"]
    zero = torch.zeros((), dtype=torch.float64)
    for m, sim in sims.items():
        Vs, Vr = _state_world(sim)
        hits = [bool(e.isect_hit(Vs, Vr, e._isect_stage1(Vs, Vr, zero)[0]))
                for e in engs.values()]
        assert hits[0] == hits[1] == verdicts[m]


# ---------------------------------------------------------------------------
# the slice: bench.py's spinning box in grid mode through first contact
# ---------------------------------------------------------------------------
def _sbc8(pkg, broad_phase):
    """The 8x8 spinning_box_cloth (bench.py's scene) in one package, f64,
    CPU, in the given broad-phase mode: (sim, cloth, box fix)."""
    P, C = _contact_mods(pkg)
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
    sim.interactions.contact.broad_phase = broad_phase
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.4, 0.4), (8, 8), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_translation([0.0, 0.0, -0.08])
    fix = sim.rigidbodies.add_constraint_fix(box.rigidbody)
    return sim, cloth, fix


def _sbc8_step(sim, cloth, fix):
    """One time step of the spinning box: (cloth positions, solver code,
    Newton iterations)."""
    t = sim.get_time()
    fix.set_transformation([0.0, 0.0, -0.08 - 0.1 * math.sin(t)],
                           angle_deg=90.0 * t, axis=[0.0, 0.0, 1.0])
    assert sim.run_one_time_step()
    lg = sim.get_logger()
    return (np.asarray(cloth.point_set.get_positions()),
            lg.series["solver_code"][-1], lg.series["newton_iterations"][-1])


@pytest.mark.slow
def test_spinning_box_cloth_8_grid_tracks_stark_tpu():
    """An 8x8 spinning_box_cloth with broad_phase="grid" in both packages
    (f64, CPU) through first contact: equal solver codes and Newton counts,
    vertices within 1e-6 m. (JAX's first grid-mode step compiles for
    minutes, hence the slow tier; the frozen-state tests above keep the
    default tier's coverage.)"""
    sims = [_sbc8(pkg, "grid") for pkg in (stark_tpu, stark_tpu_torch)]
    live, devs = 0, []
    for step in range(6):
        (xj, cj, nj), (xt, ct, nt) = [_sbc8_step(*e) for e in sims]
        assert ct == cj and nt == nj, step
        devs.append(float(np.max(np.linalg.norm(xt - xj, axis=1))))
        assert devs[-1] < 1e-6, step
        live = max(live, sims[1][0].stark.newton.live_contact_pairs())
    print("max vertex deviation per step:", devs, "live pairs:", live)
    assert live > 0, "no contact within the window"
    assert any(k.startswith("g_") for k in sims[1][0].stark.newton._last_counts)


# the per-stem path's broad-slack cap, 4 dhat at the 2 mm thickness
# (stark_tpu/solver/newton.py:300-303)
GRID_SLACK_CAP = 4.0 * (2.0 * 0.002)


@pytest.mark.slow
def test_spinning_box_cloth_8_dense_under_the_grid_cap_gives_grid(monkeypatch):
    """Each package's dense path, run under the per-stem path's broad-slack
    cap, gives that package's grid trajectory through first contact (f64,
    CPU): equal solver codes and Newton counts, vertices within 1e-9 m
    (the two modes sum the contact rows in other orders: 1.4e-10 m in the
    JAX package at step 3). So what parts the two packages at first contact in
    test_spinning_box_cloth_8_grid_tracks_stark_tpu is not a grid list:
    their dense paths under that cap part the same way (printed; ROADMAP
    Queue 3)."""
    from stark_tpu.solver.newton import NewtonsMethod as JNewton
    from stark_tpu_torch.solver.newton import NewtonsMethod as TNewton

    build_j, params_t = JNewton._build_fused, TNewton._engine_params

    def capped_build(self):
        build_j(self)
        fused = self._fused_jit

        def call(u0, data, friction, glob, eng_state, dhat, params, M):
            params = dict(params, slack_broad_max=jnp.asarray(
                GRID_SLACK_CAP, params["slack_broad_max"].dtype))
            return fused(u0, data, friction, glob, eng_state, dhat, params, M)
        self._fused_jit = call

    def capped_params(self, engine, dtype):
        return dict(params_t(self, engine, dtype), slack_broad_max=torch.as_tensor(
            GRID_SLACK_CAP, dtype=dtype, device=self.device))

    monkeypatch.setattr(JNewton, "_build_fused", capped_build)
    monkeypatch.setattr(TNewton, "_engine_params", capped_params)
    runs = {(pkg.__name__, mode): _sbc8(pkg, mode)
            for pkg in (stark_tpu, stark_tpu_torch) for mode in ("dense", "grid")}
    newton = {k: [] for k in runs}
    across, modes = [], {"stark_tpu": [], "stark_tpu_torch": []}
    for step in range(4):
        out = {k: _sbc8_step(*e) for k, e in runs.items()}
        for pkg in ("stark_tpu", "stark_tpu_torch"):
            (xd, cd, nd), (xg, cg, ng) = out[(pkg, "dense")], out[(pkg, "grid")]
            assert (cd, nd) == (cg, ng), (pkg, step)
            modes[pkg].append(float(np.max(np.abs(xd - xg))))
            assert modes[pkg][-1] <= 1e-9, (pkg, step)
        for k, o in out.items():
            newton[k].append(int(o[2]))
        across.append(float(np.max(np.abs(out[("stark_tpu", "dense")][0]
                                          - out[("stark_tpu_torch", "dense")][0]))))
    assert runs[("stark_tpu_torch", "dense")][0].stark.newton.live_contact_pairs() > 0
    print("Newton per step:", newton)
    print("max |x_dense - x_grid| per step:", modes)
    print("max |x_stark_tpu - x_port| per step, dense under the grid cap:", across)
