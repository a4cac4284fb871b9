"""The port's IPC contact barriers against `stark_tpu` (friction:
tests/test_torch_friction*.py).

Kernel twins first (compaction, PT / EE distances, segment-triangle
intersection), then the contact engine's lists and pair tables on one frozen
state of a small box-and-cloth scene, the 7 contact families' energies and
derivatives, and the contact scenes of tests/test_contact.py run through
the port (the whole slice, bench.py's spinning box, is in
tests/test_torch_spinning_box.py). All of it runs on the CPU, where the port's kernels take their plain twins; both
packages get the same inputs, made from a seed with numpy.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, hessian, vmap

import stark_tpu
import stark_tpu_torch
from stark_tpu.collision import narrow_phase as jnph
from stark_tpu.ops.compaction import compact_indices
from stark_tpu_torch.collision import narrow_phase as tnph
from stark_tpu_torch.ops import compact as tcp
from stark_tpu_torch.ops import narrow as tnw
from stark_tpu_torch.ops import segment_triangle as tst
from stark_tpu_torch.utils.from_jax import (set_contact_state, set_rigid_state,
                                            tables_from_numpy)

RTOL = 1e-10
DT = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# kernel E: compaction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,cap,p", [(0, 16, 0.5), (1, 4, 1.0), (1000, 64, 0.3),
                                     (1000, 2000, 0.3), (5003, 8192, 0.02),
                                     (20000, 300, 0.5)])
def test_compact_matches_jax(n, cap, p):
    """The same ascending zero-padded buffer and total count as the JAX
    trie (n not a multiple of 128, n = 0, count above cap)."""
    mask = np.random.default_rng(n + cap).random(n) < p
    idx_j, cnt_j = compact_indices(jnp.asarray(mask), cap)
    idx_t, cnt_t = tcp.compact(torch.as_tensor(mask), cap, "test")
    assert idx_t.dtype == torch.int32 and idx_t.shape == (cap,)
    assert int(cnt_t) == int(cnt_j) == int(mask.sum())
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


# ---------------------------------------------------------------------------
# kernels G and H: the narrow phase
# ---------------------------------------------------------------------------
def _geometry(seed, n_rows=3000):
    """Vertices, triangles, edges and candidate rows with the degenerate
    cases: near-coincident vertices, zero-length edges, parallel edge pairs,
    degenerate triangles and padded rows (index 0, inactive)."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(300, 3))
    V[150:170] = V[130:150] + 1e-9
    tris = rng.integers(0, 300, size=(200, 3))
    tris[:10, 2] = tris[:10, 1]                     # degenerate triangles
    edges = rng.integers(0, 300, size=(250, 2))
    edges[:15, 1] = edges[:15, 0]                   # zero-length edges
    V[edges[15:30, 1]] = V[edges[15:30, 0]] + 0.5 * (V[edges[30:45, 1]]
                                                     - V[edges[30:45, 0]])
    q = rng.integers(0, 300, size=n_rows)
    t = rng.integers(0, 200, size=n_rows)
    a = rng.integers(0, 250, size=n_rows)
    b = rng.integers(0, 250, size=n_rows)
    a[:150] = np.arange(15, 30).repeat(10)          # parallel pairs
    b[:150] = np.arange(30, 45).repeat(10)
    q[-100:] = t[-100:] = a[-100:] = b[-100:] = 0   # padded rows
    return V, tris, edges, q, t, a, b


def _pt_jax(V, tris, q, t, dtype):
    Vj = jnp.asarray(V, dtype)
    tq = tris[t]
    return np.asarray(jax.vmap(jnph.point_triangle_distance)(
        Vj[q], Vj[tq[:, 0]], Vj[tq[:, 1]], Vj[tq[:, 2]]))


def _ee_jax(V, edges, a, b, dtype):
    Vj = jnp.asarray(V, dtype)
    ea, eb = edges[a], edges[b]
    return np.asarray(jax.vmap(jnph.edge_edge_distance)(
        Vj[ea[:, 0]], Vj[ea[:, 1]], Vj[eb[:, 0]], Vj[eb[:, 1]]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pt_ee_distance_matches_jax(dtype):
    """Kernel G's twin: the same region logic and guards as the JAX narrow
    phase. f64 to 1e-12; f32 within 64 eps of the coordinate scale, and 8
    sqrt(eps) on the EE rows within a factor of the parallel cutoff, where
    the line-line formula cancels."""
    td, jd = DT[dtype]
    V, tris, edges, q, t, a, b = _geometry(11)
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)
    Vt = torch.as_tensor(V, dtype=td)
    d_pt, _ = tnw.pt_distance(Vt, Vt, i32(tris), i32(q), i32(t))
    d_ee, _ = tnw.ee_distance(Vt, i32(edges), i32(a), i32(b))
    ref_pt = _pt_jax(V, tris, q, t, jd)
    ref_ee = _ee_jax(V, edges, a, b, jd)
    scale = 1.0 + np.max(np.abs(V))
    if dtype == "float64":
        tol_pt = tol_ee = 1e-12 * scale
    else:
        eps = float(np.finfo(np.float32).eps)
        near = tnw.ee_near_cutoff(Vt, i32(edges), i32(a), i32(b)).numpy()
        tol_pt = 64 * eps * scale
        tol_ee = np.where(near, 8 * eps ** 0.5 * scale, tol_pt)
    assert np.max(np.abs(d_pt.numpy() - ref_pt)) <= tol_pt
    assert np.all(np.abs(d_ee.numpy() - ref_ee) <= tol_ee)
    # the keep mask is the same comparison on the same distances
    bound = torch.as_tensor(np.random.default_rng(1).random(len(q)), dtype=td)
    act = torch.as_tensor(np.arange(len(q)) < len(q) - 100)
    _d, keep = tnw.pt_distance(Vt, Vt, i32(tris), i32(q), i32(t), act, None, bound)
    assert torch.equal(keep, act & (d_pt <= bound))


def _st_margin(V, edges, tris, e, t):
    """Distance in f64 of each row's Moller-Trumbore parameters from the
    inclusive boundary (small: the verdict may round either way)."""
    p0, p1 = V[edges[e, 0]], V[edges[e, 1]]
    t0, t1, t2 = V[tris[t, 0]], V[tris[t, 1]], V[tris[t, 2]]
    d, e1, e2 = p1 - p0, t1 - t0, t2 - t0
    h = np.cross(d, e2)
    a = np.sum(e1 * h, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / a
        s = p0 - t0
        u = f * np.sum(s * h, -1)
        qv = np.cross(s, e1)
        v = f * np.sum(d * qv, -1)
        tt = f * np.sum(e2 * qv, -1)
        m = np.min(np.abs(np.stack([u, v, 1 - u - v, tt, 1 - tt])), axis=0)
        par = np.abs(a * a / np.maximum(np.sum(e1 * e1, -1) * np.sum(h * h, -1),
                                        1e-300))
    return np.where(np.isfinite(m), m, 0.0), par


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_segment_triangle_matches_jax(dtype):
    """Kernel H's twin: the per-row verdicts equal JAX's (f32: on the rows
    whose parameters are not within 1e-3 of the inclusive boundary or of
    the parallel cutoff), and the any-hit reduction with its overflow flag.
    Rows sharing a vertex touch exactly on the boundary; the engine's
    allowed mask drops them, and so does this test."""
    td, jd = DT[dtype]
    V, tris, edges, _q, t, a, _b = _geometry(12)
    keep = ~(edges[a][:, :, None] == tris[t][:, None, :]).any(-1).any(-1)
    a, t = a[keep], t[keep]
    Vt = torch.as_tensor(V, dtype=td)
    ea, tt = edges[a], tris[t]
    hit_t = tnph.segment_triangle_intersects(
        Vt[ea[:, 0]], Vt[ea[:, 1]], Vt[tt[:, 0]], Vt[tt[:, 1]], Vt[tt[:, 2]]).numpy()
    Vj = jnp.asarray(V, jd)
    hit_j = np.asarray(jax.vmap(jnph.segment_triangle_intersects)(
        Vj[ea[:, 0]], Vj[ea[:, 1]], Vj[tt[:, 0]], Vj[tt[:, 1]], Vj[tt[:, 2]]))
    assert hit_j.sum() > 10
    if dtype == "float64":
        np.testing.assert_array_equal(hit_t, hit_j)
    else:
        m, par = _st_margin(V, edges, tris, a, t)
        robust = (m > 1e-3) & (np.abs(par - 1e-4) > 1e-5)
        assert robust.mean() > 0.75
        np.testing.assert_array_equal(hit_t[robust], hit_j[robust])
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)
    no, yes = torch.zeros((), dtype=torch.bool), torch.ones((), dtype=torch.bool)
    hits = torch.as_tensor(hit_t)
    for act, ovf, want in ((torch.ones_like(hits), no, True), (~hits, no, False),
                           (~hits, yes, True), (torch.zeros_like(hits), no, False)):
        out = tst.segment_triangle_any(Vt, i32(edges), i32(tris), i32(a), i32(t),
                                       act, ovf)
        assert out.dtype == torch.bool and bool(out) == want


def test_narrow_phase_hessians_stay_finite():
    """torch.func Hessians through the one-hot region select stay finite on
    every region and on the degenerate rows (the unselected formulas'
    guards), as the barrier energies need."""
    V, tris, edges, q, t, a, b = _geometry(13, n_rows=400)
    Vt = torch.as_tensor(V)
    X = torch.stack([Vt[q], Vt[tris[t, 0]], Vt[tris[t, 1]], Vt[tris[t, 2]]], 1)
    H = vmap(hessian(lambda x: tnph.point_triangle_distance(x[0], x[1], x[2], x[3])))(X)
    assert torch.all(torch.isfinite(H))
    Y = torch.stack([Vt[edges[a, 0]], Vt[edges[a, 1]], Vt[edges[b, 0]], Vt[edges[b, 1]]], 1)
    H = vmap(hessian(lambda y: tnph.edge_edge_distance(y[0], y[1], y[2], y[3])))(Y)
    assert torch.all(torch.isfinite(H))
    regions = tnph.point_triangle_region(X[:, 0], X[:, 1], X[:, 2], X[:, 3])
    assert len(torch.unique(regions)) == 7


# ---------------------------------------------------------------------------
# the contact engine on one frozen state
# ---------------------------------------------------------------------------
def _contact_mods(pkg):
    return (import_module(pkg.__name__ + ".presets.presets"),
            import_module(pkg.__name__ + ".models.interactions.contact"))


def _settings(pkg, cpu, dtype="float64", dt=1 / 30):
    s = pkg.Settings()
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = dtype
    s.simulation.max_time_step_size = dt
    if cpu:
        s.device.device = "cpu"
    return s


def _box_under_cloth(pkg, cpu):
    """A 6x6 cloth 3 mm above the top of a box turned 30 degrees: PT and EE
    pairs of both kinds within the contact distance."""
    P, C = _contact_mods(pkg)
    sim = pkg.Simulation(_settings(pkg, cpu))
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.1, 0.1), (6, 6), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_rotation(30.0, [0.0, 0.0, 1.0])
    box.rigidbody.add_translation([0.01, -0.005, -0.043])
    sim.stark._initialize()
    return sim


def _frozen_engines():
    js = _box_under_cloth(stark_tpu, False)
    ts = _box_under_cloth(stark_tpu_torch, True)
    jeng = js.interactions.contact._engine
    teng = ts.interactions.contact.engine()
    u = np.random.default_rng(21).normal(0.0, 0.02, (js.stark.newton.n_blocks, 3))
    dt = 1.0 / 30.0
    jV = jeng.world_from_u(jnp.asarray(u), jeng.engine_state(), jnp.asarray(dt))
    tV = teng.world_from_u(torch.as_tensor(u), teng.engine_state(),
                           torch.as_tensor(dt, dtype=torch.float64))
    for a, b in zip(jV, tV):
        assert _rel(b, a) < 1e-15
    return js, ts, jeng, teng, jV, tV


def _eq(t, j, what):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j), err_msg=what)


def test_engine_lists_and_tables_match_jax():
    """_ball_wide, broad_fn (mid lists, intersection candidates) and
    pairs_fn (the family pair tables) on one frozen state: the same rows in
    the same order, and the same counts. The port starts from the JAX
    engine's capacities (utils/from_jax.set_contact_state)."""
    js, ts, jeng, teng, (jVs, jVr), (tVs, tVr) = _frozen_engines()
    jth = jeng._th_vec()
    tth = teng.th_vec()
    slack_b, slack_p = 0.02, 0.002
    mc_j, ic_j, cnt_j = jeng.broad_fn(jVs, jVr, jth, slack_b, slack_p)
    tables_j, pcnt_j = jeng.pairs_fn(jVs, jVr, jth, mc_j, slack_p)
    jc = js.interactions.contact
    set_contact_state(ts.interactions.contact, jc.contact_thicknesses,
                      jc.contact_stiffness, caps=dict(jeng._caps))
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)

    # _ball_wide on the PT balls
    Vcat_j, Vcat_t = jeng._vcat(jVs, jVr), teng._vcat(tVs, tVr)
    c_j, r_j = jeng._tri_balls(Vcat_j)
    c_t, r_t = teng._tri_balls(Vcat_t)
    th_p_j = jth[jnp.asarray(jeng.p_mesh_all)]
    th_t_j = jth[jnp.asarray(jeng.t_mesh_all)]
    th_p_t, th_t_t = tth[teng.d_p_mesh], tth[teng.d_t_mesh]
    extra = slack_b + slack_p + float(jeng._bound_pad(Vcat_j))
    (q_j, t_j, a_j), w_j = jeng._ball_wide("w_pt", Vcat_j, th_p_j, c_j, r_j + th_t_j,
                                           jeng.pt_allowed_dense, extra)
    (q_t, t_t, a_t), w_t = teng._ball_wide("w_pt", Vcat_t, th_p_t, c_t, r_t + th_t_t,
                                           teng.d_pt_allowed, f64(extra))
    assert int(w_t) == int(w_j) > 0
    for x, y, what in ((q_t, q_j, "q"), (t_t, t_j, "t"), (a_t, a_j, "act")):
        _eq(x, y, "w_pt " + what)

    mc_t, ic_t, cnt_t = teng.broad_fn(tVs, tVr, tth, f64(slack_b), f64(slack_p))
    assert sorted(cnt_t) == sorted(cnt_j)
    for k in cnt_j:
        assert int(cnt_t[k]) == int(cnt_j[k]), k
    assert int(cnt_j["m_pt"]) > 0 and int(cnt_j["m_ee"]) > 0
    for kind in ("pt", "ee"):
        for x, y, what in zip(mc_t[kind], mc_j[kind], ("q", "t", "act")):
            _eq(x, y, f"mid {kind} {what}")
    for x, y, what in zip(ic_t["et"], ic_j["et"], ("e", "t", "act", "overflow")):
        _eq(x, y, f"isect {what}")
    hit_j = jeng._isect_exact(jVs, jVr, ic_j)
    assert bool(teng.isect_hit(tVs, tVr, ic_t)) == bool(hit_j) is False

    tables_t, pcnt_t = teng.pairs_fn(tVs, tVr, tth, mc_t, f64(slack_p))
    assert sorted(tables_t) == sorted(tables_j)
    assert {"contact_pt_dd", "contact_pt_dr", "contact_ee_dd",
            "contact_ee_dr"} <= set(tables_t)
    for k in pcnt_j:
        assert int(pcnt_t[k]) == int(pcnt_j[k]), k
    assert int(pcnt_j["pt_dr"]) > 0 and int(pcnt_j["ee_dr"]) > 0
    # the live rows; the padding past the count differs (JAX repeats row 0's
    # pair there, the port writes index 0) and is inactive in both
    for name, fd_j in tables_j.items():
        fd_t = tables_t[name]
        act = np.asarray(fd_j["rows"]["active"]) > 0.5
        _eq(fd_t["rows"]["active"], fd_j["rows"]["active"], name + " active")
        _eq(fd_t["conn"][act], np.asarray(fd_j["conn"])[act], name + " conn")
        assert sorted(fd_t["rows"]) == sorted(fd_j["rows"]), name
        for r, v in fd_j["rows"].items():
            _eq(fd_t["rows"][r][act], np.asarray(v)[act], f"{name} {r}")


def _random_family_rows(rng, n, n_soft, n_bodies):
    """Rows of every contact family over random soft nodes and bodies, with
    dhat above every distance so each barrier is live; some EE rows nearly
    parallel (mollifier below 1) and a quarter of the rows inactive."""
    def locs(k):
        return rng.normal(0.0, 0.05, (n, k, 3))

    def nodes(k):
        return np.stack([rng.choice(n_soft, k, replace=False) for _ in range(n)])

    act = (rng.random(n) < 0.75).astype(np.float64)
    dhat = np.full(n, 0.6)
    body = lambda: rng.integers(0, n_bodies, n)
    rows = {
        "contact_pt_dd": {"nodes": nodes(4)},
        "contact_pt_dr": {"node_p": rng.integers(0, n_soft, n), "body_b": body(),
                          "t_loc": locs(3)},
        "contact_pt_rd": {"body_a": body(), "p_loc": locs(1)[:, 0],
                          "nodes_t": nodes(3)},
        "contact_pt_rr": {"body_a": body(), "p_loc": locs(1)[:, 0],
                          "body_b": body(), "t_loc": locs(3)},
        "contact_ee_dd": {"nodes": nodes(4)},
        "contact_ee_dr": {"body_a": body(), "ea_loc": locs(2), "nodes_b": nodes(2)},
        "contact_ee_rr": {"body_a": body(), "ea_loc": locs(2), "body_b": body(),
                          "eb_loc": locs(2)},
    }
    conn_of = {
        "contact_pt_dd": lambda r: r["nodes"],
        "contact_pt_dr": lambda r: np.stack([r["node_p"], n_soft + 2 * r["body_b"],
                                             n_soft + 2 * r["body_b"] + 1], 1),
        "contact_pt_rd": lambda r: np.concatenate([
            np.stack([n_soft + 2 * r["body_a"], n_soft + 2 * r["body_a"] + 1], 1),
            r["nodes_t"]], 1),
        "contact_pt_rr": lambda r: np.stack([
            n_soft + 2 * r["body_a"], n_soft + 2 * r["body_a"] + 1,
            n_soft + 2 * r["body_b"], n_soft + 2 * r["body_b"] + 1], 1),
        "contact_ee_dd": lambda r: r["nodes"],
        "contact_ee_dr": lambda r: np.concatenate([
            np.stack([n_soft + 2 * r["body_a"], n_soft + 2 * r["body_a"] + 1], 1),
            r["nodes_b"]], 1),
        "contact_ee_rr": lambda r: np.stack([
            n_soft + 2 * r["body_a"], n_soft + 2 * r["body_a"] + 1,
            n_soft + 2 * r["body_b"], n_soft + 2 * r["body_b"] + 1], 1),
    }
    out = {}
    for name, r in rows.items():
        r.update({"active": act, "dhat": dhat})
        out[name] = {"conn": conn_of[name](r), "rows": r}
    return out


def test_contact_families_match_jax():
    """E, g and H of the 7 contact families per element (torch.func against
    JAX autodiff), f64, relative 1e-10, on random rows over random soft and
    rigid states."""
    rng = np.random.default_rng(31)
    n_soft, n_bodies, n = 48, 3, 32
    q0 = rng.normal(size=(n_bodies, 4))
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    x0 = rng.normal(0.0, 0.1, (n_soft, 3))
    u = rng.normal(0.0, 0.3, (n_soft + 2 * n_bodies, 3))
    data = _random_family_rows(rng, n, n_soft, n_bodies)
    # four EE rows whose edge b is a near-parallel copy of edge a (nodes
    # 40-47 follow a's nodes): the mollifier is below 1 there
    ee = data["contact_ee_dd"]
    for i in range(4):
        a0, a1, b0, b1 = 2 * i, 2 * i + 1, 40 + 2 * i, 41 + 2 * i
        x0[b0] = x0[a0] + [0.02, 0.0, 0.01]
        x0[b1] = x0[a1] + [0.02, 0.0, 0.01] + 1e-4 * rng.normal(size=3)
        u[b0], u[b1] = u[a0], u[a1]
        ee["rows"]["nodes"][i] = a0, a1, b0, b1
    ee["conn"] = ee["rows"]["nodes"]
    glob_np = {"x0": x0, "X": x0 + rng.normal(0.0, 0.01, x0.shape),
               "rb_t0": rng.normal(0.0, 0.1, (n_bodies, 3)), "rb_q0": q0,
               "dt": np.asarray(1.0 / 30.0), "contact_k": np.asarray(1e6)}
    jglob = {k: jnp.asarray(v) for k, v in glob_np.items()}
    tglob = {k: torch.as_tensor(v) for k, v in glob_np.items()}
    tdata = tables_from_numpy(data)
    jfam = {f.name: f for f in jax_families()}
    tfam = {f.name: f for f in torch_families()}
    x1 = x0 + glob_np["dt"] * u[:n_soft]
    nd = ee["rows"]["nodes"][:4]
    moll = np.asarray(jax.vmap(jnph.edge_edge_mollifier)(
        *(jnp.asarray(x1[nd[:, k]]) for k in range(4)),
        *(jnp.asarray(glob_np["X"][nd[:, k]]) for k in range(4))))
    assert np.all(moll < 1.0)
    for name in sorted(data):
        fj, ft = jfam[name].energy_fn, tfam[name].energy_fn
        jrows = {k: jnp.asarray(v) for k, v in data[name]["rows"].items()}
        uj = jnp.asarray(u)[jnp.asarray(data[name]["conn"])]
        ut = torch.as_tensor(u)[tdata[name]["conn"]]
        e_j, g_j, H_j = jax.jit(jax.vmap(
            lambda u_e, r, g, f=fj: (f(u_e, r, g), jax.grad(f)(u_e, r, g),
                                     jax.hessian(f)(u_e, r, g)),
            in_axes=(0, 0, None)))(uj, jrows, jglob)
        g_t, e_t = vmap(grad_and_value(ft), in_dims=(0, 0, None))(
            ut, tdata[name]["rows"], tglob)
        H_t = vmap(hessian(ft), in_dims=(0, 0, None))(ut, tdata[name]["rows"], tglob)
        act = data[name]["rows"]["active"] > 0.5
        assert np.all(np.asarray(e_j)[act] > 0.0), name
        assert _rel(e_t.numpy()[act], np.asarray(e_j)[act]) < RTOL, name
        assert _rel(g_t.numpy()[act], np.asarray(g_j)[act]) < RTOL, name
        assert _rel(H_t.numpy()[act], np.asarray(H_j)[act]) < RTOL, name
        assert torch.all(torch.isfinite(H_t)), name


def _families(pkg):
    s = _settings(pkg, pkg is stark_tpu_torch)
    sim = pkg.Simulation(s)
    return [f for f in sim.stark.global_potential.families
            if f.name.startswith("contact_")]


def jax_families():
    return _families(stark_tpu)


def torch_families():
    return _families(stark_tpu_torch)


# ---------------------------------------------------------------------------
# the contact scenes of tests/test_contact.py, through the port
# ---------------------------------------------------------------------------
def _scene_settings(name, dt=1 / 100):
    s = stark_tpu_torch.Settings()
    s.output.simulation_name = name
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.device = "cpu"
    s.simulation.max_time_step_size = dt
    s.newton.residual_tolerance_abs = 1e-5
    return s


def test_fd_contact_energies():
    """Port of tests/test_contact.py::test_fd_contact_energies (its friction
    half is tests/test_torch_friction.py::test_fd_contact_energies_with_
    friction): live PT pairs between two cloths 1.5 mm apart, and the
    gradient of the whole potential against central differences of its
    energy."""
    P, _C = _contact_mods(stark_tpu_torch)
    sim = stark_tpu_torch.Simulation(_scene_settings("fd_contact"))
    p = P.SurfaceParams.Cotton_Fabric()
    sim.interactions.contact.global_params.default_contact_thickness = 0.001
    sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (3, 3), p)
    c2 = sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (3, 3), p)
    pts = c2.point_set
    x = pts.get_positions()
    x[:, 2] += 0.0015
    x[:, 0] += 0.021
    sim._dyn._x0_host[pts.get_begin():pts.get_begin() + pts.size()] = x
    sim.stark._initialize()
    sim.stark.callbacks.run_before_time_step()
    eng = sim.interactions.contact.engine()
    nm = sim.stark.newton
    ev = nm._ev
    dt = torch.as_tensor(sim.stark.dt, dtype=torch.float64)
    rng = np.random.default_rng(3)
    u = sim._get_dofs().numpy() + 0.02 * rng.standard_normal((nm.n_blocks, 3))
    ut = torch.as_tensor(u)
    th = eng.th_vec()
    Vs, Vr = eng.world_from_u(ut, eng.engine_state(), dt)
    slack = torch.as_tensor(0.001, dtype=torch.float64)
    mc, _ic, _cnt = eng.broad_fn(Vs, Vr, th, 4 * slack, slack)
    tables, _cnt = eng.pairs_fn(Vs, Vr, th, mc, slack)
    static = sim._get_static_data()
    data = dict(static)
    data.update(tables)
    assert int(torch.sum(data["contact_pt_dd"]["rows"]["active"] > 0.5)) > 0
    glob = sim._get_glob()
    topo = ev.topology(static, dense=False)
    E, _aux, g, _H = ev.energy_grad_hess(ut, data, glob, topo, ev.egh_csr(data))
    assert np.isfinite(float(E))
    g = g.numpy()
    assert np.all(np.isfinite(g))
    h = 1e-7
    scale = max(1.0, np.max(np.abs(g)))
    for flat in rng.choice(u.shape[0] * 3, size=24, replace=False):
        b, dax = divmod(int(flat), 3)
        up = u.copy()
        up[b, dax] += h
        um = u.copy()
        um[b, dax] -= h
        Ep = float(ev.energy(torch.as_tensor(up), data, glob))
        Em = float(ev.energy(torch.as_tensor(um), data, glob))
        assert abs((Ep - Em) / (2 * h) - g[b, dax]) / scale < 5e-5


def test_cloth_rests_on_rigid_box():
    """Port of tests/test_contact.py::test_cloth_rests_on_rigid_box, at
    1/30 s steps: the cloth lands on the fixed box and rests on its top."""
    P, _C = _contact_mods(stark_tpu_torch)
    sim = stark_tpu_torch.Simulation(_scene_settings("cloth_on_box", dt=1 / 30))
    contact = sim.interactions.contact
    contact.global_params.default_contact_thickness = 0.002
    contact.global_params.min_contact_stiffness = 1e5
    contact.contact_stiffness = 1e5
    box = sim.presets.rigidbodies.add_box("", 1.0, (0.2, 0.2, 0.1))
    sim.rigidbodies.add_constraint_fix(box.rigidbody)
    cloth = sim.presets.deformables.add_surface_grid(
        "", (0.12, 0.12), (4, 4), P.SurfaceParams.Cotton_Fabric())
    pts = cloth.point_set
    x = pts.get_positions()
    x[:, 2] += 0.08
    sim._dyn._x0_host[pts.get_begin():pts.get_begin() + pts.size()] = x
    assert sim.run(duration=0.5)
    xf = pts.get_positions()
    assert np.all(np.isfinite(xf))
    assert np.min(xf[:, 2]) > 0.05 - 0.002, f"cloth fell through: {np.min(xf[:, 2])}"
    assert np.max(xf[:, 2]) < 0.075
    assert sim.stark.newton.live_contact_pairs() > 0


def test_rigid_box_drops_on_fixed_box():
    """Port of tests/test_contact.py::test_rigid_box_drops_on_fixed_box, at
    1/30 s steps: rigid-rigid contact holds the box on the floor."""
    sim = stark_tpu_torch.Simulation(_scene_settings("rr_drop", dt=1 / 30))
    contact = sim.interactions.contact
    contact.global_params.default_contact_thickness = 0.002
    contact.global_params.min_contact_stiffness = 1e5
    contact.contact_stiffness = 1e5
    floor = sim.presets.rigidbodies.add_box("", 10.0, (0.5, 0.5, 0.1))
    sim.rigidbodies.add_constraint_fix(floor.rigidbody)
    box = sim.presets.rigidbodies.add_box("", 1.0, (0.1, 0.1, 0.1))
    box.rigidbody.set_translation([0.0, 0.0, 0.18])
    assert sim.run(duration=0.5)
    t = box.rigidbody.get_translation()
    assert 0.09 < t[2] < 0.12, f"unexpected rest height {t[2]}"


def test_unported_contact_paths_raise():
    """A dense grid over 2^27 pairs (the hash-grid broad phase, P9) raises,
    naming its ROADMAP item. (Friction, P4, is ported:
    tests/test_torch_friction*.py.)"""
    P, C = _contact_mods(stark_tpu_torch)
    from stark_tpu_torch.models.interactions import contact_engine as ce
    old = ce.GRID_PAIR_THRESHOLD
    try:
        ce.GRID_PAIR_THRESHOLD = 10
        sim = stark_tpu_torch.Simulation(_scene_settings("grid"))
        sim.interactions.contact.global_params.default_contact_thickness = 0.001
        sim.presets.deformables.add_surface_grid(
            "", (0.1, 0.1), (2, 2), P.SurfaceParams.Cotton_Fabric())
        with pytest.raises(NotImplementedError, match="P9"):
            sim.run_one_time_step()
    finally:
        ce.GRID_PAIR_THRESHOLD = old


def test_rigid_state_carries_from_jax():
    """utils/from_jax.set_rigid_state gives the port the JAX bodies' state
    (rigid t0, q0, v1, w1), and the world positions follow it."""
    js, ts, jeng, teng, _jV, _tV = _frozen_engines()
    rng = np.random.default_rng(5)
    t0 = rng.normal(size=(1, 3))
    q0 = rng.normal(size=(1, 4))
    q0 /= np.linalg.norm(q0)
    v1, w1 = rng.normal(size=(1, 3)), rng.normal(size=(1, 3))
    js._rb_dyn.t0, js._rb_dyn.q0 = t0.copy(), q0.copy()
    set_rigid_state(ts._rb_dyn, t0, q0, v1, w1)
    np.testing.assert_array_equal(ts._rb_dyn.host_w1(), w1)
    u = np.zeros((ts.stark.newton.n_blocks, 3))
    u[-2:] = np.concatenate([v1, w1])
    dt = 1.0 / 30.0
    _s, jVr = jeng.world_from_u(jnp.asarray(u), jeng.engine_state(), jnp.asarray(dt))
    _s, tVr = teng.world_from_u(torch.as_tensor(u), teng.engine_state(),
                                torch.as_tensor(dt, dtype=torch.float64))
    assert _rel(tVr, jVr) < 1e-14
