"""The port's lagged friction against `stark_tpu`, on the CPU.

The friction geometry twins (closest-point weights, tangent bases, the EE
line parameters) and the barrier's normal force; the seven friction
families' energies and derivatives (C0 and C1); the friction tables the
engine builds (kernels I, E and J take their twins here) on one frozen
cloth-on-box state with cloth self-contact; and the whole potential's
gradient against central differences with friction rows live (the friction
half of tests/test_contact.py::test_fd_contact_energies). The friction
scenes are in tests/test_torch_friction_scenes.py, the slice (bench.py's
spinning box with friction) in tests/test_torch_friction_box.py. Both
packages get the same inputs, made from a seed with numpy, in float64.
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
from stark_tpu.models.interactions import contact_energies as jce
from stark_tpu_torch.collision import narrow_phase as tnph
from stark_tpu_torch.models.interactions import contact_energies as tce
from stark_tpu_torch.ops import friction_pairs as tfp
from stark_tpu_torch.ops import friction_rows as tfr
from stark_tpu_torch.utils.from_jax import set_contact_state, tables_from_numpy

GEO_TOL = 1e-12
FAM_TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# friction geometry
# ---------------------------------------------------------------------------
def _pt_rows(rng, n=600):
    """Random point-triangle rows plus rows placed in every region: the
    point near each vertex, beyond each edge and over the face, exactly on
    a vertex (a zero point-point direction), and straight above a vertex
    (the n_z >= 0.99 axis of the point-point basis)."""
    t0 = rng.normal(size=(n, 3))
    t1 = t0 + rng.normal(size=(n, 3))
    t2 = t0 + rng.normal(size=(n, 3))
    p = rng.normal(size=(n, 3)) * 2.0
    k = n // 8
    w = rng.dirichlet([1.0, 1.0, 1.0], size=k)
    tri = np.stack([t0[:k], t1[:k], t2[:k]], 1)
    p[:k] = np.einsum("ki,kij->kj", w, tri) + 0.1 * rng.normal(size=(k, 3))   # face
    p[k:2 * k] = t1[k:2 * k] + 0.02 * rng.normal(size=(k, 3))                  # vertex
    p[2 * k] = t0[2 * k]                                                       # on t0
    p[2 * k + 1] = t2[2 * k + 1] + np.array([0.0, 0.0, 0.5])                   # above t2
    t0[2 * k + 2:2 * k + 4] = np.array([0.0, 0.0, 0.0])
    t1[2 * k + 2:2 * k + 4] = np.array([1.0, 0.0, 0.0])
    t2[2 * k + 2:2 * k + 4] = np.array([0.0, 1.0, 0.0])
    p[2 * k + 2] = np.array([0.0, 0.0, 0.3])                                   # on t0, +z
    p[2 * k + 3] = np.array([0.5, -0.2, 0.1])                                  # edge t0t1
    return p, t0, t1, t2


def _ee_rows(rng, n=600):
    """Random edge pairs plus every EE region, exactly parallel edges on
    integer coordinates (the degenerate line-line branch), almost parallel
    edges and crossing edges."""
    a0 = rng.normal(size=(n, 3))
    a1 = a0 + rng.normal(size=(n, 3))
    b0 = rng.normal(size=(n, 3))
    b1 = b0 + rng.normal(size=(n, 3))
    k = n // 8
    axis = np.eye(3)[rng.integers(0, 3, k)]
    a0[:k] = rng.integers(-4, 4, (k, 3))
    a1[:k] = a0[:k] + rng.integers(1, 4, (k, 1)) * axis
    b0[:k] = a0[:k] + rng.integers(-2, 3, (k, 3))
    b1[:k] = b0[:k] + rng.integers(-3, 4, (k, 1)) * axis + axis * 0.5         # parallel
    b1[k:2 * k] = b0[k:2 * k] + (a1[k:2 * k] - a0[k:2 * k]) \
        + 1e-9 * rng.normal(size=(k, 3))                                       # nearly
    m = 0.5 * (a0[2 * k:3 * k] + a1[2 * k:3 * k])
    d = rng.normal(size=(k, 3))
    b0[2 * k:3 * k], b1[2 * k:3 * k] = m - d + 0.05, m + d                     # crossing
    return a0, a1, b0, b1


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_point_triangle_friction_geometry_matches_jax():
    """Region, closest-point weights and tangent basis of PT rows against
    the JAX narrow phase, f64, 1e-12 of the coordinate scale; every region
    and the point-point branches are hit."""
    p, t0, t1, t2 = _pt_rows(np.random.default_rng(41))
    reg_j = jax.vmap(jnph.point_triangle_region)(*_j(p, t0, t1, t2))
    bary_j = jax.vmap(jnph.point_triangle_bary)(*_j(p, t0, t1, t2), reg_j)
    T_j = jax.vmap(jnph.point_triangle_T)(*_j(p, t0, t1, t2), reg_j)
    reg_t = tnph.point_triangle_region(*_t(p, t0, t1, t2))
    np.testing.assert_array_equal(reg_t.numpy(), np.asarray(reg_j))
    assert len(np.unique(np.asarray(reg_j))) == 7
    bary_t = tnph.point_triangle_bary(*_t(p, t0, t1, t2), reg_t)
    T_t = tnph.point_triangle_T(*_t(p, t0, t1, t2), reg_t)
    assert _rel(bary_t, bary_j) < GEO_TOL
    assert _rel(T_t, T_j) < GEO_TOL
    assert np.all(np.asarray(T_j)[2 * 75] == 0.0)      # the zero direction's floor


def test_edge_edge_friction_geometry_matches_jax():
    """Region, line parameters (s, t) and tangent basis of EE rows against
    the JAX narrow phase, f64, 1e-12; every region, parallel rows and the
    degenerate line-line branch are hit."""
    a0, a1, b0, b1 = _ee_rows(np.random.default_rng(42))
    reg_j = np.asarray(jax.vmap(jnph.edge_edge_region)(*_j(a0, a1, b0, b1)))
    reg_t = tnph.edge_edge_region(*_t(a0, a1, b0, b1))
    np.testing.assert_array_equal(reg_t.numpy(), reg_j)
    assert len(np.unique(reg_j)) == 9
    # the line-line region at parallel-to-f64 edges: the degenerate branch
    reg = np.where(np.arange(len(reg_j)) < 75, 8, reg_j)
    s_j, t_j = jax.vmap(jnph.edge_edge_params)(*_j(a0, a1, b0, b1), jnp.asarray(reg))
    T_j = jax.vmap(jnph.edge_edge_T)(*_j(a0, a1, b0, b1), jnp.asarray(reg))
    s_t, t_t = tnph.edge_edge_params(*_t(a0, a1, b0, b1), torch.as_tensor(reg))
    T_t = tnph.edge_edge_T(*_t(a0, a1, b0, b1), torch.as_tensor(reg))
    assert np.all(np.asarray(s_j)[:75] == 0.5)
    assert _rel(s_t, s_j) < GEO_TOL and _rel(t_t, t_j) < GEO_TOL
    assert _rel(T_t, T_j) < GEO_TOL


@pytest.mark.parametrize("barrier", ["Cubic", "Log"])
def test_barrier_force_matches_jax(barrier):
    """The normal force of the lagged friction, both barriers (the Log
    branch with the JAX package's corrected sign: repulsive, positive)."""
    rng = np.random.default_rng(43)
    dhat = rng.uniform(1e-3, 1e-2, 500)
    d = dhat * rng.uniform(0.0, 1.5, 500)
    d[:5] = 0.0
    ref = np.asarray(jce.barrier_force(jnp.asarray(d), jnp.asarray(dhat), 1e6, barrier))
    out = tce.barrier_force(torch.as_tensor(d), torch.as_tensor(dhat), 1e6, barrier)
    assert _rel(out, ref) < GEO_TOL
    live = d < dhat
    assert np.all(ref[live] > 0.0) and np.all(ref[~live] == 0.0)


# ---------------------------------------------------------------------------
# the seven friction families
# ---------------------------------------------------------------------------
def _friction_rows(rng, n, n_soft, n_bodies):
    def locs(k):
        return rng.normal(0.0, 0.05, (n, k, 3))

    def nodes(k):
        return np.stack([rng.choice(n_soft, k, replace=False) for _ in range(n)])

    def body():
        return rng.integers(0, n_bodies, n)

    bary = rng.dirichlet([1.0, 1.0, 1.0], size=n)
    T = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0][:, :, :2].transpose(0, 2, 1)
    common = {"active": (rng.random(n) < 0.75).astype(np.float64),
              "dhat": np.full(n, 0.004), "T": T, "mu": rng.uniform(0.1, 1.0, n),
              "fn": rng.uniform(0.0, 20.0, n)}
    pt = {"bary": bary}
    ee = {"s": rng.uniform(0.0, 1.0, n), "t": rng.uniform(0.0, 1.0, n)}
    rows = {
        "friction_pt_dd": {"nodes": nodes(4), **pt},
        "friction_pt_dr": {"node_p": rng.integers(0, n_soft, n), "body_b": body(),
                           "t_loc": locs(3), **pt},
        "friction_pt_rd": {"body_a": body(), "p_loc": locs(1)[:, 0],
                           "nodes_t": nodes(3), **pt},
        "friction_pt_rr": {"body_a": body(), "p_loc": locs(1)[:, 0], "body_b": body(),
                           "t_loc": locs(3), **pt},
        "friction_ee_dd": {"nodes": nodes(4), **ee},
        "friction_ee_dr": {"body_a": body(), "ea_loc": locs(2), "nodes_b": nodes(2), **ee},
        "friction_ee_rr": {"body_a": body(), "ea_loc": locs(2), "body_b": body(),
                           "eb_loc": locs(2), **ee},
    }

    def vw(b):
        return [n_soft + 2 * b, n_soft + 2 * b + 1]

    conn_of = {
        "friction_pt_dd": lambda r: r["nodes"],
        "friction_pt_dr": lambda r: np.stack([r["node_p"], *vw(r["body_b"])], 1),
        "friction_pt_rd": lambda r: np.concatenate(
            [np.stack(vw(r["body_a"]), 1), r["nodes_t"]], 1),
        "friction_pt_rr": lambda r: np.stack([*vw(r["body_a"]), *vw(r["body_b"])], 1),
        "friction_ee_dd": lambda r: r["nodes"],
        "friction_ee_dr": lambda r: np.concatenate(
            [np.stack(vw(r["body_a"]), 1), r["nodes_b"]], 1),
        "friction_ee_rr": lambda r: np.stack([*vw(r["body_a"]), *vw(r["body_b"])], 1),
    }
    out = {}
    for name, r in rows.items():
        r.update(common)
        out[name] = {"conn": conn_of[name](r), "rows": r}
    return out


def _families(pkg, ftype):
    s = pkg.Settings()
    s.output.enable_output = False
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    sim.interactions.contact.ipc_friction_type = ftype
    return {f.name: f for f in sim.stark.global_potential.families
            if f.name.startswith("friction_")}


@pytest.mark.parametrize("ftype", ["C0", "C1"])
def test_friction_families_match_jax(ftype):
    """E, g and H of the 7 friction families per element (torch.func
    against JAX autodiff), f64, relative 1e-10, on random rows over random
    soft and rigid states, with rows on both sides of the stick-slide
    displacement."""
    rng = np.random.default_rng(44)
    n_soft, n_bodies, n = 48, 3, 32
    q0 = rng.normal(size=(n_bodies, 4))
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    u = rng.normal(0.0, 0.3, (n_soft + 2 * n_bodies, 3))
    data = _friction_rows(rng, n, n_soft, n_bodies)
    glob_np = {"x0": rng.normal(0.0, 0.1, (n_soft, 3)),
               "rb_t0": rng.normal(0.0, 0.1, (n_bodies, 3)), "rb_q0": q0,
               "dt": np.asarray(1.0 / 30.0), "friction_epsv": np.asarray(0.3)}
    jglob = {k: jnp.asarray(v) for k, v in glob_np.items()}
    tglob = {k: torch.as_tensor(v) for k, v in glob_np.items()}
    tdata = tables_from_numpy(data)
    jfam, tfam = _families(stark_tpu, ftype), _families(stark_tpu_torch, ftype)
    assert sorted(jfam) == sorted(tfam) == sorted(data)
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
        assert np.all(np.asarray(e_j) > 0.0), name
        assert _rel(e_t.numpy(), e_j) < FAM_TOL, name
        assert _rel(g_t.numpy(), g_j) < FAM_TOL, name
        assert _rel(H_t.numpy(), H_j) < FAM_TOL, name
    # both branches of the stick-slide transition are exercised
    r = data["friction_ee_dd"]["rows"]
    x = u[data["friction_ee_dd"]["conn"]]
    v = x[:, 2] + r["t"][:, None] * (x[:, 3] - x[:, 2]) \
        - (x[:, 0] + r["s"][:, None] * (x[:, 1] - x[:, 0]))
    slip = np.linalg.norm(np.einsum("nij,nj->ni", r["T"], v), axis=1) / 30.0
    assert np.any(slip < 0.01) and np.any(slip > 0.01)


# ---------------------------------------------------------------------------
# the friction tables on a frozen state
# ---------------------------------------------------------------------------
def _contact_mods(pkg):
    return (import_module(pkg.__name__ + ".presets.presets"),
            import_module(pkg.__name__ + ".models.interactions.contact"))


def _settings(pkg, name="friction", dt=1 / 30):
    s = pkg.Settings()
    s.output.simulation_name = name
    s.output.enable_output = False
    s.output.enable_frame_writes = False
    s.device.dtype = "float64"
    s.simulation.max_time_step_size = dt
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    return s


def _cloth_over_box_corner(pkg):
    """A 6x6 cloth over a box turned 30 degrees, mu 0.6 between cloth and
    box and 0.4 of the cloth with itself."""
    P, C = _contact_mods(pkg)
    sim = pkg.Simulation(_settings(pkg))
    gp = C.ContactGlobalParams()
    gp.default_contact_thickness = 0.002
    sim.interactions.contact.set_global_params(gp)
    cloth = sim.presets.deformables.add_surface_grid(
        "cloth", (0.1, 0.1), (6, 6), P.SurfaceParams.Cotton_Fabric())
    box = sim.presets.rigidbodies.add_box("box", 1.0, 0.08)
    box.rigidbody.add_rotation(30.0, [0.0, 0.0, 1.0])
    box.rigidbody.add_translation([0.01, -0.005, -0.043])
    cloth.contact.set_friction(box.contact, 0.6)
    cloth.contact.set_friction(cloth.contact, 0.4)
    sim.stark._initialize()
    return sim


def _crumpled_state(rng, Vs, Vr):
    """The cloth shrunk to 1.5 cm around the box's highest corner, 1.5-3 mm
    above the top face, with a random ripple: cloth self-pairs, cloth points
    over the top face, the corner under the cloth, and cloth edges over the
    box's edges, all within the contact distance."""
    corner = Vr[np.argmax(Vr[:, 2] + 1e-3 * (Vr[:, 0] + Vr[:, 1]))]
    Vs = np.array(Vs)
    c = Vs[:, :2] - Vs[:, :2].mean(0)
    Vs[:, :2] = corner[:2] + 0.15 * c
    Vs[:, 2] = corner[2] + 0.0022 + 0.0006 * rng.standard_normal(len(Vs))
    return Vs


def test_friction_tables_match_jax():
    """engine.friction_tables (kernels I, E and J by their twins) on one
    frozen state: the same friction families, the same rows in the same
    order (pairs, active, anchors, T, mu, fn, dhat), the same counts. The
    port starts from the JAX engine's capacities."""
    js = _cloth_over_box_corner(stark_tpu)
    ts = _cloth_over_box_corner(stark_tpu_torch)
    jeng = js.interactions.contact._engine
    teng = ts.interactions.contact.engine()
    jVs, jVr = jeng.world_from_u(jnp.zeros((js.stark.newton.n_blocks, 3)),
                                 jeng.engine_state(), jnp.asarray(0.0))
    Vs = _crumpled_state(np.random.default_rng(45), np.asarray(jVs), np.asarray(jVr))
    jVs = jnp.asarray(Vs)
    tVs, tVr = torch.as_tensor(Vs), torch.as_tensor(np.asarray(jVr))
    for stem in jeng._blocks():
        jeng._caps["f_" + stem] = 8192
    jc = js.interactions.contact
    k = float(jc.contact_stiffness)
    tab_j, cnt_j = jeng.friction_tables(jVs, jVr, jeng._th_vec(), jeng._mu_mat(),
                                        jnp.asarray(k))
    set_contact_state(ts.interactions.contact, jc.contact_thicknesses, k,
                      caps=dict(jeng._caps), pair_mu=jc.pair_mu)
    tab_t, cnt_t = teng.friction_tables(tVs, tVr, teng.th_vec(), teng._mu_mat(),
                                        torch.tensor(k, dtype=torch.float64))
    assert sorted(tab_t) == sorted(tab_j)
    for key, c in cnt_j.items():
        assert int(cnt_t[key]) == int(c), key
    for stem in ("pt_dd", "pt_dr", "pt_rd", "ee_dd", "ee_dr"):
        assert 0 < int(cnt_j["f_" + stem]) <= 8192, stem
    assert int(cnt_t["f_pt"]) == sum(int(cnt_j["f_" + s]) for s in jeng._blocks()
                                     if s.startswith("pt"))
    for name, fd_j in tab_j.items():
        fd_t = tab_t[name]
        act = np.asarray(fd_j["rows"]["active"]) > 0.5
        np.testing.assert_array_equal(fd_t["rows"]["active"].numpy(),
                                      np.asarray(fd_j["rows"]["active"]), name)
        np.testing.assert_array_equal(fd_t["conn"].numpy()[act],
                                      np.asarray(fd_j["conn"])[act], name)
        assert sorted(fd_t["rows"]) == sorted(fd_j["rows"]), name
        for r, v in fd_j["rows"].items():
            v = np.asarray(v)[act]
            w = fd_t["rows"][r].numpy()[act]
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(w, v, f"{name} {r}")
            elif v.size:
                assert _rel(w, v) < GEO_TOL, f"{name} {r}"
        if act.any():
            assert np.all(np.asarray(fd_j["rows"]["fn"])[act] > 0.0), name


def test_friction_pair_twins_place_boundary_pairs():
    """Kernels I and J's twins on a small grid with pairs placed at
    d = dhat and one ulp on either side: kept exactly when d <= dhat, in
    row-major order, with the exact count past the capacity; J's rows past
    the count are zero with region -1."""
    rng = np.random.default_rng(46)
    V = torch.as_tensor(rng.normal(size=(40, 3)))
    tris = torch.as_tensor(rng.integers(0, 40, size=(30, 3)), dtype=torch.int32)
    Np, Nt = 40, 30
    p_mesh = torch.arange(Np, dtype=torch.int32)
    t_mesh = torch.arange(Np, Np + Nt, dtype=torch.int32)
    M = Np + Nt
    mu = torch.ones((M, M), dtype=torch.float64)
    mu[3, :] = mu[:, 3] = 0.0
    allowed = torch.as_tensor(rng.random((Np, Nt)) < 0.8).to(torch.uint8)
    tq = tris.long()
    d_all = tnph.point_triangle_distance(V[:, None], V[tq[:, 0]][None], V[tq[:, 1]][None],
                                         V[tq[:, 2]][None])
    th = torch.zeros(M, dtype=torch.float64)
    j = torch.argmin(torch.where(allowed.bool(), d_all, torch.inf), dim=1)
    d_j = d_all[torch.arange(Np), j]
    th[:Np] = d_j
    th[:Np:3] = torch.nextafter(d_j[::3], torch.tensor(0.0, dtype=torch.float64))
    th[1:Np:3] = torch.nextafter(d_j[1::3], torch.tensor(1.0, dtype=torch.float64))
    q, t, d, dh, cnt = tfp.friction_pairs_pt_plain(V, tris, allowed, p_mesh, t_mesh,
                                                   mu, th, 1000)
    keep = allowed.bool() & (mu[:Np, Np:] != 0) & (d_all <= th[:Np, None])
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
    n = int(cnt)
    assert n == idx.numel() and n > Np // 2
    assert torch.equal(q[:n].long() * Nt + t[:n].long(), idx)
    assert torch.all(q[n:] == 0) and torch.all(d[n:] == 0)
    kept = set(idx.tolist())
    placed = {r: r * Nt + int(j[r]) for r in range(Np) if r != 3}
    assert all(placed[r] in kept for r in placed if r % 3 != 0)     # at and above
    assert not any(placed[r] in kept for r in placed if r % 3 == 0)  # one ulp below
    q2, _t2, _d2, _dh2, cnt2 = tfp.friction_pairs_pt_plain(V, tris, allowed, p_mesh,
                                                          t_mesh, mu, th, 5)
    assert int(cnt2) == n and torch.equal(q2, q[:5])
    reg, bary, T, mu_r, fn = tfr.friction_rows_pt_plain(
        V, tris, q, t, cnt, d, dh, p_mesh, t_mesh, mu,
        torch.tensor(1e5, dtype=torch.float64), "Cubic")
    assert torch.all(reg[:n] >= 0) and torch.all(reg[n:] == -1)
    assert torch.all(bary[n:] == 0) and torch.all(T[n:] == 0) and torch.all(fn[n:] == 0)
    assert torch.allclose(bary[:n].sum(-1), torch.ones(n, dtype=torch.float64))
    assert torch.all(mu_r[:n] == 1.0)


# ---------------------------------------------------------------------------
# the friction half of tests/test_contact.py::test_fd_contact_energies
# ---------------------------------------------------------------------------
def test_fd_contact_energies_with_friction():
    """Two cloths 1.5 mm apart with mu 0.4 between them: the friction tables
    exist with live PT rows, and the gradient of the whole potential (static,
    contact and friction families) matches central differences of its
    energy."""
    P, _C = _contact_mods(stark_tpu_torch)
    s = _settings(stark_tpu_torch, "fd_friction", dt=1 / 100)
    s.newton.residual_tolerance_abs = 1e-5
    sim = stark_tpu_torch.Simulation(s)
    p = P.SurfaceParams.Cotton_Fabric()
    sim.interactions.contact.global_params.default_contact_thickness = 0.001
    c1 = sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (3, 3), p)
    c2 = sim.presets.deformables.add_surface_grid("", (0.2, 0.2), (3, 3), p)
    c1.contact.set_friction(c2.contact, 0.4)
    pts = c2.point_set
    x = pts.get_positions()
    x[:, 2] += 0.0015
    x[:, 0] += 0.021
    sim._dyn._x0_host[pts.get_begin():pts.get_begin() + pts.size()] = x
    sim.stark._initialize()
    nm = sim.stark.newton
    sim.stark.callbacks.run_before_time_step()
    eng = sim.interactions.contact.engine()
    # the lagged tables as the fused solve builds them at the step start
    eglob = eng.glob_entries()
    Vs0, Vr0 = eng.step_start_world(eng.engine_state())
    fric, _cnt = eng.friction_tables(Vs0, Vr0, eng.th_vec(), eglob["mu_mat"],
                                     eglob["contact_k"])
    assert "friction_pt_dd" in fric
    assert int(torch.sum(fric["friction_pt_dd"]["rows"]["active"] > 0.5)) > 0
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
    data.update(fric)
    glob = sim._get_glob()
    topo = ev.topology(static, dense=False)
    E, _aux, g, H = ev.energy_grad_hess(ut, data, glob, topo, ev.egh_csr(data))
    assert float(torch.abs(H["friction_pt_dd"]).max()) > 0.0
    g = g.numpy()
    assert np.isfinite(float(E)) and np.all(np.isfinite(g))
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
