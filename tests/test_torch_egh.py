"""Element energies, gradients and Hessians of the port's kernel families
(kernels M-W, K11) against `stark_tpu`, on the CPU.

For every family that has a kernel (triangle strain, full and
elasticity-only; lumped inertia; prescribed positions; flat-rest shells;
rigid linear and angular inertia; the fix joint's global points and
directions; the seven frictionless contact families, Cubic and Log;
segment and tet strain, full and elasticity-only; the seven friction
families, C0 and C1; the rigid joints and full shells; the five
attachment families), the
same seeded numpy inputs go through the JAX family (jax.hessian under
vmap, masked and symmetrised as the JAX assembly does), the port's
torch.func twin (ops/egh.py `plain`) and the host build of the kernels'
own element math (csrc/egh_*.cu compiled as C++17 with g++, ops/build.py
`host_library`): e, g and H agree within 1e-10 of each element's largest
entry in float64. The inputs are random elements plus the ties where the
twin's autodiff picks a branch: an undeformed triangle or tet (the strain
limits' clamped square roots), a zero-length segment, a row with d = dhat
exactly (the barrier's gap of 0), a touching row (d = 0, the distance's
floor), friction rows at rest and exactly at u = epsu (the slide branch),
inactive rows, rows past dhat and a rigid body at w = 0. The value-only
form of each kernel gives the derivative form's e bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu_torch.ops import build, egh
from stark_tpu_torch.tools.egh_cases import (f32_ratio, f64_err, f64_spread, make_case,
                                             per_elem_err)
from stark_tpu_torch.utils.from_jax import tables_from_numpy

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores, and
    on these small tensors more threads only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _families(pkg, mode):
    """The families of a Simulation with `mode` set: a barrier type (Cubic,
    Log) or, for the friction families, a friction type (C0, C1)."""
    s = pkg.Settings()
    s.output.enable_output = False
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    if mode in ("C0", "C1"):
        sim.interactions.contact.ipc_friction_type = mode
    else:
        sim.interactions.contact.ipc_barrier_type = mode
    return {f.name: f for f in sim.stark.global_potential.families}


# the main path's 12 families (bench.py's spinning box) and the hanging
# cloth's prescribed positions: against JAX and the twin
MAIN_FAMILIES = [
    "EnergyTriangleStrain", "EnergyLumpedInertia", "EnergyPrescribedPositions",
    "EnergyBendingFlat", "EnergyRigidBodyInertia_Linear", "EnergyRigidBodyInertia_Angular",
    "rb_constraint_global_points", "rb_constraint_global_directions", "contact_pt_dd",
    "contact_pt_dr", "contact_pt_rd", "contact_ee_dd", "contact_ee_dr"]
# the other kernel families, whose twins tests/test_torch_cloth.py and
# tests/test_torch_contact.py hold against JAX: against the twin
OTHER_FAMILIES = ["EnergyTriangleStrain_ElasticityOnly", "contact_pt_rr", "contact_ee_rr"]
# rods and volumes (R, S) and the friction families (Q) under C0 and C1
VOLUME_FAMILIES = ["EnergySegmentStrain", "EnergySegmentStrain_ElasticityOnly",
                   "EnergyTetStrain", "EnergyTetStrain_ElasticityOnly"]
FRICTION_FAMILIES = ["friction_pt_dd", "friction_pt_dr", "friction_pt_rd", "friction_pt_rr",
                     "friction_ee_dd", "friction_ee_dr", "friction_ee_rr"]
# the rigid joints (T, U) and full DiscreteShells (V)
JOINT_FAMILIES = ["rb_constraint_points", "rb_constraint_point_on_axis",
                  "rb_constraint_distances", "rb_constraint_distance_limits",
                  "rb_constraint_damped_spring", "rb_constraint_directions",
                  "rb_constraint_angle_limits", "rb_constraint_linear_velocity",
                  "rb_constraint_angular_velocity", "EnergyDiscreteShells"]
# the attachments (W): the four soft penalties and a soft point on a body
ATTACHMENT_FAMILIES = ["EnergyAttachments_d_d_p_p", "EnergyAttachments_d_d_p_e",
                       "EnergyAttachments_d_d_p_t", "EnergyAttachments_d_d_e_e",
                       "EnergyAttachments_rb_d"]
NEW_FAMILIES = set(VOLUME_FAMILIES + FRICTION_FAMILIES + JOINT_FAMILIES)
CASES = [(n, "Cubic", True) for n in MAIN_FAMILIES] + \
    [(n, "Log", True) for n in ("contact_pt_dd", "contact_ee_dd")] + \
    [(n, "Cubic", False) for n in OTHER_FAMILIES] + [("contact_pt_rr", "Log", False)] + \
    [(n, "Cubic", True) for n in VOLUME_FAMILIES] + \
    [(n, m, True) for m in ("C0", "C1") for n in FRICTION_FAMILIES] + \
    [(n, "Cubic", True) for n in JOINT_FAMILIES] + \
    [(n, "Cubic", True) for n in ATTACHMENT_FAMILIES]


def _jax_egh(fam, u, conn, rows, glob):
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    jglob = {k: jnp.asarray(v) for k, v in glob.items()}
    f = fam.energy_fn
    e, g, H = jax.jit(jax.vmap(
        lambda u_e, r, gl: (f(u_e, r, gl), jax.grad(f)(u_e, r, gl), jax.hessian(f)(u_e, r, gl)),
        in_axes=(0, 0, None)))(jnp.asarray(u)[jnp.asarray(conn)], jrows, jglob)
    m = np.asarray(rows["active"]) > 0.5
    d = 3 * conn.shape[1]
    H = np.asarray(H).reshape(-1, d, d)
    H = 0.5 * (H + H.transpose(0, 2, 1))
    return (np.where(m, np.asarray(e), 0.0), np.where(m[:, None, None], np.asarray(g), 0.0),
            np.where(m[:, None, None], H, 0.0))


def test_kernel_families_have_cases():
    """Every family with a kernel has a case here and seeded tables."""
    from stark_tpu_torch.tools.egh_cases import KERNEL_FAMILIES

    with_kernel = {n for n, f in _families(stark_tpu_torch, "Cubic").items()
                   if f.kernel is not None}
    assert with_kernel == set(KERNEL_FAMILIES) == {c[0] for c in CASES}


def _friction_tie_u(rows, glob, u, conn):
    """|ut| of a soft-soft friction row 0, as numpy adds it (exact there)."""
    vrel = -u[conn[0, 0]]
    ut = (rows["T"][0] @ vrel) * glob["dt"] + np.array([1.13e-9, -1.07e-9])
    return float(np.sqrt(ut @ ut)), float(glob["dt"] * glob["friction_epsv"])


@pytest.mark.parametrize("name,barrier,with_jax", CASES)
def test_egh_twin_and_kernel_math_match_jax(name, barrier, with_jax):
    glob, u, conn, rows = make_case(name, sum(map(ord, name + barrier)))
    tfam = _families(stark_tpu_torch, barrier)[name]
    assert tfam.kernel is not None
    t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
    tglob = {k: torch.as_tensor(v) for k, v in glob.items()}
    ut = torch.as_tensor(u)
    e_t, g_t, H_t = egh.plain(tfam.energy_fn, ut, t["conn"], t["rows"], tglob)
    e_k, g_k, H_k = tfam.kernel(ut, t["conn"], t["rows"], tglob, True, host=True)
    e_v = tfam.kernel(ut, t["conn"], t["rows"], tglob, False, host=True)
    pairs = {"e kernel-twin": (e_k, e_t), "g kernel-twin": (g_k, g_t),
             "H kernel-twin": (H_k, H_t)}
    if with_jax:
        e_j, g_j, H_j = _jax_egh(_families(stark_tpu, barrier)[name], u, conn, rows, glob)
        pairs.update({"e twin": (e_t, e_j), "g twin": (g_t, g_j), "H twin": (H_t, H_j),
                      "e kernel": (e_k, e_j), "g kernel": (g_k, g_j),
                      "H kernel": (H_k, H_j)})
    else:
        e_j, H_j = e_t.numpy(), H_t.numpy()
    for what, (a, b) in pairs.items():
        # the e of rods, volumes and friction against the family's largest
        # |e| (PERF.md's rule for M-S: a friction row at rest carries an e
        # of ~1e-15, the fixed perturbation's, which one rounding of the
        # anchors' weights moves by 4e-9 of itself); all else per element
        err = (f64_err(a, b, "e") if what[0] == "e" and name in NEW_FAMILIES
               else per_elem_err(a, b))
        assert err <= TOL, f"{name} ({barrier}) {what}: {err:.3e}"
    assert torch.equal(e_v, e_k), "the value-only e differs from the egh e"
    assert torch.equal(H_k, H_k.transpose(1, 2)), "the kernel's H is not symmetric"
    inactive = t["rows"]["active"] <= 0.5
    assert bool(torch.all(H_k[inactive] == 0)) and bool(torch.all(e_k[inactive] == 0))
    if name in ("friction_pt_dd", "friction_ee_dd"):
        # row 0 sits exactly at u = epsu, where every form slides; row 1 at
        # rest sticks
        u_tie, epsu = _friction_tie_u(rows, glob, u, conn)
        assert u_tie == epsu
    if name.startswith("contact_") and not (name[11] == "r" or name[12] == "r"):
        # the d = dhat tie: zero barrier, zero derivatives, in all three
        assert e_j[0] == 0.0 and float(e_k[0]) == 0.0 and not np.any(H_j[0])
        assert not bool(torch.any(H_k[0])) and not bool(torch.any(H_t[0]))


# (family, barrier): contact_ee_dr under Log has a row (0, the EE tie) whose
# float32 twin lies ~1e-4 of its scale from float64, far past 64 eps
F32_RULE_CASES = [("EnergyTriangleStrain", "Cubic"), ("contact_pt_dd", "Cubic"),
                  ("contact_ee_dr", "Log"), ("EnergyTetStrain", "Cubic"),
                  ("friction_pt_rd", "C1")]


@pytest.mark.parametrize("part", ["g", "H"])
@pytest.mark.parametrize("name,barrier", F32_RULE_CASES)
def test_f32_rule_fails_a_planted_wrong_row(name, barrier, part):
    """tools/egh_cases.f32_ratio, the float32 check of chip_smoke.py's phase
    17 and of the card tests, judges element by element: the host build's
    float32 result passes it, and the same result with one wrong row (its
    largest entry off by 4 x 64 eps of the row's scale, on the smallest
    live row whose float32 floor lies within 64 eps) fails it, also where
    another row's floor lies farther from float64 than the planted error."""
    glob, u, conn, rows = make_case(name, sum(map(ord, name + barrier)))
    fam = _families(stark_tpu_torch, barrier)[name]
    k = "egH".index(part)
    outs = []
    for dtype in (torch.float64, torch.float32):
        t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
        rw = {key: v.to(dtype) if v.is_floating_point() else v for key, v in t["rows"].items()}
        gl = {key: torch.as_tensor(v, dtype=dtype) for key, v in glob.items()}
        ut = torch.as_tensor(u, dtype=dtype)
        outs.append(egh.plain(fam.energy_fn, ut, t["conn"], rw, gl)[k])
        if dtype == torch.float32:
            out32 = fam.kernel(ut, t["conn"], rw, gl, True, host=True)[k]
        else:
            spread = f64_spread(fam.energy_fn, ut, t["conn"], rw, gl)[k]
    twin64, twin32 = outs
    assert f32_ratio(out32, twin32, twin64, part, spread)[0] <= 1.0
    n = out32.shape[0]
    t32 = twin32.double().reshape(n, -1)
    own = (t32 - twin64.reshape(n, -1)).abs().amax(dim=1)
    scale = t32.abs().amax(dim=1)
    eps = torch.finfo(torch.float32).eps
    near = torch.as_tensor(rows["active"] > 0.5) & (scale > 0) & \
        (torch.maximum(own, spread) <= 64 * eps * scale)
    j = int(torch.argmin(torch.where(near, scale, torch.inf)))
    bad = out32.clone().reshape(n, -1)
    m = int(bad[j].abs().argmax())
    planted = 4 * 64 * eps * float(scale[j])
    bad[j, m] += planted if bad[j, m] >= 0 else -planted
    assert f32_ratio(bad.reshape(out32.shape), twin32, twin64, part, spread)[0] > 1.0
    if name == "contact_ee_dr":
        assert planted < 2 * float(torch.maximum(own, spread).max())


# kernel P's flat shells and kernels N and O, both barriers for the contact
# families: the float32 host build against the float32 and float64 twins
F32_HOST_CASES = [("EnergyBendingFlat", "Cubic")] + \
    [("contact_" + st, b) for b in ("Cubic", "Log")
     for st in ("pt_dd", "pt_dr", "pt_rd", "pt_rr", "ee_dd", "ee_dr", "ee_rr")]


@pytest.mark.parametrize("name,barrier", F32_HOST_CASES)
def test_f32_host_build_matches_twins(name, barrier):
    """The float32 host build of a family's kernel math on its seeded
    tables passes tools/egh_cases.f32_ratio (<= 1 for e, g and H), the rule
    the card tests and chip_smoke.py's phase 17 hold the card's float32
    kernels to. The seeded Bergou K do not sum to zero (a cloth's do, up to
    rounding), so the flat shells' float32 form must keep the (sum K) x_0
    term that a shift of the stencil to node 0 drops."""
    glob, u, conn, rows = make_case(name, sum(map(ord, name + barrier)))
    fam = _families(stark_tpu_torch, barrier)[name]
    t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
    if name == "EnergyBendingFlat":
        assert np.abs(rows["bergou_K"].sum(axis=1)).max() > 1.0
    outs, spread = [], None
    for dtype in (torch.float64, torch.float32):
        rw = {k: v.to(dtype) if v.is_floating_point() else v for k, v in t["rows"].items()}
        gl = {k: torch.as_tensor(v, dtype=dtype) for k, v in glob.items()}
        ut = torch.as_tensor(u, dtype=dtype)
        outs.append(egh.plain(fam.energy_fn, ut, t["conn"], rw, gl))
        if dtype == torch.float64:
            spread = f64_spread(fam.energy_fn, ut, t["conn"], rw, gl)
        else:
            out32 = fam.kernel(ut, t["conn"], rw, gl, True, host=True)
            assert torch.equal(fam.kernel(ut, t["conn"], rw, gl, False, host=True), out32[0])
    twin64, twin32 = outs
    for part, k, t32, t64, s in zip("egH", out32, twin32, twin64, spread):
        ratio = f32_ratio(k, t32, t64, part, s)[0]
        assert ratio <= 1.0, f"{name} ({barrier}) {part}: f32 err/tol {ratio:.3g}"
    assert torch.equal(out32[2], out32[2].transpose(1, 2))


def test_wrapper_takes_the_twin_on_the_cpu():
    """On CPU tensors a family evaluates through its twin, counted nowhere;
    a kernel launcher refuses CPU tensors outside the host build."""
    name = "contact_pt_dr"
    glob, u, conn, rows = make_case(name, 6)
    t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
    tglob = {k: torch.as_tensor(v) for k, v in glob.items()}
    fam = _families(stark_tpu_torch, "Cubic")[name]
    build.reset_launches()
    e, g, H = egh.evaluate(fam, torch.as_tensor(u), t["conn"], t["rows"], tglob)
    e_t, g_t, H_t = egh.plain(fam.energy_fn, torch.as_tensor(u), t["conn"], t["rows"], tglob)
    assert torch.equal(e, e_t) and torch.equal(H, H_t)
    assert not build.launches and not build.func_on_card
    with pytest.raises(ValueError):
        fam.kernel(torch.as_tensor(u), t["conn"], t["rows"], tglob, True)


@pytest.mark.parametrize("projected", [True, False])
def test_point_edge_distance_beside_a_long_edge(projected):
    """A soft point 2 mm from the middle of a 2.8 m edge (the diagonal of a
    2 m floor's top face, as under chip_smoke.py's phase 19), dhat 4 mm:
    the contact energies' point-edge squared distance, |ap - s ab|^2
    (`projected`, the form of the twin and of kernels N and O), keeps the
    float32 energy within 1e-5 of the float64 one, where the reference's
    difference of squares |ap|^2 - (ap.ab)^2 / |ab|^2 loses over 1% of it
    to cancellation. The float32 host build agrees with the float32 twin,
    and in float64 the host build with the twin within 1e-10."""
    from stark_tpu_torch.collision import narrow_phase as nph
    from stark_tpu_torch.models.interactions import contact_energies as ce

    glob, u, conn, rows = make_case("contact_pt_dd", 11)
    nodes = rows["nodes"][2:3]
    s2 = np.sqrt(0.5)
    x = np.array([[0.2 - 0.0012 * s2, 0.2 + 0.0012 * s2, 0.0016],
                  [-1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [1.0, -1.0, 0.0]])
    glob["x0"][nodes[0]] = x.astype(np.float32)        # both dtypes read the same x0
    u[nodes[0]] = 0.0
    one = {"active": np.ones(1), "dhat": np.array([0.004]), "nodes": nodes}
    fam = _families(stark_tpu_torch, "Cubic")["contact_pt_dd"]
    e = {}
    for dtype in (torch.float64, torch.float32):
        t = tables_from_numpy({"c": {"conn": nodes, "rows": one}})["c"]
        rw = {k: v.to(dtype) if v.is_floating_point() else v for k, v in t["rows"].items()}
        gl = {k: torch.as_tensor(v, dtype=dtype) for k, v in glob.items()}
        ut = torch.as_tensor(u, dtype=dtype)
        p, t0, t1, t2 = gl["x0"][nodes[0]]
        d = nph.point_triangle_distance(p, t0, t1, t2, projected=projected)
        e[dtype] = float(ce.barrier(d, rw["dhat"][0], gl["contact_k"], "Cubic",
                                    torch.tensor(True)))
        e[str(dtype)] = float(d)
        if projected:
            # the twin's energy is this barrier of this distance
            assert float(fam.energy_fn(ut[t["conn"][0]], {k: v[0] for k, v in rw.items()},
                                       gl)) == e[dtype]
            k_out = fam.kernel(ut, t["conn"], rw, gl, True, host=True)
            t_out = egh.plain(fam.energy_fn, ut, t["conn"], rw, gl)
            if dtype == torch.float64:
                assert max(per_elem_err(k.numpy(), r.numpy())
                           for k, r in zip(k_out, t_out)) <= TOL
            else:
                assert abs(float(k_out[0][0]) - float(t_out[0][0])) <= 1e-5 * float(t_out[0][0])
    from fractions import Fraction

    xf = [[Fraction(float(c)) for c in r] for r in x.astype(np.float32)]
    ap = [xf[0][i] - xf[1][i] for i in range(3)]
    ab = [xf[2][i] - xf[1][i] for i in range(3)]
    dot = lambda a, b: sum(i * j for i, j in zip(a, b))
    exact = np.sqrt(float(dot(ap, ap) - dot(ap, ab) ** 2 / dot(ab, ab)))
    assert abs(e[str(torch.float64)] - exact) < 1e-12
    assert nph.point_triangle_region(*torch.as_tensor(x)) == 3    # the edge t0-t1
    rel = abs(e[torch.float32] - e[torch.float64]) / e[torch.float64]
    assert (rel < 1e-5) if projected else (rel > 1e-2)


@pytest.mark.parametrize("state", ["flat", "folded"])
def test_full_shells_kernel_at_flat_and_folded_states(state):
    """Kernel V (full DiscreteShells) on a cloth's own stencils: a 4x4 grid
    of side 1 (coordinates exact in binary) with flat_rest_angle off, at
    rest (every interior edge flat: acos at 1 - 100 eps, its slope
    ~1/sqrt(200 eps)) and at a random folded iterate. The JAX family (jax.
    hessian), the twin and the host build agree within 1e-10 of each
    element's largest entry in float64; the value-only e is the egh e."""
    from stark_tpu.presets.presets import SurfaceParams

    s = stark_tpu.Settings()
    s.output.enable_output = False
    s.simulation.init_frictional_contact = False
    sim = stark_tpu.Simulation(s)
    p = SurfaceParams.Cotton_Fabric()
    p.bending.flat_rest_angle = False
    p.bending.stiffness = 1e-3
    p.bending.damping = 1e-4
    sim.presets.deformables.add_surface_grid("", (1.0, 1.0), (4, 4), p)
    sim.stark._initialize()
    name = "EnergyDiscreteShells"
    fd = sim._get_static_data()[name]
    conn = np.asarray(fd["conn"])
    rows = {k: np.asarray(v) for k, v in fd["rows"].items()}
    glob = {k: np.asarray(v) for k, v in sim._get_glob().items()}
    n = glob["x0"].shape[0]
    u = (np.zeros((n, 3)) if state == "flat"
         else np.random.default_rng(5).normal(0.0, 0.5, (n, 3)))
    if state == "flat":
        assert np.all(glob["x0"][:, 2] == 0.0) and np.all(glob["x0"] * 8 == np.round(glob["x0"] * 8))
    ref = _jax_egh(_families(stark_tpu, "Cubic")[name], u, conn, rows, glob)
    fam = _families(stark_tpu_torch, "Cubic")[name]
    t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
    tglob = {k: torch.as_tensor(v) for k, v in glob.items()}
    ut = torch.as_tensor(u)
    twin = egh.plain(fam.energy_fn, ut, t["conn"], t["rows"], tglob)
    kern = fam.kernel(ut, t["conn"], t["rows"], tglob, True, host=True)
    for part, a, b, r in zip("egH", twin, kern, ref):
        assert per_elem_err(a.numpy(), r) <= TOL, (state, part, "twin")
        assert per_elem_err(b.numpy(), r) <= TOL, (state, part, "kernel")
    assert torch.equal(fam.kernel(ut, t["conn"], t["rows"], tglob, False, host=True), kern[0])
    if state == "flat":
        # every stencil exactly flat: n0^ . n1^ = 1, theta = acos(1 - 100 eps)
        from stark_tpu_torch import maths

        x = torch.as_tensor(glob["x0"])[t["conn"]]
        theta = torch.stack([maths.dihedral_angle(*xe) for xe in x])
        assert torch.all(theta == np.arccos(1.0 - 100.0 * np.finfo(np.float64).eps))


def _near_flat_shells(n=40, seed=7):
    """Full-shell stencils folded by 1e-5 to 1e-3 rad, randomly placed,
    at rest (u = 0): where acos's slope 1/sqrt(1 - x^2) magnifies c's
    last bit."""
    from stark_tpu_torch.maths import np_quat_to_rotation

    rng = np.random.default_rng(seed)
    x0, nodes = [], []
    for i in range(n):
        a = rng.uniform(1e-5, 1e-3)
        pts = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0],
                        [0.5, -np.cos(a), np.sin(a)]]) * rng.uniform(0.01, 0.05)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        x0.append(pts @ np_quat_to_rotation(q).T + rng.normal(0.0, 0.2, 3))
        nodes.append([4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3])
    glob = {"dt": np.asarray(1.0 / 30.0), "x0": np.concatenate(x0)}
    rows = {"nodes": np.asarray(nodes), "active": np.ones(n),
            "rest_dihedral_angle": rng.uniform(0.0, 1e-3, n),
            "rest_edge_length": rng.uniform(0.01, 0.05, n),
            "rest_height": rng.uniform(0.005, 0.03, n), "scale": np.ones(n),
            "stiffness": rng.uniform(1e-4, 1e-2, n), "damping": np.zeros(n)}
    return glob, np.zeros((4 * n, 3)), np.asarray(nodes), rows


@pytest.mark.parametrize("part", ["g", "H"])
def test_f64_floor_rule_for_full_shells(part):
    """tools/egh_cases.f64_ratio, chip_smoke.py's float64 check of full
    shells (kernel V): at nearly flat edges the twin moves by more than
    1e-10 of an element's scale under float64 rounding of the positions
    (f64_spread at float64's eps), so the host build can lie that far from
    it; the rule passes the host build, and fails it with one row's largest
    entry moved by four times that row's tolerance."""
    from stark_tpu_torch.tools.egh_cases import f64_ratio

    glob, u, conn, rows = _near_flat_shells()
    name = "EnergyDiscreteShells"
    fam = _families(stark_tpu_torch, "Cubic")[name]
    t = tables_from_numpy({name: {"conn": conn, "rows": rows}})[name]
    tglob = {k: torch.as_tensor(v) for k, v in glob.items()}
    ut = torch.as_tensor(u)
    k = "egH".index(part)
    twin = egh.plain(fam.energy_fn, ut, t["conn"], t["rows"], tglob)[k]
    out = fam.kernel(ut, t["conn"], t["rows"], tglob, True, host=True)[k]
    spread = f64_spread(fam.energy_fn, ut, t["conn"], t["rows"], tglob, draws=8,
                        eps=float(torch.finfo(torch.float64).eps))[k]
    n = out.shape[0]
    scale = twin.reshape(n, -1).abs().amax(dim=1)
    assert float((spread / scale).max()) > 1e-10     # the twin itself moves that far
    ratio, wide = f64_ratio(out, twin, part, spread)
    assert ratio <= 1.0
    j = int(torch.argmax(spread / scale))
    bad = out.clone().reshape(n, -1)
    m = int(bad[j].abs().argmax())
    bad[j, m] += 4 * max(1e-10 * float(scale[j]), 2 * float(spread[j]))
    assert f64_ratio(bad.reshape(out.shape), twin, part, spread)[0] > 1.0
