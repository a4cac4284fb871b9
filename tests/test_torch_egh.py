"""Element energies, gradients and Hessians of the port's kernel families
(kernels M-P, K11) against `stark_tpu`, on the CPU.

For every family that has a kernel (triangle strain, full and
elasticity-only; lumped inertia; prescribed positions; flat-rest shells;
rigid linear and angular inertia; the fix joint's global points and
directions; the seven frictionless contact families, Cubic and Log), the
same seeded numpy inputs go through the JAX family (jax.hessian under
vmap, masked and symmetrised as the JAX assembly does), the port's
torch.func twin (ops/egh.py `plain`) and the host build of the kernels'
own element math (csrc/egh_*.cu compiled as C++17 with g++, ops/build.py
`host_library`): e, g and H agree within 1e-10 of each element's largest
entry in float64. The inputs are random elements plus the ties where the
twin's autodiff picks a branch: an undeformed triangle (the strain limit's
clamped square root), a row with d = dhat exactly (the barrier's gap of 0),
a touching row (d = 0, the distance's floor), inactive rows, rows past dhat
and a rigid body at w = 0. The value-only form of each kernel gives the
derivative form's e bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu_torch
from stark_tpu_torch.ops import build, egh
from stark_tpu_torch.tools.egh_cases import f32_ratio, f64_spread, make_case, per_elem_err
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


def _families(pkg, barrier):
    s = pkg.Settings()
    s.output.enable_output = False
    s.device.dtype = "float64"
    if pkg is stark_tpu_torch:
        s.device.device = "cpu"
    sim = pkg.Simulation(s)
    sim.interactions.contact.ipc_barrier_type = barrier
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
CASES = [(n, "Cubic", True) for n in MAIN_FAMILIES] + \
    [(n, "Log", True) for n in ("contact_pt_dd", "contact_ee_dd")] + \
    [(n, "Cubic", False) for n in OTHER_FAMILIES] + [("contact_pt_rr", "Log", False)]


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
        err = per_elem_err(a, b)
        assert err <= TOL, f"{name} ({barrier}) {what}: {err:.3e}"
    assert torch.equal(e_v, e_k), "the value-only e differs from the egh e"
    assert torch.equal(H_k, H_k.transpose(1, 2)), "the kernel's H is not symmetric"
    inactive = t["rows"]["active"] <= 0.5
    assert bool(torch.all(H_k[inactive] == 0)) and bool(torch.all(e_k[inactive] == 0))
    if name.startswith("contact_") and not (name[11] == "r" or name[12] == "r"):
        # the d = dhat tie: zero barrier, zero derivatives, in all three
        assert e_j[0] == 0.0 and float(e_k[0]) == 0.0 and not np.any(H_j[0])
        assert not bool(torch.any(H_k[0])) and not bool(torch.any(H_t[0]))


# (family, barrier): contact_ee_dr under Log has a row (0, the EE tie) whose
# float32 twin lies ~1e-4 of its scale from float64, far past 64 eps
F32_RULE_CASES = [("EnergyTriangleStrain", "Cubic"), ("contact_pt_dd", "Cubic"),
                  ("contact_ee_dr", "Log")]


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
