"""DirectLLT's dense Hessian on the port against JAX's scatter loop.

`stark_tpu_torch` assembles DirectLLT's (3n, 3n) block-major matrix by
kernel A's direct site (`Evaluators.assemble_dense_direct`: a stable sort of
the block-pair keys, then one write per pair, summed in sorted order); on
the CPU its plain twin. `stark_tpu/solver/newton.py` `_direct_stage`
(:194-203) builds the same matrix by a sequence of `.at[].add` scatters,
written out here in `jnp` on the same numpy-seeded element Hessians.

Layouts: the 6x6 spinning box's families at step 0 (inertia, strain,
bending, the rigid box and its fix, the contact tables); the rigid
global-point and hinge scenes of `tools/rb_scenes.py` (several arities);
and a seeded layout of arities 1, 2 and 4 with dummy block ids, which
JAX's scatter drops on either axis.

Tolerance: float64 bit for bit (both add each pair's terms in the same
order, from zero); float32 within 64 eps sum|terms| plus the smallest
normal (XLA:CPU flushes f32 subnormals to zero).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu_torch.solver import assembly as tas
from stark_tpu_torch.solver.potential import PotentialFamily as TFamily


def jax_dense_direct(conns, hess, n, dtype):
    """stark_tpu/solver/newton.py:194-203, the scatter loop of
    `_direct_stage`, over {name: conn} and {name: H_e} in dict order."""
    H = jnp.zeros((n, 3, n, 3), dtype=dtype)
    for name, H_e in hess.items():
        conn = jnp.asarray(conns[name])
        a = conn.shape[1]
        Hb = jnp.asarray(H_e).reshape(H_e.shape[0], a, 3, a, 3)
        for i in range(a):
            for j in range(a):
                H = H.at[conn[:, i], :, conn[:, j], :].add(Hb[:, i, :, j, :])
    return np.asarray(H.reshape(3 * n, 3 * n))


def seeded_hessians(conns, seed):
    """Symmetric element Hessians (E, 3a, 3a) of mixed magnitudes."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, conn in conns.items():
        E, a = conn.shape
        A = rng.normal(size=(E, 3 * a, 3 * a))
        scale = 10.0 ** rng.integers(-4, 5, size=(E, 1, 1))
        out[name] = scale * (A + A.transpose(0, 2, 1))
    return out


def _scene_conns(sim):
    sim.stark._initialize()
    data = sim._get_data()
    return {k: v["conn"].numpy().astype(np.int64) for k, v in data.items()}, \
        sim.stark.newton.n_blocks


@functools.lru_cache(maxsize=None)
def _box():
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    sim, _c, _spin = spinning_box_cloth(6, "float64", "cpu")
    return _scene_conns(sim)


@functools.lru_cache(maxsize=None)
def _global_point():
    from stark_tpu_torch import Simulation
    from stark_tpu_torch.tools import rb_scenes

    sim = Simulation(rb_scenes.settings("global_point", "float64", "cpu", direct=True))
    b = rb_scenes.box(sim)
    sim.rigidbodies.add_constraint_global_point(b, b.get_translation())
    return _scene_conns(sim)


@functools.lru_cache(maxsize=None)
def _hinge():
    from stark_tpu_torch.tools import rb_scenes

    sim, _h = rb_scenes.hinge("float64", "cpu", direct=True)
    return _scene_conns(sim)


def _dummies():
    rng = np.random.default_rng(11)
    n = 23
    conns = {}
    for name, (E, a) in (("pair", (40, 2)), ("point", (30, 1)), ("quad", (25, 4))):
        c = rng.integers(0, n, size=(E, a))
        c[rng.random((E, a)) < 0.15] = n
        conns[name] = c
    return conns, n


LAYOUTS = {"box6": _box, "global_point": _global_point, "hinge": _hinge,
           "dummies": _dummies}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dense_direct_matches_jax(layout, dtype):
    """assemble_dense_direct (the CPU twin of kernel A's direct site)
    against JAX's scatter loop: f64 bit for bit, f32 by the sum rule."""
    conns, n = LAYOUTS[layout]()
    assert len({c.shape[1] for c in conns.values() if c.shape[0]}) >= 2
    hess = seeded_hessians(conns, seed=len(layout))
    hess = {k: v.astype(dtype) for k, v in hess.items()}
    ev = tas.Evaluators([TFamily(k, c.shape[1], None) for k, c in conns.items()], n)
    data = {k: {"conn": torch.as_tensor(c)} for k, c in conns.items()}
    got = ev.assemble_dense_direct(data, {k: torch.as_tensor(v) for k, v in hess.items()})
    want = jax_dense_direct(conns, hess, n, dtype)
    got = got.numpy()
    assert got.shape == want.shape == (3 * n, 3 * n) and got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_array_equal(got, want)
    else:
        absref = jax_dense_direct(conns, {k: np.abs(v) for k, v in hess.items()}, n,
                                  np.float64)
        tol = 64 * np.finfo(dtype).eps * absref + np.finfo(dtype).tiny
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
