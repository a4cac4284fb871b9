"""JAX's gather-table and dense-direct helpers against their port twins.

stark_tpu/solver/assembly.py's `scatter_table`, `hvp_table`,
`scatter_table_rows`, `direct_tables`, `assemble_dense_perm`,
`dense_inverse` and `direct_solve` (kernels AA, AB and AC in the port, run
by `stark_tpu_torch.tools.profile_linsolve`) on the same numpy inputs: a
seeded random single-bucket layout (dummy ids and inactive rows included)
and the single bucket of a 6x6 spinning box at step 0 (its live pool empty,
all dummy rows), in float64 and float32.

Tolerances: the tables bit for bit (overflow signals included); the
hvp and the dense assembly within 64 eps sum|terms| (sums in another
order); dense_inverse within 64 eps cond(Hs) max|M| with the same `ok`;
direct_solve within 1e-10 relative in float64 (64 eps cond in float32).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.solver import assembly as jas
from stark_tpu.solver.potential import PotentialFamily as JFamily
from stark_tpu_torch.ops import dense_runs as dr
from stark_tpu_torch.ops import hvp_table as ht
from stark_tpu_torch.solver import assembly as tas
from stark_tpu_torch.solver.potential import PotentialFamily as TFamily


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JIT = {}


def _evs(n_blocks, b):
    """(JAX helpers jitted, port Evaluators) of a single bucket of arity b."""
    key = (n_blocks, b)
    if key not in _JIT:
        jev = jas.make_evaluators([JFamily("bucket", b, None)], n_blocks)
        _JIT[key] = SimpleNamespace(
            scatter_table=jax.jit(jev.scatter_table, static_argnums=1),
            scatter_table_rows=jax.jit(jev.scatter_table_rows, static_argnums=(1, 2, 3)),
            direct_tables=jax.jit(jev.direct_tables, static_argnums=1),
            hvp_table=jax.jit(jev.hvp_table),
            assemble_dense_perm=jax.jit(jev.assemble_dense_perm),
            dense_inverse=jax.jit(jev.dense_inverse),
            direct_solve=jax.jit(jev.direct_solve))
    return _JIT[key], tas.Evaluators([TFamily("bucket", b, None)], n_blocks)


def _tol(absref, dtype):
    """64 eps sum|terms|, plus the smallest normal: XLA:CPU flushes f32
    subnormals to zero."""
    return 64 * np.finfo(dtype).eps * absref + np.finfo(dtype).tiny


def random_layout(seed=0, n_blocks=40, E=96, b=4):
    """A single bucket: random block ids with dummy slots (id n_blocks) and
    inactive rows routed to the dummy, block-diagonally dominant SPD element
    Hessians."""
    rng = np.random.default_rng(seed)
    conn = rng.integers(0, n_blocks, size=(E, b))
    conn[rng.random((E, b)) < 0.1] = n_blocks
    act = rng.random(E) < 0.9
    conn[~act] = n_blocks
    A = rng.normal(size=(E, 3 * b, 3 * b))
    H = A @ A.transpose(0, 2, 1) + 3 * b * np.eye(3 * b)
    dummy = np.repeat(conn == n_blocks, 3, axis=1)
    H[dummy[:, :, None] | dummy[:, None, :]] = 0.0
    return conn.astype(np.int32), H, act


@pytest.fixture(scope="module")
def box_layout():
    """The 6x6 spinning box's single bucket at step 0 (f64)."""
    from stark_tpu_torch.tools.profile_linsolve import linear_system
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    torch.set_num_threads(1)
    sim, _c, _spin = spinning_box_cloth(6, "float64", "cpu")
    sim.stark._initialize()
    sim.stark.callbacks.run_before_time_step()
    nm = sim.stark.newton
    nm._topo = nm._ev.topology(sim._get_static_data(), dense=True)
    st = linear_system(sim)
    return (st.conn.numpy().astype(np.int32), st.H.numpy(), np.ones(st.conn.shape[0], bool),
            st.grad.numpy(), nm.n_blocks)


def _layouts(box_layout):
    conn, H, act = random_layout()
    yield "random", conn, H, act, 40
    c, Hb, a, _g, n = box_layout
    yield "box6", c, Hb, a, n


def _jctx(conn, H, act):
    return {conn.shape[1]: (jnp.asarray(conn), jnp.asarray(H), jnp.asarray(act))}


def _tctx(conn, H, act):
    return {conn.shape[1]: (torch.as_tensor(conn), torch.as_tensor(H), torch.as_tensor(act))}


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t).astype(np.int64), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("K", [4, 128])
def test_tables_match_jax_bit_for_bit(box_layout, K):
    """scatter_table, scatter_table_rows and direct_tables equal JAX's; at
    K = 4 runs exceed K (max_len > K) and more blocks are hot than the side
    table holds (hot_n > hot_cap)."""
    for name, conn, H, act, n in _layouts(box_layout):
        jev, tev = _evs(n, conn.shape[1])
        e_j, R_j, m_j = jev.scatter_table(_jctx(conn, H, act), K)
        e_t, R_t, m_t = tev.scatter_table(_tctx(conn, H, act), K)
        assert R_t == int(R_j)
        _eq(e_t, e_j)
        _eq(m_t, m_j)
        if K == 4:
            assert int(m_t) > K, name
        rows = np.where(act[:, None], conn, n).reshape(-1)
        hot_cap, K2 = 2, 8
        out_j = jev.scatter_table_rows(jnp.asarray(rows), K, hot_cap, K2)
        out_t = tev.scatter_table_rows(torch.as_tensor(rows), K, hot_cap, K2)
        for a, b in zip(out_t, out_j):
            _eq(a, b)
        if K == 4:
            assert int(out_t[3]) > hot_cap, name
        for slot_cap in (64, 1 << 16):
            d_j = jev.direct_tables({conn.shape[1]: jnp.asarray(conn)}, slot_cap)
            d_t = tev.direct_tables(torch.as_tensor(conn), slot_cap)
            for a, b in zip(d_t, d_j):
                _eq(a, b)
            assert (int(d_t.n_slots) > slot_cap) == (slot_cap == 64), name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hvp_table_and_dense_assembly_match_jax(box_layout, dtype):
    """hvp_table and assemble_dense_perm within 64 eps sum|terms|; the
    dense direct matrix (kernel AC's block-major layout) is JAX's through
    direct_solve below."""
    eps = np.finfo(dtype).eps
    for name, conn, H, act, n in _layouts(box_layout):
        H = H.astype(dtype)
        jev, tev = _evs(n, conn.shape[1])
        p = np.random.default_rng(1).normal(size=(n, 3)).astype(dtype)
        e_t, _R, _m = tev.scatter_table(_tctx(conn, H, act), 128)
        q_j = jev.hvp_table(jnp.asarray(p), _jctx(conn, H, act), jnp.asarray(e_t.numpy()))
        q_t = tev.hvp_table(torch.as_tensor(p), _tctx(conn, H, act), e_t)
        absref = ht.hvp_table_plain(torch.as_tensor(np.abs(p)).double(),
                                    [(torch.as_tensor(conn), torch.as_tensor(np.abs(H)).double())],
                                    e_t).numpy()
        assert np.all(np.abs(q_t.numpy() - np.asarray(q_j)) <= _tol(absref, dtype)), name
        d_j = jev.direct_tables({conn.shape[1]: jnp.asarray(conn)}, 1 << 16)
        d_t = tev.direct_tables(torch.as_tensor(conn), 1 << 16)
        Hp_j = jev.assemble_dense_perm({conn.shape[1]: jnp.asarray(H)}, d_j)
        Hp_t = tev.assemble_dense_perm(torch.as_tensor(H), d_t)
        absref = dr.dense_runs_plain(torch.as_tensor(np.abs(H)).double(), d_t, n, dr.PERM)
        assert np.all(np.abs(Hp_t.numpy() - np.asarray(Hp_j))
                      <= _tol(absref.numpy(), dtype)), name


def _scaled_cond(Hp):
    dg = np.diag(Hp)
    s = np.where(dg > 1e-30, 1.0 / np.sqrt(np.maximum(dg, 1e-30)), 1.0)
    Hs = Hp * s[:, None] * s[None, :] + np.diag(np.where(dg > 1e-30, 0.0, 1.0))
    return float(np.linalg.cond(Hs)), s


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_inverse_matches_jax(box_layout, dtype):
    """dense_inverse within 64 eps cond(Hs) max|M|, `ok` equal; an
    indefinite H takes JAX's diag(s^2) with ok False on both sides."""
    eps = np.finfo(dtype).eps
    for name, conn, H, act, n in _layouts(box_layout):
        jev, tev = _evs(n, conn.shape[1])
        d_t = tev.direct_tables(torch.as_tensor(conn), 1 << 16)
        d_j = jev.direct_tables({conn.shape[1]: jnp.asarray(conn)}, 1 << 16)
        for indefinite in (False, True):
            Hc = H.copy()
            if indefinite:
                Hc[::7] *= -4.0
            Hc = Hc.astype(dtype)
            M_j, ok_j = jev.dense_inverse({conn.shape[1]: jnp.asarray(Hc)}, d_j)
            M_t, ok_t = tev.dense_inverse(torch.as_tensor(Hc), d_t)
            assert bool(ok_t) == bool(ok_j) == (not indefinite), name
            M_j = np.asarray(M_j, dtype=np.float64)
            if indefinite:
                Hp = tev.assemble_dense_perm(torch.as_tensor(Hc), d_t).double().numpy()
                _c, s = _scaled_cond(Hp)
                np.testing.assert_allclose(M_t.double().numpy(), np.diag(s * s), rtol=4 * eps)
                np.testing.assert_allclose(M_j, np.diag(s * s), rtol=4 * eps)
                continue
            Hp = tev.assemble_dense_perm(torch.as_tensor(Hc).double(), d_t).numpy()
            cond, _s = _scaled_cond(Hp)
            err = np.max(np.abs(M_t.double().numpy() - M_j))
            assert err <= 64 * eps * cond * np.max(np.abs(M_j)), (name, err, cond)


def test_direct_solve_matches_jax(box_layout):
    """direct_solve (f64 run sums, Jacobi-scaled Cholesky) within 1e-10
    relative in float64, 64 eps cond in float32; an indefinite H fails on
    both sides and returns zeros."""
    for name, conn, H, act, n in _layouts(box_layout):
        jev, tev = _evs(n, conn.shape[1])
        d_t = tev.direct_tables(torch.as_tensor(conn), 1 << 16)
        d_j = jev.direct_tables({conn.shape[1]: jnp.asarray(conn)}, 1 << 16)
        g = np.random.default_rng(2).normal(size=(n, 3))
        for dtype, tol in ((np.float64, 1e-10), (np.float32, None)):
            Hc = H.astype(dtype)
            du_j, ok_j = jev.direct_solve(jnp.asarray(g.astype(dtype)),
                                          {conn.shape[1]: jnp.asarray(Hc)}, d_j)
            du_t, ok_t = tev.direct_solve(torch.as_tensor(g.astype(dtype)),
                                          torch.as_tensor(Hc), d_t)
            assert bool(ok_t) and bool(ok_j), name
            du_j = np.asarray(du_j, dtype=np.float64)
            rel = np.max(np.abs(du_t.double().numpy() - du_j)) / np.max(np.abs(du_j))
            if tol is None:
                cond, _s = _scaled_cond(tev.assemble_dense_perm(
                    torch.as_tensor(H), d_t).numpy())
                tol = 64 * np.finfo(dtype).eps * cond
            assert rel <= tol, (name, dtype, rel)
        Hc = H.copy()
        Hc[::5] *= -4.0
        du_j, ok_j = jev.direct_solve(jnp.asarray(g), {conn.shape[1]: jnp.asarray(Hc)}, d_j)
        du_t, ok_t = tev.direct_solve(torch.as_tensor(g), torch.as_tensor(Hc), d_t)
        assert not bool(ok_t) and not bool(ok_j), name
        assert not torch.any(du_t != 0) and not np.any(np.asarray(du_j) != 0)
