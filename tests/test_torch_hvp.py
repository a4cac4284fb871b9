"""Kernel B's twin (one launch per Hessian-vector product over several
groups) against stark_tpu's `hvp_ctx` and `hvp_bucket`, and kernel Z's
choice of layout.

The scene: the 6x6 spinning box with friction (mu = 1), its cloth lowered
onto the box so that the first state has live contact rows, in float64 on
the CPU. At that state both packages get the same element Hessians:
  * the staged solver's arity groups (`Evaluators.hvp_ctx`'s CPU path, the
    groups' products added in ascending arity) against JAX's `hvp_ctx`;
  * the fused solve's static bucket plus the live pool
    (`Evaluators.hvp_bucket`) against JAX's `hvp_bucket` over its single
    bucket (every row padded to the largest arity).
A seeded layout holds what the scene does not: one block in over 1,000
entries, empty rows, dummy column ids, a single group, the eight groups
one launch takes and nine distinct arities (two launches on the card). Tolerance: 1e-10 relative (sums in another order).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.solver import assembly as jas
from stark_tpu.solver.potential import PotentialFamily as JFamily
from stark_tpu_torch.ops import hvp_bucket as hb
from stark_tpu_torch.ops import pd_project as pd
from stark_tpu_torch.ops.segment_reduce import build_csr

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.max(np.abs(t - j))) / max(float(np.max(np.abs(j))), 1e-300)


@pytest.fixture(scope="module")
def box():
    """The 6x6 spinning box in contact: the Newton system at its first
    state (profile_linsolve.linear_system), float64."""
    from stark_tpu_torch.tools.profile_linsolve import linear_system
    from stark_tpu_torch.tools.scenes import spinning_box_cloth

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sim, cloth, _spin = spinning_box_cloth(6, "float64", "cpu", mu=1.0)
        cloth.point_set.add_displacement((0.0, 0.0, -0.0395))
        sim.stark._initialize()
        sim.stark.callbacks.run_before_time_step()
        nm = sim.stark.newton
        nm._topo = nm._ev.topology(sim._get_static_data(), dense=False)
        st = linear_system(sim)
    finally:
        torch.set_num_threads(n)
    p = np.random.default_rng(14).normal(size=(nm.n_blocks, 3))
    return SimpleNamespace(st=st, n=nm.n_blocks, p=p)


def _row_lengths(groups, n):
    return sum((c.offsets[1:] - c.offsets[:-1]).to(torch.int64) for _c, _H, c in groups)


def test_staged_groups_match_jax_hvp_ctx(box):
    """The staged solver's product over its arity groups (one launch on the
    card; on the CPU the groups' twins added in ascending arity) against
    JAX's hvp_ctx on the same tables and element Hessians."""
    st, n = box.st, box.n
    ev = st.ev
    groups = ev.staged_groups(st.data)
    assert len(groups) >= 4
    ctx = ev.hvp_context(groups, st.hess)
    q_t = ev.hvp_ctx(torch.as_tensor(box.p), ctx)
    # the CPU path is the twin over the groups, in ascending arity
    trip = [(ctx[a].conn32, ctx[a].H, ctx[a].csr) for a in sorted(ctx)]
    assert torch.equal(q_t, hb.hvp_groups_plain(torch.as_tensor(box.p), trip))
    assert int(_row_lengths(trip, n).max()) > 20
    fams = [JFamily(name, int(st.data[name]["conn"].shape[1]), None) for name in st.hess]
    jev = jas.make_evaluators(fams, n)
    jdata = {k: {"conn": jnp.asarray(st.data[k]["conn"].numpy()),
                 "rows": {"active": jnp.asarray(st.data[k]["rows"]["active"].numpy())}}
             for k in st.hess}
    jhess = {k: jnp.asarray(v.numpy()) for k, v in st.hess.items()}
    q_j = jax.jit(jev.hvp_ctx)(jnp.asarray(box.p), jev.hvp_context(jdata, jhess))
    assert _rel(q_t, q_j) < RTOL


def test_fused_site_with_pool_matches_jax_hvp_bucket(box):
    """The fused solve's product: the static bucket and the live pool in
    one call (the pool's product added second) against JAX's hvp_bucket
    over its single 15x15 bucket of the same rows."""
    st, n = box.st, box.n
    assert st.pool is not None and int(st.pool.csr.offsets[-1]) > 0
    q_t = st.ev.hvp_bucket(torch.as_tensor(box.p), st.H_stat, st.topo, st.pool)
    q_two = (hb.hvp_bucket_plain(torch.as_tensor(box.p), st.topo.conn_cat32, st.H_stat,
                                 st.topo.csr_cat)
             + hb.hvp_bucket_plain(torch.as_tensor(box.p), st.pool.conn32, st.pool.H,
                                   st.pool.csr))
    assert torch.equal(q_t, q_two)
    b = st.conn.shape[1]
    jev = jas.make_evaluators([JFamily("bucket", b, None)], n)
    cj = {b: jnp.asarray(st.conn.numpy())}
    q_j = jev.hvp_bucket(jnp.asarray(box.p), cj, {b: jnp.asarray(st.H.numpy())},
                         jev.scatter_rows(cj))
    assert _rel(q_t, q_j) < RTOL


def _seeded_groups(rng, n, arities, hot=7, hot_entries=1100):
    """Groups of the given arities over n blocks: block `hot` in
    `hot_entries` entries spread over the groups, 30 blocks in none, about
    one slot in ten the dummy id n (its Hessian rows and columns zero, as a
    padded slot's are); SPD element Hessians."""
    empty = rng.choice(np.setdiff1d(np.arange(n), [hot]), 30, replace=False)
    ids = np.setdiff1d(np.arange(n), empty)
    out = []
    for g, a in enumerate(arities):
        E = 40 + 10 * a
        conn = rng.choice(ids, size=(E, a))
        n_hot = hot_entries // len(arities) + (g < hot_entries % len(arities))
        conn = np.concatenate([conn, rng.choice(ids, size=(n_hot, a))])
        conn[-n_hot:, 0] = hot
        conn[rng.random(conn.shape) < 0.1] = n
        conn[-n_hot:, 0] = hot
        A = rng.normal(size=(len(conn), 3 * a, 3 * a))
        H = A @ A.transpose(0, 2, 1)
        dummy = np.repeat(conn == n, 3, axis=1)
        H[dummy[:, :, None] | dummy[:, None, :]] = 0.0
        out.append((conn.astype(np.int32), H))
    return out, empty


def _torch_groups(groups, n):
    return [(torch.as_tensor(c), torch.as_tensor(H), build_csr(torch.as_tensor(c).reshape(-1), n))
            for c, H in groups]


@pytest.mark.parametrize("arities", [(3,), (1, 2, 3, 4, 5, 6, 7, 8),
                                     (1, 2, 3, 4, 5, 6, 7, 8, 9)])
def test_seeded_groups_match_jax(arities):
    """A seeded layout (one row of over 1,000 entries, empty rows, dummy
    ids) as a single group, as the eight groups one launch takes and as
    nine arities (user families; two launches on the card), against JAX's
    hvp_ctx; the empty rows are exactly zero."""
    n = 300
    rng = np.random.default_rng(len(arities))
    groups, empty = _seeded_groups(rng, n, arities)
    tg = _torch_groups(groups, n)
    lens = _row_lengths(tg, n)
    assert int(lens[7]) > 1000 and int(lens[empty].max()) == 0
    p = rng.normal(size=(n, 3))
    pt = torch.as_tensor(p)
    q_t = hb.hvp_groups(pt, tg) if len(tg) > 1 else hb.hvp_bucket(pt, *tg[0])
    assert torch.equal(q_t, hb.hvp_groups_plain(pt, tg))
    assert torch.all(q_t[empty] == 0)
    fams = [JFamily(f"g{a}", a, None) for a in arities]
    jev = jas.make_evaluators(fams, n)
    ctx = {a: (jnp.asarray(c), jnp.asarray(H), jnp.ones(len(c), bool))
           for a, (c, H) in zip(arities, groups)}
    q_j = jax.jit(jev.hvp_ctx)(jnp.asarray(p), ctx)
    assert _rel(q_t, q_j) < RTOL


def test_no_groups_and_inconsistent_shapes_are_refused():
    """A product over no group, or over a group whose shapes disagree, is
    refused; nine groups of one arity are the twin's sum in order."""
    n = 50
    groups, _e = _seeded_groups(np.random.default_rng(0), n, (2,) * 9, hot_entries=20)
    tg = _torch_groups(groups, n)
    p = torch.as_tensor(np.random.default_rng(1).normal(size=(n, 3)))
    q = hb.hvp_groups_plain(p, tg[:8])
    assert torch.equal(hb.hvp_groups(p, tg), q + hb.hvp_bucket_plain(p, *tg[8]))
    with pytest.raises(ValueError, match="groups"):
        hb.hvp_groups(p, [])
    c, H, csr = tg[0]
    with pytest.raises(ValueError, match="inconsistent"):
        hb.hvp_groups(p, [(c, H[:, :3], csr)])


def _z_bytes(d, size):
    """A and V at row stride d | 1, three d-vectors, d + 1 ints."""
    ld = d if d % 2 else d + 1
    return 2 * d * ld * size + 3 * d * size + 4 * (d + 1)


@pytest.mark.parametrize("dtype,last_shared", [(torch.float32, 169), (torch.float64, 119)])
def test_z_layout_by_d_and_dtype(dtype, last_shared):
    """Kernel Z's layout: the warp layouts to d = 64, A and V in shared
    memory while they fit the 232,448 bytes a block may ask for (to d =
    169 in float32, 119 in float64), a global scratch buffer past that."""
    size = torch.empty((), dtype=dtype).element_size()
    assert pd.z_layout(3, dtype) == pd.z_layout(64, dtype) == "warp"
    for d in (65, 96, 112, last_shared):
        assert pd.z_layout(d, dtype) == "shared"
        assert _z_bytes(d, size) <= pd.Z_SHARED_BYTES
    for d in (last_shared + 1, last_shared + 2, 256):
        assert pd.z_layout(d, dtype) == "global"
        assert _z_bytes(d, size) > pd.Z_SHARED_BYTES


@pytest.mark.parametrize("d", [65, 96, 97])
def test_z_unit_table_covers_every_pair_once(d):
    """The shared layout's schedule by pair: every round covers each row
    once (a bye of an odd d as (i, i)), the rounds every pair once, in
    `_round_robin_rounds`' order."""
    units = pd._unit_table(d, torch.device("cpu"))
    rounds = pd._round_robin_rounds(d)
    assert units.shape == (len(rounds), (d + 1) // 2, 2)
    pairs = set()
    for r, pairs_r in zip(units.tolist(), rounds):
        assert sorted(i for pq in r for i in set(pq)) == list(range(d))
        real = [tuple(pq) for pq in r if pq[0] != pq[1]]
        assert real == list(pairs_r)
        pairs.update(real)
    assert len(pairs) == d * (d - 1) // 2
