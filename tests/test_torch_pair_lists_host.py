"""Kernel I's box cull is sound: the g++ build of csrc/friction_pairs.cu (the
card's source, its lanes run in turn on the CPU; ops/build.py
`host_pairs_library`) lists, on the grids of
`stark_tpu_torch/tools/pair_grids.py`, built to sit where the cull's margin
matters (long edges far from the origin with points and edges millimetres
beside them, slivers, collapsed and parallel primitives, dhat set within
the margin of the partner's f64 distance):

- exactly what it lists with the cull off, where every allowed pair takes
  narrow.cuh's exact test, in float64 and float32 alike: the cull rejects
  no pair that the exact test in the dtype keeps;
- the plain twin's pairs. In float64 the lists (order, count, dhat) equal
  the twin's exactly, and d to the ulp by which torch's CPU sqrt misses a
  near-tie; in float32 a pair whose verdict f32 rounding decides (its f64
  distance within 64 eps of the scale of dhat) may be listed by one side
  only, as in chip_smoke.py's phase 16, and everything else is equal.
Both modes (friction with some mu = 0, contact), both kinds and both
capacities (cut, room for all) run.
"""
import pytest
import torch

from stark_tpu_torch.ops import friction_pairs as fp
from stark_tpu_torch.tools.pair_grids import grid, keys, rounding_decided

DTYPES = [torch.float64, torch.float32]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["contact", "friction"])
@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_lists_equal_twin(dtype, kind, mode, seed):
    """The g++ build of kernel I against its twin: f64 exactly, f32 up to
    rounding-decided pairs; both capacities; the cull skips most pairs."""
    V, table, allowed, meshes, mu, th, scale = grid(kind, dtype, seed)
    nt = allowed.shape[1]
    plains = {("friction", "pt"): fp.friction_pairs_pt_plain,
              ("friction", "ee"): fp.friction_pairs_ee_plain,
              ("contact", "pt"): fp.contact_pairs_pt_plain,
              ("contact", "ee"): fp.contact_pairs_ee_plain}
    mu_arg = mu if mode == "friction" else None
    for cap in (50, 10 ** 6):
        pre = (V, table, allowed, *meshes) + ((mu,) if mu_arg is not None else ())
        ref = plains[(mode, kind)](*pre, th, cap)
        out, n_exact = fp.host_lists(mode, kind, V, table, allowed, meshes, mu_arg, th, cap)
        n_allowed = int(allowed.sum())
        assert 0 < n_exact < n_allowed // 4, (n_exact, n_allowed)
        if dtype == torch.float64 or all(torch.equal(a, b) for a, b in zip(out, ref)):
            for a, b, what in zip(out, ref, ("q", "t", "d", "dhat", "count")):
                if what == "d":
                    # torch's CPU sqrt is not correctly rounded at near-ties
                    # (the card's and g++'s are): d may sit one ulp away
                    assert torch.all((a == b) | (torch.nextafter(b, a) == a)), cap
                else:
                    assert torch.equal(a, b), (what, cap)
            continue
        # f32: the lists agree but on rounding-decided pairs
        k_out, k_ref = keys(out, nt), keys(ref, nt)
        only = sorted(set(k_out) ^ set(k_ref))
        assert all(rounding_decided(kind, V, table, meshes, th, only, nt, scale)), only
        if cap > int(ref[4]):
            common = [k for k in k_ref if k in set(k_out)]
            assert [k for k in k_out if k in set(k_ref)] == common


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["contact", "friction"])
@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cull_drops_no_pair_the_exact_test_keeps(dtype, kind, mode, seed):
    """The host build with its cull against itself with the cull off (every
    allowed pair with a nonzero mu through narrow.cuh's exact test in the
    dtype): the lists are equal bit for bit, in f32 as in f64, at both
    capacities, while the cull sends under a quarter of the pairs on."""
    V, table, allowed, meshes, mu, th, _scale = grid(kind, dtype, seed)
    mu_arg = mu if mode == "friction" else None
    for cap in (50, 10 ** 6):
        out, n_exact = fp.host_lists(mode, kind, V, table, allowed, meshes, mu_arg, th, cap)
        every, n_every = fp.host_lists(mode, kind, V, table, allowed, meshes, mu_arg, th,
                                       cap, cull=False)
        for a, b, what in zip(out, every, ("q", "t", "d", "dhat", "count")):
            assert torch.equal(a, b), (what, cap)
        assert int(out[4]) > 0
        assert 0 < n_exact < n_every // 4, (n_exact, n_every)


@pytest.mark.parametrize("kind", ["pt", "ee"])
def test_f32_grid_reaches_inside_the_margin(kind):
    """The f32 grids are adversarial: the f32 twin keeps pairs whose f64
    distance lies above dhat, and the host build keeps them too."""
    V, table, allowed, meshes, mu, th, scale = grid(kind, torch.float32, 0)
    nt = allowed.shape[1]
    plain = fp.contact_pairs_pt_plain if kind == "pt" else fp.contact_pairs_ee_plain
    ref = plain(V, table, allowed, *meshes, th, 10 ** 6)
    out, _ = fp.host_lists("contact", kind, V, table, allowed, meshes, None, th, 10 ** 6)
    V64, th64 = V.double(), th.double()
    ref64 = plain(V64, table, allowed, *meshes, th64, 10 ** 6)
    above = set(keys(ref, nt)) - set(keys(ref64, nt))
    assert len(above) > 0
    assert above <= set(keys(out, nt))
