"""Branchless IPC narrow phase: distance regions, distances, friction
geometry, intersection.

Port of `stark_tpu/collision/narrow_phase.py`. Every function works on
(..., 3) tensors: unbatched under `torch.func.vmap` (the contact energies),
or batched over flat candidate rows (the plain twins of kernels G, H and J,
ops/narrow.py, ops/segment_triangle.py, ops/friction_rows.py). The integer
region code selects the smooth formula through a one-hot masked sum, so
`torch.func` derivatives flow only through the selected formula and no
data-dependent indexing enters the autodiff graph.

NaN-safety: every candidate formula is evaluated for every row, and reverse
mode multiplies a zero cotangent into each unselected one; 0*inf is NaN, so
each division uses the double-where guard (`_guarded_div`) and the floors
`_TINY` / `_parallel_tol` are representable in float32.

PT region codes: 0,1,2 = vertex t0/t1/t2; 3,4,5 = edge (t0t1), (t1t2),
(t2t0); 6 = face. EE region codes (ipc bit layout): 0 EA0_EB0, 1 EA0_EB1,
2 EA1_EB0, 3 EA1_EB1, 4 EA_EB0, 5 EA_EB1, 6 EA0_EB, 7 EA1_EB, 8 EA_EB.
"""
from __future__ import annotations

import torch

_TINY = 1e-35


def _parallel_tol(dtype) -> float:
    """Relative cross-norm^2 cutoff (sin^2 of the angle) below which two
    edges count as parallel: 1e-4 in float32 (the classifier's own
    cancellation floor), 1e-20 in float64."""
    return 1e-4 if torch.finfo(dtype).bits == 32 else 1e-20


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _guarded_div(num, den, floor):
    ok = den > floor
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _select(cands, region, n: int):
    """cands (..., n) -> the entry at `region` via a one-hot masked sum."""
    oh = (region[..., None] == torch.arange(n, device=region.device))
    return torch.sum(cands * oh.to(cands.dtype), dim=-1)


def _select_rows(cands, region, n: int):
    """cands (..., n, *s) -> the (*s) entry at `region` along the n axis, by
    the same one-hot masked sum."""
    oh = (region[..., None] == torch.arange(n, device=region.device)).to(cands.dtype)
    oh = oh.reshape(oh.shape + (1,) * (cands.dim() - oh.dim()))
    return torch.sum(cands * oh, dim=region.dim())


def _normalized(v):
    """v / |v| with maths.normalized's 1e-12 floor on |v|^2."""
    return v / torch.sqrt(torch.clamp_min(_dot(v, v), 1e-12))[..., None]


def _sq_point_point(p, q):
    d = p - q
    return _dot(d, d)


def _sq_point_line(p, a, b):
    ab = b - a
    ap = p - a
    e = _dot(ap, ab)
    return _dot(ap, ap) - _guarded_div(e * e, _dot(ab, ab), _TINY)


def _sq_point_line_projected(p, a, b):
    """_sq_point_line's value as |ap - s ab|^2 with s = ap.ab / |ab|^2. The
    difference of squares loses ~eps |ap|^2 to cancellation, which beside a
    long edge is the whole square of a contact gap (a point 2 mm from a 2 m
    edge: ~5% of d^2 in float32, ~1e-10 in float64); this form errs by
    ~eps |ap| d. The contact energies' form (`projected=True`)."""
    ab = b - a
    ap = p - a
    s = _guarded_div(_dot(ap, ab), _dot(ab, ab), _TINY)
    c = ap - s[..., None] * ab
    return _dot(c, c)


def _sq_point_plane(p, a, b, c):
    n = _cross(a - c, b - c)
    d = _dot(p - a, n)
    return _guarded_div(d * d, _dot(n, n), _TINY)


def _sq_line_line(a, b, p, q):
    # parallel pairs are routed to the point-line regions; the guard floor
    # is the dtype default whatever cutoff the classifier was given
    u = b - a
    v = q - p
    n = _cross(u, v)
    l = _dot(p - a, n)
    floor = _parallel_tol(a.dtype) * _dot(u, u) * _dot(v, v)
    return _guarded_div(l * l, _dot(n, n), torch.clamp_min(floor, _TINY))


def _first_true(conds, codes, default: int, like):
    """jnp.select: the code of the first true condition, else `default`."""
    out = torch.full(like.shape, default, dtype=torch.int64, device=like.device)
    for cond, code in reversed(list(zip(conds, codes))):
        out = torch.where(cond, torch.full_like(out, code), out)
    return out


# ---------------------------------------------------------------------------
# point - triangle
# ---------------------------------------------------------------------------
def _edge_param(p, e0, e1, n):
    e = e1 - e0
    s = _dot(p - e0, e) / torch.clamp_min(_dot(e, e), _TINY)
    o = _dot(p - e0, _cross(e, n))
    return s, o


def point_triangle_region(p, t0, t1, t2):
    n = _cross(t1 - t0, t2 - t0)
    s0, o0 = _edge_param(p, t0, t1, n)
    s1, o1 = _edge_param(p, t1, t2, n)
    s2, o2 = _edge_param(p, t2, t0, n)
    conds = [
        (s0 > 0.0) & (s0 < 1.0) & (o0 >= 0.0),
        (s1 > 0.0) & (s1 < 1.0) & (o1 >= 0.0),
        (s2 > 0.0) & (s2 < 1.0) & (o2 >= 0.0),
        (s0 <= 0.0) & (s2 >= 1.0),
        (s1 <= 0.0) & (s0 >= 1.0),
        (s2 <= 0.0) & (s1 >= 1.0),
    ]
    return _first_true(conds, [3, 4, 5, 0, 1, 2], 6, s0)


def point_triangle_sq_distance(p, t0, t1, t2, region=None, projected: bool = False):
    """`projected` takes the point-edge regions' squared distance as
    _sq_point_line_projected (the contact energies), else as the reference's
    difference of squares (the pair lists' twins, as their kernels round)."""
    if region is None:
        region = point_triangle_region(p, t0, t1, t2)
    line = _sq_point_line_projected if projected else _sq_point_line
    cands = torch.stack([
        _sq_point_point(p, t0),
        _sq_point_point(p, t1),
        _sq_point_point(p, t2),
        line(p, t0, t1),
        line(p, t1, t2),
        line(p, t2, t0),
        _sq_point_plane(p, t0, t1, t2),
    ], dim=-1)
    return _select(cands, region, 7)


def point_triangle_distance(p, t0, t1, t2, region=None, projected: bool = False):
    return torch.sqrt(torch.clamp_min(
        point_triangle_sq_distance(p, t0, t1, t2, region, projected), _TINY))


# ---------------------------------------------------------------------------
# friction geometry (friction_geometry.cpp): closest-point weights and the
# 2x3 tangent projection, per region
# ---------------------------------------------------------------------------
def _bary_point_edge(p, a, b):
    ab = b - a
    alpha = _dot(p - a, ab) / torch.clamp_min(_dot(ab, ab), _TINY)
    return 1.0 - alpha, alpha


def point_triangle_bary(p, t0, t1, t2, region):
    """(..., 3) barycentric weights on (t0, t1, t2) of the closest point for
    the given region; the face region uses the full (Ericson) form."""
    u0, v0 = _bary_point_edge(p, t0, t1)
    u1, v1 = _bary_point_edge(p, t1, t2)
    u2, v2 = _bary_point_edge(p, t2, t0)
    e0 = t1 - t0
    e1 = t2 - t0
    e2 = p - t0
    d00, d01, d11 = _dot(e0, e0), _dot(e0, e1), _dot(e1, e1)
    d20, d21 = _dot(e2, e0), _dot(e2, e1)
    denom = torch.clamp_min(d00 * d11 - d01 * d01, _TINY)
    fv = (d11 * d20 - d01 * d21) / denom
    fw = (d00 * d21 - d01 * d20) / denom
    fu = 1.0 - fv - fw
    one, zz = torch.ones_like(fu), torch.zeros_like(fu)
    cands = torch.stack([
        torch.stack([one, zz, zz], -1),
        torch.stack([zz, one, zz], -1),
        torch.stack([zz, zz, one], -1),
        torch.stack([u0, v0, zz], -1),
        torch.stack([zz, u1, v1], -1),
        torch.stack([v2, zz, u2], -1),
        torch.stack([fu, fv, fw], -1),
    ], dim=-2)
    return _select_rows(cands, region, 7)


def _proj_point_point(p, q):
    # projection_matrix_point_point: the helper axis switches at n_z = 0.99
    n = _normalized(p - q)
    ez = torch.zeros_like(n)
    ez[..., 2] = 1.0
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    e = torch.where((n[..., 2] < 0.99)[..., None], ez, ex)
    u = _normalized(_cross(e, n))
    v = _normalized(_cross(u, n))
    return torch.stack([u, v], dim=-2)


def _proj_point_edge(p, a, b):
    u = _normalized(b - a)
    v = _normalized(_cross(u, p - a))
    return torch.stack([u, v], dim=-2)


def _proj_triangle(a, b, c):
    v01 = a - c
    v02 = b - c
    u = _normalized(v01)
    v = _normalized(_cross(_cross(v01, v02), u))
    return torch.stack([u, v], dim=-2)


def _proj_edge_edge(a, b, p, q):
    u = _normalized(b - a)
    v = _normalized(_cross(u, _cross(u, q - p)))
    return torch.stack([u, v], dim=-2)


def point_triangle_T(p, t0, t1, t2, region):
    """(..., 2, 3) tangent projection for PT friction, per region."""
    cands = torch.stack([
        _proj_point_point(p, t0),
        _proj_point_point(p, t1),
        _proj_point_point(p, t2),
        _proj_point_edge(p, t0, t1),
        _proj_point_edge(p, t1, t2),
        _proj_point_edge(p, t2, t0),
        _proj_triangle(t0, t1, t2),
    ], dim=-3)
    return _select_rows(cands, region, 7)


# ---------------------------------------------------------------------------
# edge - edge
# ---------------------------------------------------------------------------
def edge_edge_region(ea0, ea1, eb0, eb1, parallel_tol=None):
    """ipc edge_edge_distance_type. `parallel_tol` is relative (sin^2 of
    the angle); None picks the dtype default."""
    u = ea1 - ea0
    v = eb1 - eb0
    w = ea0 - eb0
    a = _dot(u, u)
    b = _dot(u, v)
    c = _dot(v, v)
    d = _dot(u, w)
    e = _dot(v, w)
    D = torch.clamp_min(a * c - b * b, 0.0)
    cuv = _cross(u, v)
    cross_sq = _dot(cuv, cuv)
    if parallel_tol is None:
        parallel_tol = _parallel_tol(ea0.dtype)
    parallel = cross_sq < parallel_tol * a * c

    def pick(cond, x, y):
        return torch.where(cond, x, y)

    def const(v_):
        return torch.full(a.shape, v_, dtype=torch.int64, device=a.device)

    # non-parallel path
    sN = b * e - c * d
    low = sN <= 0.0
    high = sN >= D
    tN = pick(low, e, pick(high, e + b, a * e - b * d))
    tD = pick(low | high, c, D)
    default_code = pick(low, const(6), pick(high, const(7), const(8)))
    t_low = tN <= 0.0
    t_high = tN >= tD
    code_tlow = pick(-d <= 0.0, const(0), pick(-d >= a, const(2), const(4)))
    code_thigh = pick(-d + b <= 0.0, const(1),
                      pick(-d + b >= a, const(3), const(5)))
    np_code = pick(t_low, code_tlow, pick(t_high, code_thigh, default_code))

    # parallel path
    am = torch.clamp_min(a, _TINY)
    alpha = _dot(eb0 - ea0, u) / am
    beta = _dot(eb1 - ea0, u) / am
    in01 = (0.0 <= beta) & (beta <= 1.0)
    eac = pick(alpha < 0.0, pick(in01, const(2), const(0)),
               pick(alpha > 1.0, pick(in01, const(2), const(1)), const(2)))
    ebc = pick(alpha < 0.0,
               pick(beta <= alpha, const(0), pick(beta <= 1.0, const(1), const(2))),
               pick(alpha > 1.0,
                    pick(beta >= alpha, const(0),
                         pick(0.0 <= beta, const(1), const(2))),
                    const(0)))
    par_code = pick(ebc < 2, (eac * 2) | ebc, 6 + eac)
    return pick(parallel, par_code, np_code)


def edge_edge_sq_distance(ea0, ea1, eb0, eb1, region=None, parallel_tol=None,
                          projected: bool = False):
    """`projected`: as point_triangle_sq_distance's."""
    if region is None:
        region = edge_edge_region(ea0, ea1, eb0, eb1, parallel_tol)
    line = _sq_point_line_projected if projected else _sq_point_line
    cands = torch.stack([
        _sq_point_point(ea0, eb0),
        _sq_point_point(ea0, eb1),
        _sq_point_point(ea1, eb0),
        _sq_point_point(ea1, eb1),
        line(eb0, ea0, ea1),
        line(eb1, ea0, ea1),
        line(ea0, eb0, eb1),
        line(ea1, eb0, eb1),
        _sq_line_line(ea0, ea1, eb0, eb1),
    ], dim=-1)
    return _select(cands, region, 9)


def edge_edge_distance(ea0, ea1, eb0, eb1, region=None, parallel_tol=None,
                       projected: bool = False):
    return torch.sqrt(torch.clamp_min(
        edge_edge_sq_distance(ea0, ea1, eb0, eb1, region, parallel_tol, projected), _TINY))


def edge_edge_params(ea0, ea1, eb0, eb1, region):
    """(s, t) line parameters of the closest points for EE friction anchors:
    the point-point and point-edge regions pin an endpoint parameter, the
    edge-edge region takes the unclamped line-line solution (0.5 each when
    the edges are parallel to the dtype's relative tolerance)."""
    da = ea1 - ea0
    db = eb1 - eb0
    r = ea0 - eb0
    a = _dot(da, da)
    e = _dot(db, db)
    f = _dot(db, r)
    b = _dot(da, db)
    c = _dot(da, r)
    denom = a * e - b * b
    degen = denom < _parallel_tol(da.dtype) * a * e
    half = torch.full_like(a, 0.5)
    s_ll = torch.where(degen, half,
                       (b * f - c * e) / torch.where(degen, torch.ones_like(denom), denom))
    t_ll = torch.where(degen, half, (b * s_ll + f) / torch.clamp_min(e, _TINY))
    _, t_a0 = _bary_point_edge(ea0, eb0, eb1)
    _, t_a1 = _bary_point_edge(ea1, eb0, eb1)
    _, s_b0 = _bary_point_edge(eb0, ea0, ea1)
    _, s_b1 = _bary_point_edge(eb1, ea0, ea1)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    # 0 EA0_EB0 (0,0); 1 EA0_EB1 (0,1); 2 EA1_EB0 (1,0); 3 EA1_EB1 (1,1);
    # 4 EA_EB0 (eb0 on ea, 0); 5 EA_EB1 (eb1 on ea, 1); 6 EA0_EB (0, ea0 on
    # eb); 7 EA1_EB (1, ea1 on eb); 8 EA_EB line-line
    s_c = torch.stack([zero, zero, one, one, s_b0, s_b1, zero, one, s_ll], -1)
    t_c = torch.stack([zero, one, zero, one, zero, one, t_a0, t_a1, t_ll], -1)
    return _select(s_c, region, 9), _select(t_c, region, 9)


def edge_edge_T(ea0, ea1, eb0, eb1, region):
    """(..., 2, 3) tangent projection for EE friction, per region."""
    cands = torch.stack([
        _proj_point_point(ea0, eb0),
        _proj_point_point(ea0, eb1),
        _proj_point_point(ea1, eb0),
        _proj_point_point(ea1, eb1),
        _proj_point_edge(eb0, ea0, ea1),
        _proj_point_edge(eb1, ea0, ea1),
        _proj_point_edge(ea0, eb0, eb1),
        _proj_point_edge(ea1, eb0, eb1),
        _proj_edge_edge(ea0, ea1, eb0, eb1),
    ], dim=-3)
    return _select_rows(cands, region, 9)


def edge_edge_mollifier(ea0, ea1, eb0, eb1, EA0, EA1, EB0, EB1):
    """IPC edge-edge mollifier, eps_x = 1e-3 |EA|^2 |EB|^2 at REST."""
    eps_x = 1e-3 * _dot(EA0 - EA1, EA0 - EA1) * _dot(EB0 - EB1, EB0 - EB1)
    c = _cross(ea1 - ea0, eb1 - eb0)
    x = _dot(c, c)
    x_div = x / torch.clamp_min(eps_x, _TINY)
    f = (-x_div + 2.0) * x_div
    return torch.where(x > eps_x, torch.ones_like(f), f)


# ---------------------------------------------------------------------------
# edge - triangle intersection (the penetration-free oracle)
# ---------------------------------------------------------------------------
def segment_triangle_intersects(p0, p1, t0, t1, t2):
    """Boolean segment-triangle intersection (Moller-Trumbore, inclusive)
    with the relative parallel test."""
    d = p1 - p0
    e1 = t1 - t0
    e2 = t2 - t0
    h = _cross(d, e2)
    a = _dot(e1, h)
    scale_sq = _dot(e1, e1) * _dot(h, h)
    not_parallel = a * a > torch.clamp_min(_parallel_tol(p0.dtype) * scale_sq, _TINY)
    f = 1.0 / torch.where(not_parallel, a, torch.ones_like(a))
    s = p0 - t0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0) & (t <= 1.0)
    return hit & not_parallel
