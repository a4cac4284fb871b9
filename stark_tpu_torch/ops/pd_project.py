"""Kernels C and Z: batched PD projection by parallel-order Jacobi
(csrc/pd_project.cu) and their plain twins.

Kernel C replaces stark_tpu/solver/project.py `_jacobi_eigh` (:53-113) and
`project_family_to_pd` (:122-141). Its twin keeps the JAX function's
arithmetic: the round-robin schedule of `_round_robin_rounds`, the same
rotation angle and the same sweep count, in a (d, d, E) layout where every
round is two full-tensor passes; `batched_eigh` takes exact `torch.linalg.eigh`
when sweeps == 0 or d <= 3, exactly as `project.batched_eigh` does (the CPU
route). On CUDA every d <= 16 goes through the kernel (`pd_project`),
16 < d <= 64 through its one-warp-per-block layout (`pd_project_wide`).

Kernel Z (`pd_project_z`) serves what C does not on the card: the exact
eigh of `batched_eigh` (jacobi_sweeps = 0, or d <= 3), as Jacobi run to
convergence (each matrix sweeps until every |a_ik| <= eps max_j |a_jj|
above the diagonal, then once more; at most Z_MAX_SWEEPS sweeps), which a CUDA graph can capture where
cuSOLVER's eigh cannot; and JAX's fixed-sweep `_jacobi_eigh` at d > 64 (a
block per matrix, A and V in shared memory where they fit, else in a global
scratch buffer: `z_layout`). Its twin is
`_jacobi_eigh_converged`: the same schedule and angle with the same stop
test. A matrix still unconverged after Z_MAX_SWEEPS sweeps adds one to the
caller's `unconverged` counter on the device; the solvers read it with their
existing host read and raise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import build

# the largest matrix of the kernel's four-warp layout (`pd_project`) and of
# its one-warp layout (`pd_project_wide`)
KERNEL_MAX_D = 16
KERNEL_WIDE_MAX_D = 64
# kernel Z: the converged mode's sweep limit; its global wide layout keeps
# cr, sr, the clamped eigenvalues and the partners in 48 KB of shared
# memory, and walks at most Z_WIDE_GRID blocks over the matrices; its
# shared wide layout takes what a block may ask for on sm_90
Z_MAX_SWEEPS = 30
Z_MAX_D = 1536
Z_WIDE_GRID = 264
Z_SHARED_BYTES = 232448


def _round_robin_rounds(d: int):
    """Parallel Jacobi (round-robin / 'chess tournament') schedule: a list
    of rounds, each a list of DISJOINT (p, q) pairs covering all d*(d-1)/2
    pairs across the rounds. Even d: d-1 rounds of d/2 pairs; odd d: d
    rounds with one index sitting out each round."""
    idx = list(range(d))
    if d % 2 == 1:
        idx.append(-1)          # bye slot
    n = len(idx)
    rounds = []
    for _ in range(n - 1):
        pairs = []
        for i in range(n // 2):
            a, b = idx[i], idx[n - 1 - i]
            if a >= 0 and b >= 0:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _round_tables(d: int):
    """Per-round (p_idx, q_idx, perm, slot, sgn, paired) numpy tables."""
    tables = []
    for pairs in _round_robin_rounds(d):
        perm = list(range(d))
        slot = [0] * d
        sgn = [0.0] * d
        paired = [False] * d
        for k, (p, q) in enumerate(pairs):
            perm[p], perm[q] = q, p
            slot[p] = slot[q] = k
            sgn[p], sgn[q] = -1.0, 1.0
            paired[p] = paired[q] = True
        tables.append((np.asarray([p for p, _ in pairs]),
                       np.asarray([q for _, q in pairs]),
                       np.asarray(perm), np.asarray(slot), np.asarray(sgn),
                       np.asarray(paired)))
    return tables


@functools.lru_cache(maxsize=None)
def _round_tables_on(d: int, device: torch.device):
    """_round_tables as tensors on `device`, made once (a copy from the host
    cannot be captured into a CUDA graph)."""
    return [tuple(torch.as_tensor(x, device=device) for x in t)
            for t in _round_tables(d)]


@functools.lru_cache(maxsize=None)
def _partner_table(d: int, device: torch.device) -> torch.Tensor:
    """(n_rounds, d) int32: the partner of each row per round (itself for a
    bye) — the kernel's copy of the schedule."""
    rows = []
    for pairs in _round_robin_rounds(d):
        partner = list(range(d))
        for p, q in pairs:
            partner[p], partner[q] = q, p
        rows.append(partner)
    return torch.as_tensor(np.asarray(rows, dtype=np.int32).reshape(-1, d),
                           device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _unit_table(d: int, device: torch.device) -> torch.Tensor:
    """(n_rounds, (d + 1) // 2, 2) int32: each round's pairs (p, q) in
    schedule order, then the bye (i, i) of an odd d — the shared wide
    layout's copy of the schedule."""
    rounds = []
    for pairs in _round_robin_rounds(d):
        seen = {i for pq in pairs for i in pq}
        rounds.append(list(pairs) + [(i, i) for i in range(d) if i not in seen])
    return torch.as_tensor(np.asarray(rounds, dtype=np.int32).reshape(len(rounds), -1, 2),
                           device=device).contiguous()


def z_layout(d: int, dtype: torch.dtype) -> str:
    """Kernel Z's layout for (d, d) matrices of `dtype`: "warp" for d <=
    64, "shared" where A and V (row stride d | 1), three d-vectors and d + 1
    ints fit Z_SHARED_BYTES (d <= 119 in float64, d <= 169 in float32),
    else "global". The kernel takes the shared layout when it is handed the
    schedule by pair (`_unit_table`), the global one when handed a scratch
    buffer."""
    if d <= KERNEL_WIDE_MAX_D:
        return "warp"
    size = torch.empty((), dtype=dtype).element_size()
    need = (2 * d * (d | 1) + 3 * d) * size + (d + 1) * 4
    return "shared" if need <= Z_SHARED_BYTES else "global"


def _sweep(A, V, tabs):
    """One sweep of parallel-order Jacobi over a (d, d, E) stack: each round
    applies floor(d/2) disjoint rotations at once as two full-tensor axis
    updates built from a static partner permutation:
        B  = c_row * A + s_row * A[perm, :]        (G^T A)
        A' = c_col * B + s_col * B[:, perm]        (... G)"""
    for p_idx, q_idx, perm, slot, sgn, paired in tabs:
        app = A[p_idx, p_idx]                    # (n_pairs, E)
        aqq = A[q_idx, q_idx]
        apq = A[p_idx, q_idx]
        theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
        c = torch.cos(theta)
        s = torch.sin(theta)
        # bye rows (odd d) rotate by identity
        cr = torch.where(paired[:, None], c[slot], torch.ones_like(c[slot]))
        sr = sgn.to(A.dtype)[:, None] * s[slot]
        B = cr[:, None, :] * A + sr[:, None, :] * A[perm, :, :]
        A = cr[None, :, :] * B + sr[None, :, :] * B[:, perm, :]
        V = cr[None, :, :] * V + sr[None, :, :] * V[:, perm, :]
    return A, V


def _jacobi_eigh(A: torch.Tensor, sweeps: int):
    """Batched parallel-order Jacobi for symmetric (E, d, d) stacks.
    Returns (w, V) with A ~= V @ diag(w) @ V^T after `sweeps` sweeps."""
    d = A.shape[-1]
    E = A.shape[0]
    dev = A.device
    A = torch.movedim(A, 0, -1)                      # (d, d, E)
    V = torch.eye(d, dtype=A.dtype, device=dev)[:, :, None].expand(d, d, E)
    tabs = _round_tables_on(d, dev)
    for _ in range(sweeps):
        A, V = _sweep(A, V, tabs)
    w = torch.diagonal(A, 0, 0, 1)                   # (E, d)
    return w, torch.movedim(V, -1, 0)                # (E, d, d)


def _off_diagonal_converged(A: torch.Tensor) -> torch.Tensor:
    """(E,) bool over a (d, d, E) stack: every entry above the diagonal
    passes kernel Z's stop test |a_ik| <= eps max_j |a_jj|, eps the dtype's
    machine epsilon (eigh's own normwise accuracy). The rotations drive the
    upper triangle to zero; the lower one, updated as JAX's form updates
    it, keeps rounding residue of eps |A|. The relative test eps
    sqrt|a_ii a_kk| cannot be met where an eigenvalue is numerically zero
    more than once (a tet's rigid modes)."""
    d = A.shape[0]
    bound = torch.finfo(A.dtype).eps * torch.amax(torch.abs(torch.diagonal(A, 0, 0, 1)), dim=1)
    lower = torch.ones((d, d), dtype=torch.bool, device=A.device).tril()[:, :, None]
    return torch.all(torch.all((torch.abs(A) <= bound) | lower, dim=0), dim=0)


def _jacobi_eigh_converged(A: torch.Tensor, max_sweeps: int = Z_MAX_SWEEPS):
    """Kernel Z's twin: parallel-order Jacobi in which each matrix sweeps
    until it passes the stop test (tested before every sweep, after the
    upper triangle is copied into the lower one), then runs one more sweep
    (which squares what the test left) and stops; at most `max_sweeps`
    sweeps in all. Returns (w, V, unconverged, sweeps): unconverged, a 0-d
    int32 tensor, counts the matrices that never passed the test; sweeps
    (E,) the sweeps each matrix ran (the work kernel Z does on it)."""
    d = A.shape[-1]
    E = A.shape[0]
    dev = A.device
    A = torch.movedim(A, 0, -1)                      # (d, d, E)
    V = torch.eye(d, dtype=A.dtype, device=dev)[:, :, None].expand(d, d, E)
    tabs = _round_tables_on(d, dev)
    passed = torch.zeros(E, dtype=torch.bool, device=dev)
    sweeps = torch.zeros(E, dtype=torch.int64, device=dev)
    lower = torch.ones((d, d), dtype=torch.bool, device=dev).tril(-1)[:, :, None]
    for _ in range(max_sweeps):
        # a matrix that passed before the last sweep has run its extra one
        active = torch.logical_not(passed)
        if not bool(torch.any(active)):
            break
        sweeps += active.to(torch.int64)
        # the lower triangle from the upper one (kernel Z's copy): JAX's form
        # leaves rounding residue there that near-degenerate rotations carry
        # back into the upper triangle
        A = torch.where(lower, A.transpose(0, 1), A)
        passed = passed | _off_diagonal_converged(A)
        A1, V1 = _sweep(A, V, tabs)
        A = torch.where(active, A1, A)
        V = torch.where(active, V1, V)
    unconverged = torch.sum(torch.logical_not(
        passed | _off_diagonal_converged(A)).to(torch.int32))
    w = torch.diagonal(A, 0, 0, 1)                   # (E, d)
    return w, torch.movedim(V, -1, 0), unconverged, sweeps


def batched_eigh(H: torch.Tensor, jacobi_sweeps: int):
    if jacobi_sweeps and H.shape[-1] > 3:
        return _jacobi_eigh(H, jacobi_sweeps)
    return torch.linalg.eigh(H)


def _rebuild(H, w, V, eps: float, mirroring: bool, elem_mask):
    """Clamp (or mirror) the eigenvalues below eps and rebuild the elements
    that changed (and that elem_mask allows): (H_out, changed)."""
    below = w < eps
    w_new = torch.where(below, -w if mirroring else torch.full_like(w, eps), w)
    Hp = torch.einsum("eij,ej,ekj->eik", V, w_new, V)
    changed = torch.any(below, dim=-1)
    if elem_mask is not None:
        changed = changed & elem_mask
    return torch.where(changed[:, None, None], Hp, H), changed


def pd_project_plain(H: torch.Tensor, eps: float, mirroring: bool,
                     elem_mask=None, jacobi_sweeps: int = 0):
    """Plain PyTorch twin of project_family_to_pd: returns (H_out, changed)."""
    w, V = batched_eigh(H, jacobi_sweeps)
    return _rebuild(H, w, V, eps, mirroring, elem_mask)


def z_converges(d: int, jacobi_sweeps: int) -> bool:
    """Whether kernel Z runs to convergence (JAX's exact-eigh branch:
    sweeps == 0 or d <= 3) rather than JAX's fixed sweeps (d > 64)."""
    return not jacobi_sweeps or d <= 3


def pd_project_z_plain(H: torch.Tensor, eps: float, mirroring: bool,
                       elem_mask=None, jacobi_sweeps: int = 0, unconverged=None,
                       sweeps=None):
    """Kernel Z's plain twin: the converged Jacobi (`z_converges`) or
    `_jacobi_eigh` at the given sweeps, then the clamp and rebuild. Adds
    the unconverged count to `unconverged` (a 0-d int32 tensor) and writes
    each matrix's sweeps into `sweeps` ((E,) int32) if given."""
    if z_converges(H.shape[-1], jacobi_sweeps):
        w, V, n_un, ran = _jacobi_eigh_converged(H)
        if unconverged is not None:
            unconverged.add_(n_un.to(unconverged.device))
    else:
        w, V = _jacobi_eigh(H, jacobi_sweeps)
        ran = torch.full((H.shape[0],), jacobi_sweeps)
    if sweeps is not None:
        sweeps.copy_(ran)
    return _rebuild(H, w, V, eps, mirroring, elem_mask)


def pd_project(H: torch.Tensor, eps: float, mirroring: bool, elem_mask=None,
               jacobi_sweeps: int = 0):
    """Project a (E, d, d) stack of symmetric matrices to PD. Returns
    (H_projected, changed): changed marks the elements whose eigenvalues
    were modified (and that elem_mask allows); only those are rebuilt. On
    CUDA, kernel C at jacobi_sweeps > 0 (d <= 16), kernel Z converged at
    jacobi_sweeps = 0."""
    return _project(H, eps, mirroring, elem_mask, jacobi_sweeps, KERNEL_MAX_D,
                    "pd_project")


def pd_project_wide(H: torch.Tensor, eps: float, mirroring: bool, elem_mask=None,
                    jacobi_sweeps: int = 0):
    """pd_project for 16 < d <= 64: kernel C with one warp per block."""
    return _project(H, eps, mirroring, elem_mask, jacobi_sweeps, KERNEL_WIDE_MAX_D,
                    "pd_project[wide]")


def _project(H, eps, mirroring, elem_mask, jacobi_sweeps, max_d, site):
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"pd_project: expected (E, d, d), got {tuple(H.shape)}")
    if H.device.type == "cpu":
        return pd_project_plain(H, eps, mirroring, elem_mask, jacobi_sweeps)
    E, d, _ = H.shape
    if not jacobi_sweeps:
        return pd_project_z(H, eps, mirroring, elem_mask, 0)
    if d > max_d:
        raise ValueError(f"pd_project: d={d} exceeds the kernel's {max_d}")
    build.require_cuda("pd_project", H)
    mask = _mask_u8(elem_mask, H, "pd_project")
    sched = _partner_table(d, H.device)
    fn = build.entry("stk_pd_project", H.dtype)
    out = torch.empty_like(H)
    changed = torch.empty((E,), dtype=torch.uint8, device=H.device)
    rc = fn(H.data_ptr(), E, d, sched.data_ptr(), sched.shape[0],
            int(jacobi_sweeps), float(eps), int(bool(mirroring)),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            changed.data_ptr(), build.stream_ptr(H.device))
    build.check_status("pd_project", rc)
    build.count_launch(site)
    return out, changed.bool()


def _mask_u8(elem_mask, H, name):
    if elem_mask is None:
        return None
    mask = elem_mask.to(torch.uint8).contiguous()
    build.require_cuda(name, H, mask)
    if mask.shape != (H.shape[0],):
        raise ValueError(f"{name}: elem_mask must be (E,)")
    return mask


def pd_project_z(H: torch.Tensor, eps: float, mirroring: bool, elem_mask=None,
                 jacobi_sweeps: int = 0, unconverged=None, sweeps=None):
    """Kernel Z: (H_projected, changed) by Jacobi run to convergence where
    `z_converges` (jacobi_sweeps == 0 or d <= 3; at most Z_MAX_SWEEPS
    sweeps), else by `jacobi_sweeps` fixed sweeps (its wide layouts, d >
    64, `z_layout`). `unconverged`, a 0-d int32 tensor on H's device,
    receives the count of matrices left unconverged (added on the device,
    no host read); `sweeps`, an (E,) int32 tensor on H's device, the
    sweeps each matrix ran (the twin's fourth output)."""
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"pd_project_z: expected (E, d, d), got {tuple(H.shape)}")
    if H.device.type == "cpu":
        return pd_project_z_plain(H, eps, mirroring, elem_mask, jacobi_sweeps,
                                  unconverged, sweeps)
    E, d, _ = H.shape
    if d > Z_MAX_D:
        raise ValueError(f"pd_project_z: d={d} exceeds the kernel's {Z_MAX_D}")
    H = H.contiguous()
    build.require_cuda("pd_project_z", H)
    mask = _mask_u8(elem_mask, H, "pd_project_z")
    converge = z_converges(d, jacobi_sweeps)
    if unconverged is not None:
        build.require_cuda("pd_project_z", H, unconverged)
        if unconverged.dtype != torch.int32 or unconverged.numel() != 1:
            raise TypeError("pd_project_z: unconverged must be one int32 value")
    if sweeps is not None:
        build.require_cuda("pd_project_z", H, sweeps)
        if sweeps.dtype != torch.int32 or sweeps.shape != (E,):
            raise TypeError("pd_project_z: sweeps must be (E,) int32")
    layout = z_layout(d, H.dtype)
    scratch = units = None
    if layout == "global" and E > 0:
        scratch = torch.empty((min(E, Z_WIDE_GRID), 4, d, d), dtype=H.dtype,
                              device=H.device)
    if layout == "shared":
        units = _unit_table(d, H.device)
    sched = _partner_table(d, H.device)
    fn = build.entry("stk_pd_project_z", H.dtype)
    out = torch.empty_like(H)
    changed = torch.empty((E,), dtype=torch.uint8, device=H.device)
    rc = fn(H.data_ptr(), E, d, sched.data_ptr(),
            None if units is None else units.data_ptr(), sched.shape[0],
            Z_MAX_SWEEPS if converge else int(jacobi_sweeps), int(converge),
            float(eps), int(bool(mirroring)), None if mask is None else mask.data_ptr(),
            out.data_ptr(), changed.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if unconverged is None else unconverged.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(),
            build.stream_ptr(H.device))
    build.check_status("pd_project_z", rc)
    build.count_launch("pd_project_z")
    return out, changed.bool()
