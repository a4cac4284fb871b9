"""Kernels M-W: per-element energy, gradient and dense Hessian (K11), the
launcher they share and their plain twin.

Replaces the `jax.vmap(jax.hessian(e_fn))` of stark_tpu/solver/assembly.py:
117-135. A family whose `PotentialFamily.kernel` is set evaluates on CUDA
tensors through its hand-written kernel (csrc/egh_strain.cu M,
egh_contact.cu N and O, egh_inertia.cu P, egh_friction.cu Q, egh_rod.cu R,
egh_tet.cu S, egh_joints.cu T and U, egh_shells.cu V, egh_attachments.cu
W; each model registers its family's launcher, `kernel`, with the tables
its entry reads), and on CPU tensors through the plain twin: torch.func's vmap(grad_and_value) and
vmap(hessian) of the family's energy, masked and symmetrised. Every
family has a kernel; one without would take the twin on the card, counted
per family in `build.func_on_card`.

Layouts: e (E,), g (E, arity, 3), H (E, 3 arity, 3 arity), inactive rows
exact zeros, H symmetric; the kernels write them so, the twin masks and
symmetrises. `derivs=False` asks for e alone (the value-only form of a
kernel, bit for bit the e of its derivative form).
"""
from __future__ import annotations

import ctypes

import torch
from torch.func import grad_and_value, hessian, vmap

from . import build

N_PTRS = 16      # family tensors after u, conn, active (csrc/egh_common.cuh)
N_SCALARS = 4


def plain(energy_fn, u, conn, rows, glob, derivs: bool = True):
    """The twin: torch.func over `energy_fn` (u_e, row, glob) -> scalar."""
    u_e = u[conn]
    mask = rows["active"] > 0.5
    if not derivs:
        e = vmap(energy_fn, in_dims=(0, 0, None))(u_e, rows, glob)
        return torch.where(mask, e, torch.zeros_like(e))
    g_e, e = vmap(grad_and_value(energy_fn), in_dims=(0, 0, None))(u_e, rows, glob)
    H_e = vmap(hessian(energy_fn), in_dims=(0, 0, None))(u_e, rows, glob)
    d = 3 * conn.shape[1]
    e = torch.where(mask, e, torch.zeros_like(e))
    g_e = torch.where(mask[:, None, None], g_e, torch.zeros_like(g_e))
    H_e = H_e.reshape(H_e.shape[0], d, d)
    H_e = torch.where(mask[:, None, None], H_e, torch.zeros_like(H_e))
    # enforce exact symmetry (autodiff roundoff)
    H_e = 0.5 * (H_e + H_e.transpose(1, 2))
    return e, g_e, H_e


def _plain_live(energy_fn, u, conn, rows, glob, derivs: bool):
    """The twin on CPU tensors over the rows up to the last active one; the
    rest are inactive, and `plain` would give them exact zeros too. A
    CPU-time measure for the tests: the fused solve keeps its contact and
    friction tables at their capacities, and this makes them cost their
    live prefix (tests/test_torch_program.py's four scene tests: 220.7 s
    with `plain` on the full tables, 143.1 s with this, one CPU worker).
    The card's twin and tools/egh_cases keep `plain`."""
    act = rows["active"] > 0.5
    E = act.shape[0]
    k = int(torch.nonzero(act)[-1]) + 1 if bool(torch.any(act)) else 0
    if k == E:
        return plain(energy_fn, u, conn, rows, glob, derivs)
    if k == 0:
        a = conn.shape[1]
        e = torch.zeros((E,), dtype=u.dtype)
        if not derivs:
            return e
        return (e, torch.zeros((E, a, 3), dtype=u.dtype),
                torch.zeros((E, 3 * a, 3 * a), dtype=u.dtype))
    out = plain(energy_fn, u, conn[:k], {n: v[:k] for n, v in rows.items()}, glob,
                derivs)
    pad = [torch.zeros((E - k,) + t.shape[1:], dtype=t.dtype) for t in
           (out if derivs else (out,))]
    full = [torch.cat([t, z]) for t, z in zip(out if derivs else (out,), pad)]
    return tuple(full) if derivs else full[0]


def evaluate(fam, u, conn, rows, glob, derivs: bool = True):
    """A family's e (and g, H): its kernel for CUDA tensors where it has
    one, else the twin (counted per family when on the card); on the CPU
    the twin skips the inactive rows past the last active one."""
    if u.device.type == "cuda":
        if fam.kernel is not None:
            return fam.kernel(u, conn, rows, glob, derivs)
        build.func_on_card[fam.name] += 1
        return plain(fam.energy_fn, u, conn, rows, glob, derivs)
    return _plain_live(fam.energy_fn, u, conn, rows, glob, derivs)


def kernel(source: str, family: str, spec, scalars=None):
    """The CUDA launcher of entry `stk_egh_<family>` of csrc/<source>.cu:
    (u, conn, rows, glob, derivs=True, host=False) -> e or (e, g, H),
    counted at site `<source>[<family>]`. `spec` lists the tensors the entry
    reads after u, conn and active, in its order: ("r", key) a row table,
    ("g", key) a global (None where the globals lack it: the entry reads it
    only for the points that need it), None a slot it leaves unread.
    `scalars(dtype)` gives its float arguments, read at every call."""
    site = f"{source}[{family}]"
    spec = tuple(spec)

    def run(u, conn, rows, glob, derivs=True, host=False):
        ts = [None if s is None else rows[s[1]] if s[0] == "r" else glob.get(s[1])
              for s in spec]
        sc = () if scalars is None else scalars(u.dtype)
        return launch(family, site, u, conn, rows["active"], ts, sc, derivs=derivs,
                      host=host)

    run.site, run.family, run.spec = site, family, spec
    return run


def _prep(t, dtype, device, what):
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{what}: a tensor lies on {t.device}, not {device}")
    if t.dtype.is_floating_point:
        return t.to(dtype).contiguous()
    return t.to(torch.int64).contiguous()


def launch(family: str, site: str, u, conn, active, tensors, scalars=(),
           derivs: bool = True, host: bool = False):
    """Launch kernel `stk_egh_<family>` on the rows of `conn` (E, arity):
    `tensors` are the family's tensors in the order its csrc entry lists
    (None for one it does not read), `scalars` up to 4 floats. `host`
    runs the g++ build of the same element math on CPU tensors (the tests'
    route; the wrapper itself never takes it). Returns e or (e, g, H)."""
    dtype, dev = u.dtype, u.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{site}: unsupported dtype {dtype}")
    if host:
        if dev.type != "cpu":
            raise ValueError(f"{site}: the host build takes CPU tensors")
    elif dev.type != "cuda":
        raise ValueError(f"{site}: expected CUDA tensors, got {dev}")
    if len(tensors) > N_PTRS or len(scalars) > N_SCALARS:
        raise ValueError(f"{site}: too many arguments")
    E, arity = conn.shape
    d = 3 * arity
    u = u.contiguous()
    conn = _prep(conn, dtype, dev, site)
    ts = [u, conn, _prep(active, dtype, dev, site)] + \
        [_prep(t, dtype, dev, site) for t in tensors]
    e = torch.empty((E,), dtype=dtype, device=dev)
    g = torch.empty((E, arity, 3), dtype=dtype, device=dev) if derivs else None
    H = torch.empty((E, d, d), dtype=dtype, device=dev) if derivs else None
    if E == 0:
        return (e, g, H) if derivs else e
    ptrs = (ctypes.c_void_p * (3 + N_PTRS))(
        *[None if t is None else t.data_ptr() for t in ts],
        *([None] * (3 + N_PTRS - len(ts))))
    scal = (ctypes.c_double * N_SCALARS)(*[float(s) for s in scalars],
                                         *([0.0] * (N_SCALARS - len(scalars))))
    outs = (e.data_ptr(), None if g is None else g.data_ptr(),
            None if H is None else H.data_ptr())
    name = "stk_egh_" + family
    if host:
        rc = build.host_entry(name, dtype)(ptrs, scal, E, *outs)
    else:
        rc = build.entry(name, dtype)(ptrs, scal, E, *outs, build.stream_ptr(dev))
        build.check_status(site, rc)
        build.count_launch(site if derivs else site[:-1] + ":e]")
    if rc != 0:
        raise RuntimeError(f"{site}: the host build returned {rc}")
    return (e, g, H) if derivs else e
