"""Vmapped energy/gradient/Hessian evaluation and matrix-free operators.

Port of the parts of `stark_tpu/solver/assembly.py` that the fused and the
staged solves run:

  * per-element energies, gradients and dense Hessians through each
    family's kernel (M-W, ops/egh.py `evaluate`) on the card, and from
    `torch.func` (`vmap` over `grad_and_value` / `hessian`, mirroring
    `jax.hessian`) on the CPU,
  * every per-block reduction through kernel A (`ops.segment_reduce`), an
    ordered segmented sum over a CSR,
  * the CG Hessian-vector product through kernel B (`ops.hvp_bucket`), one
    launch per product over every bucket or arity group,
  * the 3x3 block preconditioner through kernel D (`ops.block3`),
  * the dense Newton-Schulz preconditioner for small scenes, assembled
    through kernel A keyed by block-pair id; its GEMMs stay `torch.matmul`
    in full f32 (TF32 off), as the JAX package leaves them to XLA,
  * the live pool of the contact families (`live_select`): the rows with a
    nonzero element Hessian at the current iterate, compacted through
    kernel E,
  * JAX's gather-table and dense-direct helpers of the linear-solve tools
    (`scatter_table`, `hvp_table`, `scatter_table_rows`, `direct_tables`,
    `assemble_dense_perm`, `dense_inverse`, `direct_solve`, stark_tpu
    assembly.py:214-249, 524-557, 604-694, 789-835) over kernels AA, AB and
    AC; `tools/profile_linsolve.py` runs them. No solve path calls them.

`data` is a dict {family_name: {'conn': (E, arity) int64, 'rows': {...,
'active': (E,)}}} of tensors on one device.

Two buckets. The static families are padded to the largest STATIC arity
(4 for cloth and rigid bodies: 12x12 element blocks) and keep a CSR built
once per static topology (`Topology`). The live contact rows form a second
bucket padded to the largest contact arity (5: 15x15), whose CSR is rebuilt
on the device every Newton iteration without a host sync (`LivePool`).
Kernel A runs once per bucket and the two partial results are added;
kernel B takes both buckets in one launch.
The JAX package uses one 15x15 bucket for everything; values agree, layouts
differ.

The staged solver (solver/newton.py `_solve_staged`) keeps JAX's arity
groups instead (`hvp_context`, stark_tpu assembly.py:159-200, 251-268):
arity groups ascending, families by name within a group, each group with
its own CSR (`staged_groups`, built once per Newton iteration from the
tables alone), one launch of kernel A (diag) per group and one of kernel B
(site hvp_bucket[staged]) over all groups, the partial sums added in
ascending arity as JAX adds them. No row is padded: an inertia row stays
3x3 where the fused bucket makes it 12x12. DirectLLT's dense (3n)^2 Hessian is written per block pair by
kernel A's direct site, straight into JAX's block-major layout, in the
order of JAX's scatter-adds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops import dense_runs as _dense
from ..ops import egh
from ..ops import tables as _tables
from ..ops.block3 import block3_apply, block3_inverse
from ..ops.compact import compact
from ..ops.hvp_bucket import hvp_groups as _hvp_kernel
from ..ops.hvp_table import hvp_table as _hvp_table_kernel
from ..ops.segment_reduce import Csr, build_csr, dense_direct, segment_reduce, sort_pairs
from .potential import PotentialFamily
from .program import EagerControl

# Total energies accumulate in f64 even when the element math runs f32: the
# Armijo test compares energy DIFFERENCES of order beta*g.du, which f32
# accumulation noise would otherwise drown.
_ACC = torch.float64

_DYN_PREFIX = ("contact_", "friction_")


def _is_dyn(name: str) -> bool:
    return name.startswith(_DYN_PREFIX)


@dataclass
class Topology:
    """Index structures frozen with the element tables (rebuilt only when a
    table is replaced): the CSR of energy_grad_hess's payload rows, the
    single-bucket connectivity and its CSR (diag_bucket and hvp_bucket
    share it), and for the dense preconditioner the CSR of block-pair ids.
    `tables` keeps the source tensors so a replaced table is detected by
    identity."""
    egh_csr: Csr
    conn_cat: torch.Tensor      # (E_cat, b) int64, dummy id n_blocks
    conn_cat32: torch.Tensor    # the same as int32 for the kernels
    csr_cat: Csr
    pid_csr: Optional[Csr]
    tables: tuple


@dataclass
class StagedGroup:
    """One arity group of the staged solver's tables: the families (sorted
    names), their concatenated connectivity (E, a) int32 and its CSR; `H` is
    filled by hvp_context with the (projected) element Hessians of one
    linear solve. Inactive rows stay, as in JAX's context: their raw
    Hessians are zero, but a projection makes them eps * I on their
    (padding) blocks, and JAX's staged sums keep that. The contact and
    friction tables come cut to their live rows: the solver adds their
    padding's eps * I itself (NewtonsMethod._padding_slots)."""
    names: tuple
    conn32: torch.Tensor
    csr: Csr
    H: Optional[torch.Tensor] = None


@dataclass
class LivePool:
    """The live contact rows of one Newton iteration, as the second bucket:
    conn (pool_cap, b) int32 with dummy id n_blocks past the live count, the
    (projected) element Hessians, the CSR of its block rows and, for the
    dense preconditioner, of its block pairs; all built on the device."""
    conn32: torch.Tensor
    H: torch.Tensor
    csr: Csr
    pid_csr: Optional[Csr]


class Evaluators:
    """Evaluation closures for a fixed family set and block count (the
    counterpart of the object `stark_tpu`'s make_evaluators returns).

    `host_syncs` counts the device->host reads the staged solve makes
    through `to_host` (the fused solve makes none: its tests are device
    predicates of solver/program.py's control). While `forbid_reads` is
    set (a strict EagerControl runs a body), `to_host` raises."""

    def __init__(self, families: List[PotentialFamily], n_blocks: int):
        self.fam_by_name = {f.name: f for f in families}
        self.n_blocks = n_blocks
        # bucket widths: static families, and the live contact pool
        self.max_arity = max((f.arity for f in families if not _is_dyn(f.name)),
                             default=1)
        self.dyn_arity = max((f.arity for f in families if _is_dyn(f.name)),
                             default=1)
        self.host_syncs = 0
        self.forbid_reads = 0

    # ------------------------------------------------------------------
    def to_host(self, x: torch.Tensor):
        """Python value of a 0-d tensor, or list of a 1-d one (one
        device->host sync)."""
        if self.forbid_reads:
            raise RuntimeError("Evaluators.to_host: a host read inside a body "
                               "of the fused solve's device program")
        self.host_syncs += 1
        return x.item() if x.dim() == 0 else x.tolist()

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    def _pair_ids(self, conn):
        """Flat block-pair ids of a bucket's connectivity for the dense
        assembly; pairs with a dummy block get the out-of-range id N1^2."""
        n = self.n_blocks
        N1 = n + 1
        cl = torch.clamp_max(conn.to(torch.int64), n)
        pid = cl[:, :, None] * N1 + cl[:, None, :]
        dummy = (cl[:, :, None] >= n) | (cl[:, None, :] >= n)
        return torch.where(dummy, torch.full_like(pid, N1 * N1), pid).reshape(-1)

    def topology(self, data, dense: bool) -> Topology:
        """Index structures of the static tables (dynamic families are
        left out: their rows live in the pool)."""
        n = self.n_blocks
        static = {k: v for k, v in data.items() if not _is_dyn(k)}
        egh_rows = torch.cat([fd["conn"].reshape(-1) for fd in static.values()])
        conn_cat = self.cat_static_conn(static)
        pid_csr = None
        if dense:
            N1 = n + 1
            pid_csr = build_csr(self._pair_ids(conn_cat), N1 * N1)
        tables = tuple((fd["conn"], fd["rows"]["active"]) for fd in static.values())
        return Topology(egh_csr=build_csr(egh_rows, n), conn_cat=conn_cat,
                        conn_cat32=conn_cat.to(torch.int32).contiguous(),
                        csr_cat=build_csr(self.scatter_rows(conn_cat), n),
                        pid_csr=pid_csr, tables=tables)

    @staticmethod
    def topology_matches(topo: Optional[Topology], data) -> bool:
        static = [fd for k, fd in data.items() if not _is_dyn(k)]
        if topo is None or len(topo.tables) != len(static):
            return False
        return all(c is fd["conn"] and a is fd["rows"]["active"]
                   for (c, a), fd in zip(topo.tables, static))

    def egh_csr(self, data) -> Csr:
        """CSR of energy_grad_hess's payload rows over every table in
        `data` (in its order), built on the device without a host sync: the
        contact tables change at every pair-shell rebuild."""
        rows = torch.cat([fd["conn"].reshape(-1) for fd in data.values()])
        return build_csr(rows, self.n_blocks)

    # ------------------------------------------------------------------
    # energy / gradient / Hessian
    # ------------------------------------------------------------------
    def energy(self, u, data, glob):
        E = torch.zeros((), dtype=_ACC, device=u.device)
        for name, fd in data.items():
            fam = self.fam_by_name[name]
            # inactive rows come back zero
            e = egh.evaluate(fam, u, fd["conn"], fd["rows"], glob, derivs=False)
            E = E + torch.sum(e.to(_ACC))
        return E

    def energy_grad_hess(self, u, data, glob, topo: Topology,
                         egh_csr: Optional[Csr] = None):
        """Returns (E, aux, grad, {name: H (E, arity*3, arity*3)}).

        aux carries the rounding-noise floors the convergence tests use:
          * aux['e_nsq']: sum of per-element energies squared;
          * aux['g_nsq']: max over (block, component) of the sum of squared
            per-element gradient contributions;
          * aux['hsum']: per-block |H| row sums (backward-error floor).
        The per-block reductions run as ONE (R, 9) payload [g, g^2, |H| row
        sum] through kernel A, over `egh_csr` when given (tables that include
        contact families) else the static topology's CSR."""
        E = torch.zeros((), dtype=_ACC, device=u.device)
        E_nsq = torch.zeros((), dtype=_ACC, device=u.device)
        hess: Dict[str, torch.Tensor] = {}
        payload_parts = []
        for name, fd in data.items():
            fam = self.fam_by_name[name]
            # inactive rows come back zero, H symmetric
            e, g_e, H_e = egh.evaluate(fam, u, fd["conn"], fd["rows"], glob)
            e_m = e.to(_ACC)
            E = E + torch.sum(e_m)
            E_nsq = E_nsq + torch.sum(e_m ** 2)
            g_flat = g_e.reshape(-1, 3)
            hess[name] = H_e
            hrow = torch.sum(torch.abs(H_e), dim=2).reshape(-1, 3)
            payload_parts.append(torch.cat([g_flat, g_flat * g_flat, hrow], dim=-1))
        payload = torch.cat(payload_parts).contiguous()
        acc = segment_reduce(payload, egh_csr if egh_csr is not None
                             else topo.egh_csr, "egh")
        grad = acc[:, :3]
        gsq = acc[:, 3:6]
        hsum = acc[:, 6:9]
        aux = {"e_nsq": E_nsq, "g_nsq": torch.max(gsq).to(_ACC), "hsum": hsum}
        return E, aux, grad, hess

    # ------------------------------------------------------------------
    # single-bucket layout
    # ------------------------------------------------------------------
    def split_dyn(self, names):
        """(static_names, dynamic_names) in canonical (sorted) order."""
        names = sorted(names)
        return ([n for n in names if not _is_dyn(n)],
                [n for n in names if _is_dyn(n)])

    def _pad_conn_b(self, fd, b):
        conn = fd["conn"]
        act = fd["rows"]["active"] > 0.5
        conn = torch.where(act[:, None], conn, torch.full_like(conn, self.n_blocks))
        a = conn.shape[1]
        if a < b:
            conn = F.pad(conn, (0, b - a), value=self.n_blocks)
        return conn

    @staticmethod
    def _pad_h(H, d):
        if H.shape[-1] < d:
            p = d - H.shape[-1]
            H = F.pad(H, (0, p, 0, p))
        return H

    def cat_static_conn(self, data):
        """Concatenated static-family connectivity (canonical sorted order,
        padded to the bucket arity, inactive rows -> dummy block)."""
        b = self.max_arity
        parts = [self._pad_conn_b(data[n], b) for n in sorted(data.keys())
                 if not _is_dyn(n)]
        return torch.cat(parts, dim=0)

    def cat_with_live(self, conn_static, hess_stat):
        """(conn_cat, H_cat) of the static bucket: the static families in
        canonical order (the live rows form the second bucket, LivePool)."""
        d = 3 * self.max_arity
        h_parts = [self._pad_h(hess_stat[n], d) for n in sorted(hess_stat.keys())]
        return conn_static, torch.cat(h_parts, dim=0).contiguous()

    def dyn_conn_cat(self, data):
        """Concatenated dynamic-family connectivity padded to the pool's
        arity, inactive rows routed to the dummy block (canonical order)."""
        b = self.dyn_arity
        parts = [self._pad_conn_b(data[n], b) for n in sorted(data.keys())
                 if _is_dyn(n)]
        return torch.cat(parts, dim=0) if parts else None

    def dyn_hess_cat(self, hess):
        """Dynamic-family element Hessians zero-padded to the pool's size,
        in dyn_conn_cat's order."""
        d = 3 * self.dyn_arity
        parts = [self._pad_h(hess[n], d) for n in sorted(hess.keys()) if _is_dyn(n)]
        return torch.cat(parts, dim=0) if parts else None

    def live_select(self, conn_dyn, H_dyn, live_cap: int):
        """The dynamic rows with a NONZERO element Hessian at the current
        iterate (barriers are exactly zero past dhat), compacted through
        kernel E into (conn_live (live_cap, b) with the dummy id past the
        count, H_live (live_cap, 3b, 3b), valid (live_cap,), count); a count
        above live_cap is an overflow the host resolves."""
        nz = torch.any((H_dyn != 0.0).reshape(H_dyn.shape[0], -1), dim=1)
        sel, cnt = compact(nz, live_cap, "live")
        sl = sel.long()
        valid = torch.arange(live_cap, device=nz.device) < torch.clamp_max(cnt, live_cap)
        conn_live = torch.where(valid[:, None], conn_dyn[sl],
                                torch.full_like(conn_dyn[sl], self.n_blocks))
        H_live = torch.where(valid[:, None, None], H_dyn[sl],
                             torch.zeros_like(H_dyn[sl]))
        return conn_live, H_live, valid, cnt

    def live_pool(self, conn_live, H_live, dense: bool) -> LivePool:
        """The second bucket from live_select's rows, CSRs built on the
        device (no host sync; ~pool_cap*b keys sorted per iteration)."""
        n = self.n_blocks
        conn32 = conn_live.to(torch.int32).contiguous()
        pid_csr = (build_csr(self._pair_ids(conn_live), (n + 1) ** 2)
                   if dense else None)
        return LivePool(conn32=conn32, H=H_live.contiguous(),
                        csr=build_csr(conn_live.reshape(-1), n),
                        pid_csr=pid_csr)

    # ------------------------------------------------------------------
    # staged solver: per-arity groups (stark_tpu assembly.py:159-268)
    # ------------------------------------------------------------------
    def staged_groups(self, data) -> Dict[int, StagedGroup]:
        """The arity groups of `data` in canonical order (arity ascending,
        families by name), each with its connectivity and CSR: built once
        per Newton iteration, since they depend on the tables only."""
        by_arity: Dict[int, list] = {}
        for name in sorted(data):
            by_arity.setdefault(self.fam_by_name[name].arity, []).append(name)
        groups = {}
        for a in sorted(by_arity):
            names = tuple(by_arity[a])
            conn = torch.cat([data[n]["conn"] for n in names])
            groups[a] = StagedGroup(names=names,
                                    conn32=conn.to(torch.int32).contiguous(),
                                    csr=build_csr(conn.reshape(-1), self.n_blocks))
        return groups

    @staticmethod
    def hvp_context(groups: Dict[int, StagedGroup], hess) -> Dict[int, StagedGroup]:
        """The groups with their element Hessians concatenated in the
        groups' family order (hess holds every family of the groups)."""
        return {a: StagedGroup(g.names, g.conn32, g.csr,
                               torch.cat([hess[n] for n in g.names]).contiguous())
                for a, g in groups.items()}

    def hvp_ctx(self, p, ctx: Dict[int, StagedGroup]):
        """q = H p: one launch of kernel B over the arity groups, the
        partial products added in ascending arity."""
        if not ctx:
            return torch.zeros_like(p)
        return _hvp_kernel(p.contiguous(), [(ctx[a].conn32, ctx[a].H, ctx[a].csr)
                                            for a in sorted(ctx)], site="staged")

    def hvp(self, p, data, hess):
        """q = H p over the element Hessians of `data`'s families."""
        return self.hvp_ctx(p, self.hvp_context(self.staged_groups(data), hess))

    def diag_blocks_ctx(self, ctx: Dict[int, StagedGroup]):
        """(n_blocks, 3, 3) diagonal blocks of the global Hessian: kernel A
        (site diag) once per arity group, added in ascending arity."""
        D = None
        for a in sorted(ctx):
            g = ctx[a]
            Da = segment_reduce(self._diag_payload(g.H), g.csr, "diag")
            D = Da if D is None else D + Da
        if D is None:
            D = torch.zeros((self.n_blocks, 9))
        return D.reshape(-1, 3, 3)

    def diag_blocks(self, data, hess):
        return self.diag_blocks_ctx(self.hvp_context(self.staged_groups(data), hess))

    def direct_rows(self, data, hess):
        """DirectLLT's scatter as kernel A's direct input: the (R, 9) payload
        of every element's 3x3 block pairs, in JAX's scatter order (families
        in `hess` order, then the block slots i, j, then the elements;
        inactive rows included, as in JAX), and the stable sort of their
        pair keys i * n + j. A pair with a block id outside 0..n-1 (the
        dummy id n) is keyed n^2 and dropped, as JAX's scatter drops an
        index out of bounds on either axis."""
        n = self.n_blocks
        pids, payloads = [], []
        for name, H_e in hess.items():
            conn = data[name]["conn"].to(torch.int64)
            real = (conn >= 0) & (conn < n)
            E, a = conn.shape
            # (i, j, e) order: slot i, then slot j, then the elements
            key = torch.where(real[:, :, None] & real[:, None, :],
                              conn[:, :, None] * n + conn[:, None, :], n * n)
            pids.append(key.permute(1, 2, 0).reshape(-1))
            payloads.append(H_e.reshape(E, a, 3, a, 3).permute(1, 3, 0, 2, 4).reshape(-1, 9))
        return torch.cat(payloads).contiguous(), sort_pairs(torch.cat(pids), n)

    def assemble_dense_direct(self, data, hess):
        """The dense (3n, 3n) global Hessian in block-major layout (row
        3*i + c is component c of block i) of DirectLLT (stark_tpu
        newton.py:193-204), written per block pair by kernel A's direct
        site: each pair's sum adds the same terms in the same order as
        JAX's sequence of scatter-adds."""
        return dense_direct(*self.direct_rows(data, hess))

    def scatter_rows(self, conn_cat):
        """Flat block-row vector of the single-bucket layout."""
        return conn_cat.reshape(-1)

    def hvp_bucket(self, p, H_cat, topo: Topology, pool: Optional[LivePool] = None):
        """q = H p: one launch of kernel B over the static bucket and the
        pool, the pool's product added second."""
        groups = [(topo.conn_cat32, H_cat, topo.csr_cat)]
        if pool is not None:
            groups.append((pool.conn32, pool.H, pool.csr))
        return _hvp_kernel(p.contiguous(), groups)

    @staticmethod
    def _diag_payload(H):
        b = H.shape[-1] // 3
        Hb = H.reshape(H.shape[0], b, 3, b, 3)
        return torch.einsum("eiaib->eiab", Hb).reshape(-1, 9).contiguous()

    def diag_bucket(self, H_cat, topo: Topology, pool: Optional[LivePool] = None):
        """3x3 diagonal blocks (kernel A per bucket)."""
        D = segment_reduce(self._diag_payload(H_cat), topo.csr_cat, "diag")
        if pool is not None:
            D = D + segment_reduce(self._diag_payload(pool.H), pool.csr, "diag")
        return D.reshape(-1, 3, 3)

    # ------------------------------------------------------------------
    # dense Newton-Schulz preconditioner (small scenes)
    # ------------------------------------------------------------------
    @staticmethod
    def _pair_payload(H):
        b = H.shape[-1] // 3
        vals = H.reshape(H.shape[0], b, 3, b, 3).permute(0, 1, 3, 2, 4)
        return vals.reshape(-1, 9).contiguous()

    def assemble_dense_scatter(self, H_cat, topo: Topology,
                               pool: Optional[LivePool] = None):
        """Dense permuted-layout (component-major) global Hessian, summed
        per block pair by kernel A (per bucket). The dummy block carries an
        identity diagonal so the scaled matrix stays SPD."""
        N1 = self.n_blocks + 1
        D4 = segment_reduce(self._pair_payload(H_cat), topo.pid_csr, "dense")
        if pool is not None:
            D4 = D4 + segment_reduce(self._pair_payload(pool.H), pool.pid_csr,
                                     "dense")
        D4[N1 * N1 - 1] = torch.eye(3, dtype=H_cat.dtype,
                                    device=H_cat.device).reshape(9)
        return D4.reshape(N1, N1, 3, 3).permute(2, 0, 3, 1).reshape(3 * N1, 3 * N1)

    def ns_refresh(self, M_prev, H_cat, topo: Topology, warm_sweeps: int = 1,
                   cold_sweeps: int = 34, pool: Optional[LivePool] = None,
                   ctl=None):
        """Newton-Schulz tracking of the dense-inverse preconditioner:
        M' = M + M(I - Hs M) on the Jacobi-SCALED assembled Hessian, warm
        from the carried M; a quality probe falls back to the cold start
        Ms0 = I/||Hs||_inf with `cold_sweeps` doublings when the warm seed
        has diverged (`ctl.if_`: an IF node of the fused solve's graph;
        without a ctl, an EagerControl reading through to_host). Returns
        (M unscaled, q = max|I - Hs Ms| of the last sweep, was_cold). Full
        f32 GEMMs: the caller keeps TF32 off."""
        Hp = self.assemble_dense_scatter(H_cat, topo, pool)
        n = Hp.shape[0]
        dg = torch.diagonal(Hp)
        ok_d = dg > 1e-30
        s = torch.where(ok_d, torch.rsqrt(torch.clamp_min(dg, 1e-30)),
                        torch.ones_like(dg))
        Hs = Hp * s[:, None] * s[None, :]
        Hs = Hs + torch.diag(torch.where(ok_d, 0.0, 1.0).to(Hp.dtype))
        eye = torch.eye(n, dtype=Hp.dtype, device=Hp.device)

        def sweep(Ms):
            R = eye - torch.matmul(Hs, Ms)
            return Ms + torch.matmul(Ms, R), torch.max(torch.abs(R))

        s_safe = torch.clamp_min(s, 1e-30)
        Ms = M_prev / s_safe[:, None] / s_safe[None, :]
        for _ in range(warm_sweeps):
            Ms, q = sweep(Ms)
        bad = torch.logical_not(torch.isfinite(q)) | (q > 0.9)

        def cold():
            norm_inf = torch.max(torch.sum(torch.abs(Hs), dim=1))
            Mc = eye / torch.clamp_min(norm_inf, 1.0)
            for _ in range(cold_sweeps):
                Mc, qc = sweep(Mc)
            Ms.copy_(Mc)
            q.copy_(qc)

        (ctl or EagerControl(read=self.to_host)).if_(bad, cold)
        M = Ms * s[:, None] * s[None, :]
        finite = torch.isfinite(q)
        M = torch.where(finite, M, torch.diag(s * s))
        q = torch.where(finite, q, torch.full_like(q, 1e9))
        return M, q, bad

    def apply_dense_perm(self, M, r):
        """q = M r with M in the permuted (component-major) layout and r in
        the (n_blocks, 3) block layout."""
        N1 = self.n_blocks + 1
        r_pad = torch.cat([r, torch.zeros((1, 3), dtype=r.dtype, device=r.device)])
        v = r_pad.T.reshape(-1)
        q = M @ v
        return q.reshape(3, N1).T[:self.n_blocks]

    # ------------------------------------------------------------------
    # gather tables and the dense direct helpers (stark_tpu
    # assembly.py:214-249, 524-557, 604-694, 789-835): kernels AA-AC. `ctx`
    # is JAX's {arity: (conn, H, active)}; a single bucket is one entry.
    # ------------------------------------------------------------------
    def _ctx_rows(self, ctx):
        """Flat block rows of a context, inactive rows routed to the dummy
        segment n_blocks (JAX's scatter_table rows)."""
        parts = []
        for a in sorted(ctx):
            conn, _H, act = ctx[a]
            parts.append(torch.where(act[:, None], conn.to(torch.int64),
                                     torch.full_like(conn, self.n_blocks,
                                                     dtype=torch.int64)).reshape(-1))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def scatter_table(self, ctx, K: int):
        """(entry (n_blocks, K) int32, R, max_len): the gather table of the
        context's flat rows (kernel AA); max_len > K signals overflow."""
        rows = self._ctx_rows(ctx)
        entry, max_len = _tables.gather_table(rows, self.n_blocks, K)
        return entry, rows.numel(), max_len

    def hvp_table(self, p, ctx, entry):
        """q = H p with the gather-table reduction (kernel AB)."""
        return _hvp_table_kernel(p, [(ctx[a][0], ctx[a][1]) for a in sorted(ctx)], entry)

    def scatter_table_rows(self, rows, K: int, hot_cap: int, K2: int):
        """Two-level gather table over a flat block-row vector (kernels AA
        and E): (entry, hot_ids, hot_entry, hot_n, max_deg); max_deg > K + K2
        or hot_n > hot_cap signal overflow."""
        return _tables.gather_table_rows(rows, self.n_blocks, K, hot_cap, K2)

    def direct_tables(self, conn_cat, slot_cap: int):
        """The single bucket's sorted block-pair layout (kernels AA and E):
        (order, starts, pid_start, n_slots, is_start); n_slots > slot_cap
        signals overflow."""
        return _tables.direct_tables(conn_cat, self.n_blocks, slot_cap)

    def assemble_dense_perm(self, H_cat, dtab):
        """Dense global Hessian in the permuted (component-major) layout,
        the dummy block an identity (kernel AC)."""
        return _dense.dense_runs(H_cat, dtab, self.n_blocks, _dense.PERM)

    def dense_inverse(self, H_cat, dtab):
        """(M, ok): the explicit inverse of the Jacobi-scaled assembled
        Hessian in the permuted layout, unscaled; the Jacobi diagonal
        diag(s^2) where the Cholesky fails (JAX's NaNs from
        jax.lax.linalg.cholesky; here also cholesky_ex's info), selected on
        the device. Full f32 products: the caller keeps TF32 off."""
        Hp = self.assemble_dense_perm(H_cat, dtab)
        n = Hp.shape[0]
        dg = torch.diagonal(Hp)
        ok_d = dg > 1e-30
        s = torch.where(ok_d, torch.rsqrt(torch.clamp_min(dg, 1e-30)), torch.ones_like(dg))
        Hs = Hp * s[:, None] * s[None, :]
        Hs = Hs + torch.diag(torch.where(ok_d, 0.0, 1.0).to(Hp.dtype))
        L, info = torch.linalg.cholesky_ex(Hs)
        Li = torch.linalg.solve_triangular(
            L, torch.eye(n, dtype=Hp.dtype, device=Hp.device), upper=False)
        M = torch.matmul(Li.T, Li) * s[:, None] * s[None, :]
        ok = (info == 0) & torch.all(torch.isfinite(M))
        return torch.where(ok, M, torch.diag(s * s)), ok

    def direct_solve(self, grad, H_cat, dtab):
        """(du, ok): du = -H^-1 grad by the dense Jacobi-scaled Cholesky of
        the block-major matrix (kernel AC's f64 run sums); du = 0 where the
        factorization fails, selected on the device."""
        D = _dense.dense_runs(H_cat, dtab, self.n_blocks, _dense.DIRECT)
        dg = torch.diagonal(D)
        ok_d = dg > 1e-30
        s = torch.where(ok_d, torch.rsqrt(torch.clamp_min(dg, 1e-30)), torch.ones_like(dg))
        Hs = D * s[:, None] * s[None, :]
        Hs = Hs + torch.diag(torch.where(ok_d, 0.0, 1.0).to(D.dtype))
        L, info = torch.linalg.cholesky_ex(Hs)
        rhs = (-grad.reshape(-1) * s)[:, None]
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        x = torch.linalg.solve_triangular(L.T, y, upper=True)
        du = (x[:, 0] * s).reshape(self.n_blocks, 3)
        ok = (info == 0) & torch.all(torch.isfinite(du))
        return torch.where(ok, du, torch.zeros_like(du)), ok


def make_evaluators(families: List[PotentialFamily], n_blocks: int) -> Evaluators:
    return Evaluators(families, n_blocks)


def precondition_inverse(D, eps: float = 1e-30):
    """Batched inverse of the 3x3 diagonal blocks with identity fallback for
    empty/singular blocks (kernel D)."""
    return block3_inverse(D.contiguous(), eps)


def apply_preconditioner(Dinv, r):
    # r: (n_blocks, 3)
    return block3_apply(Dinv, r.contiguous())
