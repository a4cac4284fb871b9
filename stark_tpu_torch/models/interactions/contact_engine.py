"""Device-side contact pipeline: candidate lists, pair tables,
lagged-friction tables and the intersection oracle of the fused solve, and
the staged solver's per-evaluation contact refresh.

Port of the dense path of `stark_tpu/models/interactions/contact_engine.py`.
The reference rebuilds contact tables from a proximity pass over
x1 = x0 + dt*v1 at every energy evaluation (EnergyFrictionalContact.cpp:
368-530), freezes lagged friction anchors once per step from a dt = 0 pass
(:531-773), and asks an edge-triangle oracle whether a state is
penetration-free (:774-799). The friction tables (`friction_tables`) come
from kernel I (`ops.friction_pairs`: every allowed pair with a nonzero mu
and d <= dhat at the step-start state), routed per family through kernel E,
with kernel J (`ops.friction_rows`) filling each row's anchors, tangent
basis, mu and normal force. The fused solve (solver/fused.py) keeps two
frozen contact shells:

  * broad_fn (the BROAD shell, rebuilt when the motion since its build
    exceeds 0.45*slack_b): bounding-ball pairs of every primitive kind over
    the concatenated soft+rigid tables through kernel F (`ops.ball_wide`),
    exact distances over that wide list through kernel G (`ops.narrow`),
    re-compacted through kernel E (`ops.compact`) into flat "mid" lists of
    pairs within dhat + slack_p + slack_b; plus the edge-triangle
    intersection candidates (`_isect_stage1`);
  * pairs_fn (the PAIR shell): exact distances over the mid lists (kernel
    G), routed and compacted (kernel E) into the 7 family pair tables the
    energies read;
  * isect_hit: kernel H over the frozen intersection candidates.

Every list has a static capacity; counts travel as 0-d int32 device
tensors, and the host compares them with the capacities once per step
(`_check_overflow`): an overflow bumps the capacity and the step is solved
again. Capacities are learned in memory only (a persistent capacity cache
is ROADMAP Queue 1 P10).

The staged solver (solver/newton.py `_solve_staged`) keeps host tables
instead of shells: `refresh_contacts` before every energy evaluation lists
every allowed pair within dhat at the current DOFs (`_contacts_fn`: on the
dense path kernel I's contact mode, `ops.friction_pairs.contact_pairs_pt/
_ee`, routed through kernel E; on the per-stem path each stem's stage 1 and
2), `refresh_friction` builds the friction tables once per step. Both keep
their capacity-padded rows, as JAX's do: a projection turns an inactive
row's zero Hessian into eps * I on its block, and JAX's staged sums count
it, so the padding rows also take the blocks JAX's routing gives them.

Large scenes take the JAX package's per-stem path instead (`_use_grid`:
the contact model's `broad_phase` is "auto", "dense" or "grid"; "auto"
sends a candidate block over GRID_PAIR_THRESHOLD pairs to the hash grid).
When the combined PT or EE grid is over the threshold, `broad_fn` runs
`_broad_grid` for every stem: stage 1 gives each query row its K smallest
candidate target ids (kernel L, `ops.rowk_select`, over a hash-grid bucket
that kernel K, `ops.grid_build`, built, or over every target of a block
that stays dense), stage 2 takes exact distances over that (Nq, K) grid
(kernel G, padding rows skipped) and compacts the pairs within dhat + slack
into a per-stem mid segment (kernel E); the segments, in global ids, are
the mid lists `pairs_fn` reads as before. The intersection oracle and the
friction tables have the same per-block branches. No (Nq, Nt) mask is
built for a block on the grid: its exclusions are kernel L's predicate.

Exclusion rules mirror tmcd's broad phase (BroadPhasePTEEBase.cpp:540-544,
711-721): PT drops same-mesh incident pairs; EE dedups by (mesh, index)
order and drops same-mesh vertex-sharing pairs; rigid-rigid pairs of one
mesh are dropped (their distance cannot change).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch
from torch.func import vmap

from ... import maths
from ...ops.ball_wide import ball_wide
from ...ops.compact import compact
from ...ops.friction_pairs import (contact_pairs_ee, contact_pairs_pt,
                                   friction_pairs_ee, friction_pairs_pt)
from ...ops.friction_rows import friction_rows_ee, friction_rows_pt
from ...collision.broad_phase import (max_query_radius, pick_cell_size,
                                      table_size_for)
from ...ops.grid_build import grid_build
from ...ops.narrow import ee_distance, pt_distance
from ...ops.rowk_select import GridIndex, Pred, Sphere, rowk_select
from ...ops.segment_triangle import segment_triangle_any

# blocks with more candidate pairs than this take the hash grid (stark_tpu
# contact_engine.py:43)
GRID_PAIR_THRESHOLD = 1 << 27
BROAD_PHASES = ("auto", "dense", "grid")
# ulps of the coordinate scale added to JAX's ball-bound pad (_bound_pad)
BOUND_PAD_ULPS = 4.0
# the kernel wrappers the engine launches, by name. Each engine reads them
# from its `kern` attribute; a check may give one engine another table with
# the same names and signatures (chip_smoke.py holds the broad shell and the
# friction tables against their plain twins so).
KERNELS = dict(ball_wide=ball_wide, compact=compact, contact_pairs_ee=contact_pairs_ee,
               contact_pairs_pt=contact_pairs_pt, ee_distance=ee_distance,
               friction_pairs_ee=friction_pairs_ee, friction_pairs_pt=friction_pairs_pt,
               friction_rows_ee=friction_rows_ee, friction_rows_pt=friction_rows_pt,
               grid_build=grid_build, pt_distance=pt_distance, rowk_select=rowk_select,
               segment_triangle_any=segment_triangle_any)


def _pad_index(off: int, n: int) -> int:
    """The local index a routed row past the count takes in JAX: its flat
    row 0, localized (0 - off), gathered from n entries under JAX's rule
    (a negative index wraps once, what stays out of range clamps)."""
    i = -off + (n if off > 0 else 0)
    return min(max(i, 0), max(n - 1, 0))


class ContactEngine:
    def __init__(self, model, layout, dtype: torch.dtype, device: torch.device):
        self.model = model
        self.layout = layout
        self.dtype = dtype
        self.device = device
        self._caps: Dict[str, int] = {}
        self._last_overflow = []
        self.kern = SimpleNamespace(**KERNELS)
        # the staged solver's host tables: the contact tables of the last
        # refresh_contacts, the friction tables of the step (None: not
        # built for this step; the fused solve builds its own)
        self._contact_data: Dict[str, dict] = {}
        self._friction_data = None
        # {table: rows before its count} of the staged tables above
        self._live_rows: Dict[str, int] = {}
        self._build_static_tables()

    # ------------------------------------------------------------------
    # static tables (host numpy, then on the device once)
    # ------------------------------------------------------------------
    def _build_static_tables(self):
        m = self.model
        sv_gid, sv_mesh = [], []
        rv_body, rv_loc, rv_mesh = [], [], []
        es, es_mesh, er, er_mesh = [], [], [], []
        ts, ts_mesh, tr, tr_mesh = [], [], [], []
        for mesh in m.meshes:
            h = mesh.handler_idx
            if mesh.is_rigid:
                base = len(rv_body)
                for loc in mesh.local_vertices:
                    rv_body.append(mesh.rb_idx)
                    rv_loc.append(loc)
                    rv_mesh.append(h)
                for e in mesh.edges:
                    er.append([base + e[0], base + e[1]])
                    er_mesh.append(h)
                for t in mesh.triangles:
                    tr.append([base + t[0], base + t[1], base + t[2]])
                    tr_mesh.append(h)
            else:
                base = len(sv_gid)
                for gid in mesh.point_ids:
                    sv_gid.append(int(gid))
                    sv_mesh.append(h)
                for e in mesh.edges:
                    es.append([base + e[0], base + e[1]])
                    es_mesh.append(h)
                for t in mesh.triangles:
                    ts.append([base + t[0], base + t[1], base + t[2]])
                    ts_mesh.append(h)

        ii = np.int64
        self.sv_gid = np.asarray(sv_gid, ii)
        self.sv_mesh = np.asarray(sv_mesh, ii)
        self.rv_body = np.asarray(rv_body, ii)
        self.rv_loc = np.asarray(rv_loc, np.float64).reshape(-1, 3)
        self.rv_mesh = np.asarray(rv_mesh, ii)
        self.es = np.asarray(es, ii).reshape(-1, 2)
        self.es_mesh = np.asarray(es_mesh, ii)
        self.er = np.asarray(er, ii).reshape(-1, 2)
        self.er_mesh = np.asarray(er_mesh, ii)
        self.ts = np.asarray(ts, ii).reshape(-1, 3)
        self.ts_mesh = np.asarray(ts_mesh, ii)
        self.tr = np.asarray(tr, ii).reshape(-1, 3)
        self.tr_mesh = np.asarray(tr_mesh, ii)

        nm = len(m.contact_thicknesses)
        enabled = np.ones((nm, nm), dtype=bool)
        for (a, b) in m.disabled_pairs:
            enabled[a, b] = enabled[b, a] = False
        self.enabled_mat = enabled

        self.n_soft = self.layout.n_soft
        self.rv_vblock = self.n_soft + 2 * self.rv_body
        self.rv_wblock = self.rv_vblock + 1

        # combined primitive tables: soft first, rigid after, all indexing
        # the concatenated world array Vcat = [Vs; Vr]
        n_sv, n_rv = len(self.sv_gid), len(self.rv_body)
        self.n_sv, self.n_rv = n_sv, n_rv
        self.n_ts, self.n_tr = len(self.ts), len(self.tr)
        self.n_es, self.n_er = len(self.es), len(self.er)
        self.p_mesh_all = np.concatenate([self.sv_mesh, self.rv_mesh])
        self.tris_all = np.concatenate([self.ts, self.tr + n_sv]).reshape(-1, 3)
        self.t_mesh_all = np.concatenate([self.ts_mesh, self.tr_mesh])
        self.edges_all = np.concatenate([self.es, self.er + n_sv]).reshape(-1, 2)
        self.e_mesh_all = np.concatenate([self.es_mesh, self.er_mesh])
        Np, Nt, Ne = len(self.p_mesh_all), len(self.tris_all), len(self.edges_all)
        self.dense_pt = not self._use_grid(Np, Nt)
        self.dense_ee = not self._use_grid(Ne, Ne)
        self.dense_et = not self._use_grid(Ne, Nt)

        is_rigid_p = np.arange(Np) >= n_sv
        is_rigid_t = np.arange(Nt) >= self.n_ts
        is_rigid_e = np.arange(Ne) >= self.n_es
        pm, tm, em = self.p_mesh_all, self.t_mesh_all, self.e_mesh_all

        # the combined (N, M) allowed masks exist only where the combined
        # dense path runs them: PT and EE together (broad_fn, friction), ET
        # alone (the oracle). A block on the grid never gets one.
        pt = ee = et = None
        if self.dense_pt and self.dense_ee:
            # PT: same-mesh incident pairs and same-mesh rigid-rigid pairs out
            pt = enabled[np.ix_(pm, tm)].copy()
            same = pm[:, None] == tm[None, :]
            inc = np.zeros((Np, Nt), dtype=bool)
            for k in range(3):
                inc |= np.arange(Np)[:, None] == self.tris_all[None, :, k]
            pt &= ~(same & inc)
            pt &= ~(same & is_rigid_p[:, None] & is_rigid_t[None, :])

            # EE: same-mesh vertex sharing out, tmcd dedup, rigid-rigid same mesh
            ee = enabled[np.ix_(em, em)].copy()
            same = em[:, None] == em[None, :]
            share = np.zeros((Ne, Ne), dtype=bool)
            for i in range(2):
                for j in range(2):
                    share |= self.edges_all[:, None, i] == self.edges_all[None, :, j]
            ee &= ~(same & share)
            ei = np.arange(Ne)
            ee &= (em[None, :] > em[:, None]) | (same & (ei[None, :] > ei[:, None]))
            ee &= ~(same & is_rigid_e[:, None] & is_rigid_e[None, :])

        if self.dense_et:
            # ET (intersection oracle): vertex-sharing and rigid-rigid
            # same-mesh pairs out, and disable_collision pairs (the reference
            # blacklists them in the intersection detector too, cpp:114-117)
            same = em[:, None] == tm[None, :]
            share = np.zeros((Ne, Nt), dtype=bool)
            for i in range(2):
                for k in range(3):
                    share |= self.edges_all[:, None, i] == self.tris_all[None, :, k]
            et = ~(same & share)
            et &= ~(same & is_rigid_e[:, None] & is_rigid_t[None, :])
            et &= enabled[np.ix_(em, tm)]

        dev = self.device

        def i32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

        def i64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

        def u8(a):
            return None if a is None else torch.as_tensor(a.astype(np.uint8),
                                                          device=dev)

        self.d_pt_allowed = u8(pt)
        self.d_ee_allowed = u8(ee)
        self.d_et_allowed = u8(et)
        # per-stem tables of the grid path (local ids, int32): kernel L's
        # predicate reads them
        self.d_enabled = u8(enabled.reshape(-1))
        self.d_local = {name: i32(getattr(self, name)) for name in (
            "ts", "tr", "es", "er", "sv_mesh", "rv_mesh", "ts_mesh", "tr_mesh",
            "es_mesh", "er_mesh")}
        self.d_tris_all = i32(self.tris_all)
        self.d_edges_all = i32(self.edges_all)
        self.d_p_mesh = i64(pm)
        self.d_t_mesh = i64(tm)
        self.d_e_mesh = i64(em)
        self.d_p_mesh32, self.d_t_mesh32, self.d_e_mesh32 = i32(pm), i32(tm), i32(em)
        self.d_sv_gid = i64(self.sv_gid)
        self.d_rv_body = i64(self.rv_body)
        self.d_rv_loc = torch.as_tensor(self.rv_loc, dtype=self.dtype, device=dev)
        self.d_rv_vblock = i64(self.rv_vblock)
        self.d_rv_wblock = i64(self.rv_wblock)
        self.d_ts, self.d_tr = i64(self.ts), i64(self.tr)
        self.d_es, self.d_er = i64(self.es), i64(self.er)

    # ------------------------------------------------------------------
    # capacities (the JAX package's sizing, stark_tpu contact_engine.py
    # :398-540)
    # ------------------------------------------------------------------
    def _cap(self, name: str) -> int:
        """Initial capacity of a list, sized from the mesh as JAX sizes it.
        Prefixes: m_/im_ mid lists, w_ ball-bound wide lists, f_ friction
        tables, g_<block>_ins/_occ the hash grid's insertion slots per
        target and bucket-scan length, c_/cf_/i_ per-query candidate row
        slots (K of the (Nq, K) stage-1 grids: contact, friction,
        intersection); a bare stem is its family pair table."""
        if name not in self._caps:
            n_sv, n_rv, n_es, n_er = self.n_sv, self.n_rv, self.n_es, self.n_er
            n_ts, n_tr = self.n_ts, self.n_tr
            if name == "m_pt":
                h = (24 + (16 if n_tr else 0)) * max(n_sv, 64) + 64 * n_rv
            elif name == "m_ee":
                h = 48 * max(n_es, 64) + n_er * max(64, n_es // 2)
            elif name == "im_et":
                h = 32 * max(n_es, 64) + n_er * max(64, n_ts + n_tr)
            elif name.startswith(("m_", "im_")):
                # per-stem (per-block) mid segments of the grid path
                h = 4 * self._cap(name[2:] if name.startswith("m_") else name[3:])
            elif name.startswith("w_"):
                kind = name[2:]
                mkey = "im_et" if kind == "et" else "m_" + kind
                Np, Nt, Ne = len(self.p_mesh_all), len(self.tris_all), len(self.edges_all)
                full = {"pt": Np * max(Nt, 1), "ee": Ne * Ne,
                        "et": Ne * max(Nt, 1)}[kind]
                h = min(2 * self._cap(mkey), max(full, 256))
            elif name.startswith("g_"):
                h = 64 if name.endswith("_ins") else 512
            elif name.startswith("cf_"):
                h = min(64, max(1, self._block_sizes(name[3:])[1]))
            elif name.startswith("c_"):
                stem = name[2:]
                nt = self._block_sizes(stem)[1]
                # rigid-edge queries (ee_dr queries the box's edges) cover
                # most of a nearby mesh: full candidacy; rows are few
                h = max(1, nt) if stem in ("ee_dr", "ee_rr") else \
                    min(1024 if stem.startswith("ee") else 512, max(1, nt))
            elif name.startswith("i_"):
                nt = n_ts if name[3] == "s" else n_tr
                h = max(1, nt) if name[2] == "r" else min(512, max(1, nt))
            elif name in ("f_pt", "f_ee"):
                # kernel I's flat friction list of one kind, routed into the
                # f_<stem> tables: their capacities together
                h = sum(self._cap("f_" + s) for s in self._blocks()
                        if s.startswith(name[2:]))
            elif name in ("cl_pt", "cl_ee"):
                # kernel I's flat contact list of one kind (the staged
                # refresh), routed into the <stem> tables
                h = sum(self._cap(s) for s in self._blocks() if s.startswith(name[3:]))
            else:   # family pair tables (f_<stem>: the friction tables)
                stem = name[2:] if name.startswith("f_") else name
                h = {"pt_dd": 4 * n_sv, "pt_dr": 2 * n_sv,
                     "pt_rd": max(n_rv, n_ts), "pt_rr": n_rv,
                     "ee_dd": 4 * n_es, "ee_dr": max(n_er, n_es),
                     "ee_rr": n_er}[stem]
            cap = 16 if name.startswith(("c_", "cf_", "i_")) else 256
            while cap < h:
                cap *= 2
            self._caps[name] = cap
        return self._caps[name]

    def cap_names(self):
        """Every capacity name this engine can use."""
        stems = self._blocks()
        names = {"w_pt", "w_ee", "w_et", "m_pt", "m_ee", "im_et", "f_pt", "f_ee",
                 "cl_pt", "cl_ee"}
        for s in stems:
            names |= {s, "f_" + s, "c_" + s, "cf_" + s, "m_" + s,
                      "g_" + s + "_ins", "g_" + s + "_occ"}
        for k, _nq, _nt in self._i_blocks():
            names |= {k, "im_" + k, "g_" + k + "_ins", "g_" + k + "_occ"}
        return names

    def set_caps(self, caps: Dict[str, int]):
        """Start from given capacities (e.g. the JAX engine's, carried over
        by utils/from_jax.py); unknown names are ignored."""
        known = self.cap_names()
        for k, v in caps.items():
            if k in known:
                self._caps[k] = int(v)

    # ------------------------------------------------------------------
    # routing: which blocks take the hash grid (stark_tpu :545-583)
    # ------------------------------------------------------------------
    def _use_grid(self, nq: int, nt: int) -> bool:
        mode = self.model.broad_phase
        if mode not in BROAD_PHASES:
            raise ValueError(f"broad_phase must be one of {BROAD_PHASES}, not {mode!r}")
        if mode == "dense":
            return False
        if mode == "grid":
            return True
        return nq * nt > GRID_PAIR_THRESHOLD

    def _block_sizes(self, stem):
        """(n_queries, n_targets) of a candidate block. For EE stems the
        query side is the first geometry of _ee_geom: the rigid edges for
        ee_dr."""
        if stem.startswith("pt"):
            nq = self.n_sv if stem[3] == "d" else self.n_rv
            nt = self.n_ts if stem[4] == "d" else self.n_tr
        elif stem == "ee_dd":
            nq = nt = self.n_es
        elif stem == "ee_dr":
            nq, nt = self.n_er, self.n_es
        else:   # ee_rr
            nq = nt = self.n_er
        return nq, nt

    def _stage1_keys(self, stem):
        """The count keys of a block's stage 1: its candidate row count and,
        on the grid, the insertion and occupancy maxima."""
        keys = ["c_" + stem]
        if self._use_grid(*self._block_sizes(stem)):
            keys += ["g_" + stem + "_ins", "g_" + stem + "_occ"]
        return keys

    def _blocks(self):
        blocks = []
        if self.n_sv and self.n_ts:
            blocks.append("pt_dd")
        if self.n_sv and self.n_tr:
            blocks.append("pt_dr")
        if self.n_rv and self.n_ts:
            blocks.append("pt_rd")
        if self.n_rv and self.n_tr:
            blocks.append("pt_rr")
        if self.n_es:
            blocks.append("ee_dd")
        if self.n_er and self.n_es:
            blocks.append("ee_dr")
        if self.n_er:
            blocks.append("ee_rr")
        return blocks

    def _pt_stems(self):
        return [s for s in self._blocks() if s.startswith("pt")]

    def _ee_stems(self):
        return [s for s in self._blocks() if s.startswith("ee")]

    def _all_dense(self):
        return self.dense_pt and self.dense_ee

    def broad_count_keys(self):
        keys = []
        if self._all_dense():
            if self._pt_stems():
                keys += ["w_pt", "m_pt"]
            if self._ee_stems():
                keys += ["w_ee", "m_ee"]
        else:
            for stem in self._blocks():
                keys += self._stage1_keys(stem)
                keys.append("m_" + stem)
        if self.isect_on():
            keys += self.intersect_count_keys()
        return keys

    def intersect_count_keys(self):
        """The count keys of _isect_stage1."""
        if self.dense_et:
            return ["w_et", "im_et"] if len(self.edges_all) and len(self.tris_all) \
                else []
        keys = []
        for k, nq, nt in self._i_blocks():
            keys += [k, "im_" + k]
            if self._use_grid(nq, nt):
                keys += ["g_" + k + "_ins", "g_" + k + "_occ"]
        return keys

    def pair_count_keys(self):
        keys = list(self._blocks())
        if self._pt_stems():
            keys.append("n_live_pt")
        if self._ee_stems():
            keys.append("n_live_ee")
        return keys

    def friction_count_keys(self):
        """Count keys of friction_tables: on the dense path kernel I's flat
        lists, then the friction family tables; on the grid path each
        block's family table, candidate row count and grid maxima."""
        if self._all_dense():
            flat = [k for k in ("f_pt", "f_ee")
                    if any(s.startswith(k[2:]) for s in self._blocks())]
            return flat + ["f_" + stem for stem in self._blocks()]
        keys = []
        for stem in self._blocks():
            keys += ["f_" + stem, "cf_" + stem]
            if self._use_grid(*self._block_sizes(stem)):
                keys += ["g_" + stem + "_ins", "g_" + stem + "_occ"]
        return keys

    def contact_count_keys(self):
        """The count keys of _contacts_fn: on the dense path kernel I's flat
        contact lists, then the family tables; on the per-stem path each
        block's family table, candidate row count and grid maxima
        (stark_tpu :1685-1693 has the same keys but the flat lists)."""
        if self._all_dense():
            flat = [k for k in ("cl_pt", "cl_ee")
                    if any(s.startswith(k[3:]) for s in self._blocks())]
            return flat + list(self._blocks())
        keys = []
        for stem in self._blocks():
            keys.append(stem)
            keys += self._stage1_keys(stem)
        return keys

    def friction_enabled_now(self) -> bool:
        """Friction tables are non-trivial: friction on and some pair mu."""
        return (self.model.global_params.friction_enabled
                and self.model.stark.settings.simulation.init_frictional_contact
                and any(v != 0.0 for v in self.model.pair_mu.values()))

    def isect_on(self) -> bool:
        return self.model.global_params.intersection_test_enabled

    def _check_overflow(self, keys, counts) -> bool:
        """Bump every capacity a count exceeded (and, when one did, every
        other one at 75% or more); returns whether any overflowed."""
        overflow = False
        self._last_overflow = []
        near_full = []
        for k, c in zip(keys, counts):
            if k.startswith("n_live_"):
                continue
            c = int(c)
            if c > self._caps[k]:
                self._caps[k] = max(2 * self._caps[k], int(1.5 * c))
                overflow = True
                self._last_overflow.append((k, c))
            elif 4 * c > 3 * self._caps[k]:
                near_full.append((k, c))
        if overflow:
            for k, c in near_full:
                self._caps[k] *= 2
                self._last_overflow.append((k, c))
        return overflow

    # ------------------------------------------------------------------
    # world positions
    # ------------------------------------------------------------------
    def engine_state(self):
        m = self.model
        state = {}
        if self.n_sv:
            state["x0"] = m.dyn.x0
        if self.n_rv:
            state["rb_t0"] = torch.as_tensor(m.rb_dyn.t0, dtype=self.dtype,
                                             device=self.device)
            state["rb_q0"] = torch.as_tensor(m.rb_dyn.q0, dtype=self.dtype,
                                             device=self.device)
        return state

    def world_from_u(self, u, state, dt):
        """(Vs, Vr) world positions of the soft and rigid contact vertices
        under trial DOFs u."""
        ns = self.n_soft
        Vs = Vr = None
        if self.n_sv:
            Vs = state["x0"][self.d_sv_gid] + dt * u[:ns][self.d_sv_gid]
        if self.n_rv:
            rw = u[ns:].reshape(-1, 2, 3)
            R1 = vmap(maths.quat_integration_rotation, in_dims=(0, 0, None))(
                state["rb_q0"], rw[:, 1], dt)
            t1 = state["rb_t0"] + dt * rw[:, 0]
            Vr = t1[self.d_rv_body] + torch.einsum(
                "vij,vj->vi", R1[self.d_rv_body], self.d_rv_loc)
        return Vs, Vr

    def _vcat(self, Vs, Vr):
        parts = [v for v in (Vs, Vr) if v is not None]
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def th_vec(self):
        """Per-mesh contact thickness; dhat of a pair is th[a] + th[b]."""
        return torch.as_tensor(self.model.contact_thicknesses, dtype=self.dtype,
                               device=self.device)

    def max_rigid_lever(self) -> float:
        """Largest |r| of a rigid contact vertex: turns an angular step bound
        into a world displacement bound (fused.py du_reach)."""
        if self.n_rv == 0:
            return 0.0
        return float(np.max(np.linalg.norm(self.rv_loc, axis=1)))

    def _mu_mat(self):
        """(M, M) Coulomb mu between the contact meshes, symmetric."""
        nm = len(self.model.contact_thicknesses)
        mu = np.zeros((nm, nm))
        for (a, b), v in self.model.pair_mu.items():
            mu[a, b] = mu[b, a] = v
        return torch.as_tensor(mu, dtype=self.dtype, device=self.device)

    def glob_entries(self):
        # mu is an argument of every solve, so set_friction takes effect at
        # the next step
        def t(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        return {"contact_k": t(self.model.contact_stiffness),
                "friction_epsv": t(self.model.global_params.friction_stick_slide_threshold),
                "mu_mat": self._mu_mat()}

    # ------------------------------------------------------------------
    # balls and compactions
    # ------------------------------------------------------------------
    @staticmethod
    def _balls_of_tris(V, tris):
        """(centroid, covering radius) of each triangle of V[tris]."""
        tq = tris.long()
        t0, t1, t2 = V[tq[:, 0]], V[tq[:, 1]], V[tq[:, 2]]
        c = (t0 + t1 + t2) / 3.0
        r = torch.sqrt(torch.maximum(torch.maximum(
            torch.sum((t0 - c) ** 2, -1), torch.sum((t1 - c) ** 2, -1)),
            torch.sum((t2 - c) ** 2, -1)))
        return c, r

    @staticmethod
    def _balls_of_edges(V, edges):
        """(midpoint, half-length) of each edge of V[edges]."""
        eq = edges.long()
        p0, p1 = V[eq[:, 0]], V[eq[:, 1]]
        return 0.5 * (p0 + p1), 0.5 * torch.linalg.norm(p1 - p0, dim=-1)

    def _tri_balls(self, Vcat):
        return self._balls_of_tris(Vcat, self.d_tris_all)

    def _edge_balls(self, Vcat):
        return self._balls_of_edges(Vcat, self.d_edges_all)

    def _bound_pad(self, Vcat):
        """Slop on the ball threshold covering the cancellation of the
        |a|^2 + |b|^2 - 2 a.b form at coordinate magnitude max|V|: JAX's
        8 sqrt(eps) scale, plus BOUND_PAD_ULPS ulps of the scale, so that
        ball radii rounded an ulp apart (the card's reductions against the
        CPU's) cannot drop a pair JAX's list holds. The ball test is a
        conservative prefilter; the exact stages keep the same pairs."""
        scale = 1.0 + torch.max(torch.abs(Vcat))
        eps = torch.finfo(self.dtype).eps
        return (8.0 * float(np.sqrt(eps)) + BOUND_PAD_ULPS * eps) * scale

    def _ball_wide(self, key, A, ra, B, rb, allowed, extra):
        cap = self._cap(key)
        q, t, cnt = self.kern.ball_wide(A, ra, B, rb, allowed, extra, cap)
        act = torch.arange(cap, device=q.device) < torch.clamp_max(cnt, cap)
        return (q, t, act), cnt

    def _refine(self, q, t, keep, cap, site):
        sel, cnt = self.kern.compact(keep, cap, site)
        sl = sel.long()
        act = torch.arange(cap, device=q.device) < torch.clamp_max(cnt, cap)
        return (q[sl], t[sl], act), cnt

    # ------------------------------------------------------------------
    # routing into family pair tables
    # ------------------------------------------------------------------
    def _route_pt(self, q, t, valid, dhat_rows, cap_pfx="", d_rows=None):
        """Route flat PT rows into the family tables (capacities
        cap_pfx + stem): {stem: (p_loc, t_loc, active, dhat, d or None,
        count)}, each stem's rows in the flat list's order."""
        out = {}
        ps = q < self.n_sv
        ts_ = t < self.n_ts
        masks = {"pt_dd": ps & ts_, "pt_dr": ps & ~ts_,
                 "pt_rd": ~ps & ts_, "pt_rr": ~ps & ~ts_}
        for stem in self._pt_stems():
            cap = self._cap(cap_pfx + stem)
            sel, cnt = self.kern.compact(valid & masks[stem], cap, "route_" + cap_pfx + stem)
            sl = sel.long()
            active = torch.arange(cap, device=q.device) < torch.clamp_max(cnt, cap)
            qo, to = (0, self.n_sv) if stem[3] == "d" else (self.n_sv, self.n_rv), \
                (0, self.n_ts) if stem[4] == "d" else (self.n_ts, self.n_tr)
            p_loc = torch.where(active, q[sl].long() - qo[0], _pad_index(*qo))
            t_loc = torch.where(active, t[sl].long() - to[0], _pad_index(*to))
            d_sel = None if d_rows is None else d_rows[sl]
            out[stem] = (p_loc, t_loc, active, dhat_rows[sl], d_sel, cnt)
        return out

    def _route_ee(self, a, b, valid, dhat_rows, cap_pfx="", d_rows=None):
        """As _route_pt for EE rows; ee_dr rows come out as (rigid edge,
        soft edge), ee_dd and ee_rr in the deduped (a, b) order."""
        out = {}
        as_ = a < self.n_es
        bs_ = b < self.n_es
        for stem in self._ee_stems():
            cap = self._cap(cap_pfx + stem)
            if stem == "ee_dd":
                mask, aa, bb = as_ & bs_, a, b
            elif stem == "ee_rr":
                mask, aa, bb = ~as_ & ~bs_, a, b
            else:   # mixed rows: (rigid side, soft side)
                mask = as_ != bs_
                aa = torch.where(as_, b, a)
                bb = torch.where(as_, a, b)
            sel, cnt = self.kern.compact(valid & mask, cap, "route_" + cap_pfx + stem)
            sl = sel.long()
            active = torch.arange(cap, device=a.device) < torch.clamp_max(cnt, cap)
            ao = (0, self.n_es) if stem == "ee_dd" else (self.n_es, self.n_er)
            bo = (self.n_es, self.n_er) if stem == "ee_rr" else (0, self.n_es)
            a_loc = torch.where(active, aa[sl].long() - ao[0], _pad_index(*ao))
            b_loc = torch.where(active, bb[sl].long() - bo[0], _pad_index(*bo))
            d_sel = None if d_rows is None else d_rows[sl]
            out[stem] = (a_loc, b_loc, active, dhat_rows[sl], d_sel, cnt)
        return out

    def _pt_family_data(self, stem, p_idx, t_idx, active, dhat):
        rows = {"active": active.to(self.dtype), "dhat": dhat}
        gid = self.d_sv_gid
        if stem == "pt_dd":
            nodes = torch.cat([gid[p_idx][:, None], gid[self.d_ts[t_idx]]], dim=1)
            rows["nodes"] = nodes
            conn = nodes
        elif stem == "pt_dr":
            tri = self.d_tr[t_idx]
            rows["node_p"] = gid[p_idx]
            rows["body_b"] = self.d_rv_body[tri[:, 0]]
            rows["t_loc"] = self.d_rv_loc[tri]
            conn = torch.stack([gid[p_idx], self.d_rv_vblock[tri[:, 0]],
                                self.d_rv_wblock[tri[:, 0]]], dim=1)
        elif stem == "pt_rd":
            tri = self.d_ts[t_idx]
            rows["body_a"] = self.d_rv_body[p_idx]
            rows["p_loc"] = self.d_rv_loc[p_idx]
            rows["nodes_t"] = gid[tri]
            conn = torch.cat([self.d_rv_vblock[p_idx][:, None],
                              self.d_rv_wblock[p_idx][:, None], gid[tri]], dim=1)
        else:   # pt_rr
            tri = self.d_tr[t_idx]
            rows["body_a"] = self.d_rv_body[p_idx]
            rows["p_loc"] = self.d_rv_loc[p_idx]
            rows["body_b"] = self.d_rv_body[tri[:, 0]]
            rows["t_loc"] = self.d_rv_loc[tri]
            conn = torch.stack([self.d_rv_vblock[p_idx], self.d_rv_wblock[p_idx],
                                self.d_rv_vblock[tri[:, 0]],
                                self.d_rv_wblock[tri[:, 0]]], dim=1)
        return {"conn": conn, "rows": rows}

    def _ee_family_data(self, stem, a_idx, b_idx, active, dhat):
        rows = {"active": active.to(self.dtype), "dhat": dhat}
        gid = self.d_sv_gid
        if stem == "ee_dd":
            nodes = torch.cat([gid[self.d_es[a_idx]], gid[self.d_es[b_idx]]], dim=1)
            rows["nodes"] = nodes
            conn = nodes
        elif stem == "ee_dr":
            ea, eb = self.d_er[a_idx], self.d_es[b_idx]
            rows["body_a"] = self.d_rv_body[ea[:, 0]]
            rows["ea_loc"] = self.d_rv_loc[ea]
            rows["nodes_b"] = gid[eb]
            conn = torch.cat([self.d_rv_vblock[ea[:, 0]][:, None],
                              self.d_rv_wblock[ea[:, 0]][:, None], gid[eb]], dim=1)
        else:   # ee_rr
            ea, eb = self.d_er[a_idx], self.d_er[b_idx]
            rows["body_a"] = self.d_rv_body[ea[:, 0]]
            rows["ea_loc"] = self.d_rv_loc[ea]
            rows["body_b"] = self.d_rv_body[eb[:, 0]]
            rows["eb_loc"] = self.d_rv_loc[eb]
            conn = torch.stack([self.d_rv_vblock[ea[:, 0]], self.d_rv_wblock[ea[:, 0]],
                                self.d_rv_vblock[eb[:, 0]],
                                self.d_rv_wblock[eb[:, 0]]], dim=1)
        return {"conn": conn, "rows": rows}

    # ------------------------------------------------------------------
    # the two shells
    # ------------------------------------------------------------------
    def broad_fn(self, Vs, Vr, th, slack_b, slack_p):
        """Broad shell: flat mid lists {kind: (q, t, act)} of candidate pairs
        within d <= dhat + slack_p + slack_b of THIS state, the intersection
        candidates, and the counts {key: 0-d int32}."""
        icands = {}
        if self._all_dense():
            mcands, counts = self._broad_dense(Vs, Vr, th, slack_b, slack_p)
        else:
            mcands, counts = self._broad_grid(Vs, Vr, th, slack_b, slack_p)
        if self.isect_on():
            icands, icounts = self._isect_stage1(Vs, Vr, slack_b)
            counts.update(icounts)
        return mcands, icands, counts

    def _broad_dense(self, Vs, Vr, th, slack_b, slack_p):
        """The combined dense broad shell: ball pairs of every kind (kernel
        F), exact distances over them (G), compacted into the mid lists (E)."""
        mcands, counts = {}, {}
        margin = slack_p + slack_b
        Vcat = self._vcat(Vs, Vr)
        pad = self._bound_pad(Vcat)
        th_p, th_t, th_e = th[self.d_p_mesh], th[self.d_t_mesh], th[self.d_e_mesh]
        if self._pt_stems():
            c, r = self._tri_balls(Vcat)
            (q, t, act), counts["w_pt"] = self._ball_wide(
                "w_pt", Vcat, th_p, c, r + th_t, self.d_pt_allowed, margin + pad)
            bound = th_p[q.long()] + th_t[t.long()] + margin
            _d, keep = self.kern.pt_distance(Vcat, Vcat, self.d_tris_all, q, t, act, None, bound)
            mcands["pt"], counts["m_pt"] = self._refine(q, t, keep, self._cap("m_pt"),
                                                        "refine_pt")
        if self._ee_stems():
            m, h = self._edge_balls(Vcat)
            (a, b, act), counts["w_ee"] = self._ball_wide(
                "w_ee", m, h + th_e, m, h + th_e, self.d_ee_allowed, margin + pad)
            bound = th_e[a.long()] + th_e[b.long()] + margin
            _d, keep = self.kern.ee_distance(Vcat, self.d_edges_all, a, b,
                                   self.model.edge_edge_cross_norm_sq_cutoff, act, bound)
            mcands["ee"], counts["m_ee"] = self._refine(a, b, keep, self._cap("m_ee"),
                                                        "refine_ee")
        return mcands, counts

    # ------------------------------------------------------------------
    # the per-stem path (stark_tpu :613-916, 1302-1349): stage 1 gives each
    # query its K smallest candidate target ids (kernel L, over a hash-grid
    # bucket of kernel K or over every target), stage 2 keeps the exact
    # pairs within dhat + slack (kernels G and E)
    # ------------------------------------------------------------------
    def _offsets(self, stem):
        """Global id offsets (query side, target side) of a stem's local
        primitive ids in the combined tables; EE stems query the first
        geometry of _ee_geom (the rigid edges for ee_dr)."""
        if stem.startswith("pt"):
            return (0 if stem[3] == "d" else self.n_sv,
                    0 if stem[4] == "d" else self.n_ts)
        return (0 if stem == "ee_dd" else self.n_es,
                self.n_es if stem == "ee_rr" else 0)

    def _allowed_flat(self, extra_mat=None):
        """(M * M,) uint8 allowed mesh pairs: collisions enabled (and, with
        the friction call's mu table, mu != 0)."""
        if extra_mat is None:
            return self.d_enabled
        return (self.d_enabled.to(torch.bool)
                & (extra_mat.reshape(-1) != 0.0)).to(torch.uint8)

    def _pred(self, block, extra_mat=None):
        """Kernel L's exclusion predicate of a candidate block (a contact
        stem or an intersection block i_ss/i_sr/i_rs/i_rr): the tmcd rules
        of the module note, evaluated per candidate."""
        L = self.d_local
        q_side, t_side = {
            "pt_dd": ("sv", "ts"), "pt_dr": ("sv", "tr"), "pt_rd": ("rv", "ts"),
            "pt_rr": ("rv", "tr"), "ee_dd": ("es", "es"), "ee_dr": ("er", "es"),
            "ee_rr": ("er", "er"), "i_ss": ("es", "ts"), "i_sr": ("es", "tr"),
            "i_rs": ("er", "ts"), "i_rr": ("er", "tr")}[block]
        code = {"pt_dd": "pt_dd", "pt_rr": "pt_rr", "ee_dd": "ee_dd",
                "ee_rr": "ee_rr", "i_ss": "et", "i_rr": "et_rr"}.get(block, "none")
        idx = code in ("ee_dd", "et", "et_rr")
        return Pred(code, L[q_side + "_mesh"], L[t_side + "_mesh"],
                    self._allowed_flat(extra_mat),
                    qidx=L[q_side] if idx else None,
                    tidx=L[t_side] if idx or code == "pt_dd" else None)

    def _grid_stage1(self, key, qc, qr, tc, tr, pred, K):
        """Hash-grid stage 1 of a block: cell size and bucket CSR (kernel
        K), then the bucket scan, sphere test |qc - tc| <= qr + tr,
        exclusions and row-K selection (kernel L). Returns (tid (Nq, K),
        max_row, {key_ins: max_cells, key_occ: max_occ})."""
        ins = self._cap(key + "_ins")
        occ = self._cap(key + "_occ")
        h = pick_cell_size(qr, tr)
        offsets, tid_sorted, max_cells = self.kern.grid_build(
            tc, tr, max_query_radius(qr), h, ins, table_size_for(tc.shape[0]))
        tid, max_row, max_occ = self.kern.rowk_select(
            qc, tc, Sphere("grid", qr, tr), pred, K,
            GridIndex(offsets, tid_sorted, h, occ))
        # an insertion-slot overflow loses candidates silently, an occupancy
        # overflow truncates a bucket scan: both bump and re-solve
        return tid, max_row, {key + "_ins": max_cells, key + "_occ": max_occ}

    def _pt_geom(self, stem, Vs, Vr, th):
        """(query points, their thicknesses, triangle centres, covering
        radii, triangle thicknesses) of a PT stem."""
        L = self.d_local
        P, pm = (Vs, L["sv_mesh"]) if stem[3] == "d" else (Vr, L["rv_mesh"])
        T, tri, tm = (Vs, L["ts"], L["ts_mesh"]) if stem[4] == "d" else \
            (Vr, L["tr"], L["tr_mesh"])
        c, r = self._balls_of_tris(T, tri)
        return P, th[pm.long()], c, r, th[tm.long()]

    def _ee_geom(self, stem, Vs, Vr, th):
        """(midpoints, half-lengths, thicknesses) of the query edges, then of
        the target edges, of an EE stem; ee_dr queries the rigid edges."""
        L = self.d_local
        A, ea, am = (Vs, L["es"], L["es_mesh"]) if stem == "ee_dd" else \
            (Vr, L["er"], L["er_mesh"])
        B, eb, bm = (Vr, L["er"], L["er_mesh"]) if stem == "ee_rr" else \
            (Vs, L["es"], L["es_mesh"])
        return (*self._balls_of_edges(A, ea), th[am.long()],
                *self._balls_of_edges(B, eb), th[bm.long()])

    def _stem_pairs(self, stem, Vs, Vr, th, sl, ckey, pfx, extra_mat=None):
        """Stage 1 and stage 2 of one stem: (q, t local ids, active, d,
        dhat, counts) of the pairs within d <= dhat + sl, capacity
        pfx + stem, with the stage-1 counts and ckey (the row count)."""
        K = self._cap(ckey)
        nq, nt = self._block_sizes(stem)
        pred = self._pred(stem, extra_mat)
        grid = self._use_grid(nq, nt)
        counts = {}
        if stem.startswith("pt"):
            P, th_p, c, r, th_t = self._pt_geom(stem, Vs, Vr, th)
            if grid:
                tid, max_row, gc = self._grid_stage1(
                    "g_" + stem, P, th_p + sl, c, r + th_t, pred, K)
                counts.update(gc)
            else:
                tid, max_row, _ = self.kern.rowk_select(
                    P, c, Sphere("pt", th_p, r, tb=th_t, sl=sl), pred, K)
            th_q = th_p
        else:
            ma, ha, th_a, mb, hb, th_b = self._ee_geom(stem, Vs, Vr, th)
            if grid:
                tid, max_row, gc = self._grid_stage1(
                    "g_" + stem, ma, ha + th_a + sl, mb, hb + th_b, pred, K)
                counts.update(gc)
            else:
                tid, max_row, _ = self.kern.rowk_select(
                    ma, mb, Sphere("ee", ha, hb, qb=th_a, tb=th_b, sl=sl), pred, K)
            th_q, th_t = th_a, th_b
        counts[ckey] = max_row
        out = self._stage2(stem, tid, th_q, th_t, sl, self._cap(pfx + stem), pfx,
                           self._vcat(Vs, Vr))
        counts.update(out[-1])
        return out[:-1] + (counts,)

    def _stage2(self, stem, tid, th_q, th_t, sl, cap, pfx, Vcat):
        """Exact distances over the (Nq, K) candidate grid (kernel G, in
        global ids; padding rows cost nothing), the rows with
        d <= (th_q + th_t) + sl compacted (kernel E) in row-major order."""
        Nq, K = tid.shape
        nt = th_t.shape[0]
        dev = tid.device
        qoff, toff = self._offsets(stem)
        tc2 = torch.clamp(tid, 0, max(nt - 1, 0)).reshape(-1)
        q_loc = torch.arange(Nq, dtype=torch.int32, device=dev).repeat_interleave(K)
        in_range = (tid < nt).reshape(-1)
        dhat = th_q[q_loc.long()] + th_t[tc2.long()]
        qg, tg = q_loc + qoff, tc2 + toff
        if stem.startswith("pt"):
            d, valid = self.kern.pt_distance(Vcat, Vcat, self.d_tris_all, qg, tg, in_range,
                                   None, dhat + sl)
        else:
            d, valid = self.kern.ee_distance(Vcat, self.d_edges_all, qg, tg,
                                   self.model.edge_edge_cross_norm_sq_cutoff,
                                   in_range, dhat + sl)
        sel, count = self.kern.compact(valid, cap, "stage2_" + pfx + stem)
        sel = sel.long()
        active = torch.arange(cap, device=dev) < torch.clamp_max(count, cap)
        return (q_loc[sel].long(), tc2[sel].long(), active, d[sel], dhat[sel],
                {pfx + stem: count})

    def _broad_grid(self, Vs, Vr, th, slack_b, slack_p):
        """Grid-path broad shell: each stem's mid segment (stage 1 within
        dhat + slack_b + slack_p, stage 2 under capacity m_<stem>), in
        global ids, concatenated per kind."""
        counts = {}
        sl = slack_b + slack_p
        mid = {"pt": [], "ee": []}
        for stem in self._blocks():
            q, t, act, _d, _dh, c = self._stem_pairs(stem, Vs, Vr, th, sl,
                                                     "c_" + stem, "m_")
            counts.update(c)
            qoff, toff = self._offsets(stem)
            mid[stem[:2]].append(((q + qoff).to(torch.int32),
                                  (t + toff).to(torch.int32), act))
        mcands = {kind: tuple(torch.cat([seg[i] for seg in segs]) for i in range(3))
                  for kind, segs in mid.items() if segs}
        return mcands, counts

    def pairs_fn(self, Vs, Vr, th, mcands, slack_p):
        """Pair shell: the 7 family pair tables from exact distances over the
        frozen mid lists (d <= dhat + slack_p), with the n_live_* metrics
        (d <= dhat)."""
        out, counts = {}, {}
        Vcat = self._vcat(Vs, Vr)
        if "pt" in mcands and self._pt_stems():
            q, t, act = mcands["pt"]
            dhat = th[self.d_p_mesh][q.long()] + th[self.d_t_mesh][t.long()]
            d, valid = self.kern.pt_distance(Vcat, Vcat, self.d_tris_all, q, t, act, None,
                                   dhat + slack_p)
            counts["n_live_pt"] = torch.sum((act & (d <= dhat)).to(torch.int32))
            for stem, (p, tl, a2, dh, _d, cnt) in self._route_pt(q, t, valid, dhat).items():
                out["contact_" + stem] = self._pt_family_data(stem, p, tl, a2, dh)
                counts[stem] = cnt
        if "ee" in mcands and self._ee_stems():
            a, b, act = mcands["ee"]
            the = th[self.d_e_mesh]
            dhat = the[a.long()] + the[b.long()]
            d, valid = self.kern.ee_distance(Vcat, self.d_edges_all, a, b,
                                   self.model.edge_edge_cross_norm_sq_cutoff, act,
                                   dhat + slack_p)
            counts["n_live_ee"] = torch.sum((act & (d <= dhat)).to(torch.int32))
            for stem, (al, bl, a2, dh, _d, cnt) in self._route_ee(a, b, valid, dhat).items():
                out["contact_" + stem] = self._ee_family_data(stem, al, bl, a2, dh)
                counts[stem] = cnt
        return out, counts

    # ------------------------------------------------------------------
    # lagged friction (once per step, from the dt = 0 positions)
    # ------------------------------------------------------------------
    def friction_tables(self, Vs, Vr, th, mu_mat, k):
        """The friction family tables {friction_<stem>: {conn, rows}} and
        their counts from the world positions (Vs, Vr) of the step start:
        every allowed pair whose meshes have a nonzero mu and whose distance
        is within dhat (kernel I over the dense PT and EE grids), routed per
        family in row-major order (kernel E), with per-row anchors (bary, or
        s and t), tangent basis T, mu and normal force fn (kernel J) from
        the barrier force at the frozen distance (EnergyFrictionalContact.
        cpp:531-773). Off the combined dense path, each stem's pairs come from
        its own stage 1 and 2 (capacities cf_<stem>, f_<stem>; stark_tpu
        :1578-1587) and kernel J fills their rows."""
        if not self._all_dense():
            return self._friction_grid(Vs, Vr, th, mu_mat, k)
        btype = self.model.ipc_barrier_type
        out, counts = {}, {}
        Vcat = self._vcat(Vs, Vr)
        dev = Vcat.device

        def flat(cap, cnt):
            return torch.arange(cap, device=dev) < torch.clamp_max(cnt, cap)

        if self._pt_stems():
            cap = self._cap("f_pt")
            q, t, d, dhat, cnt = self.kern.friction_pairs_pt(
                Vcat, self.d_tris_all, self.d_pt_allowed, self.d_p_mesh32,
                self.d_t_mesh32, mu_mat, th, cap)
            counts["f_pt"] = cnt
            routed = self._route_pt(q, t, flat(cap, cnt), dhat, cap_pfx="f_", d_rows=d)
            for stem, (p, tl, act, dh, ds, n) in routed.items():
                counts["f_" + stem] = n
                fd = self._pt_family_data(stem, p, tl, act, dh)
                qg = p + (0 if stem[3] == "d" else self.n_sv)
                tg = tl + (0 if stem[4] == "d" else self.n_ts)
                _reg, bary, T, mu, fn = self.kern.friction_rows_pt(
                    Vcat, self.d_tris_all, qg, tg, n, ds, dh, self.d_p_mesh32,
                    self.d_t_mesh32, mu_mat, k, btype)
                fd["rows"].update(bary=bary, T=T, mu=mu, fn=fn)
                out["friction_" + stem] = fd
        if self._ee_stems():
            cap = self._cap("f_ee")
            ptol = self.model.edge_edge_cross_norm_sq_cutoff
            a, b, d, dhat, cnt = self.kern.friction_pairs_ee(
                Vcat, self.d_edges_all, self.d_ee_allowed, self.d_e_mesh32, mu_mat, th,
                cap, ptol)
            counts["f_ee"] = cnt
            routed = self._route_ee(a, b, flat(cap, cnt), dhat, cap_pfx="f_", d_rows=d)
            for stem, (al, bl, act, dh, ds, n) in routed.items():
                counts["f_" + stem] = n
                fd = self._ee_family_data(stem, al, bl, act, dh)
                ag = al + (0 if stem == "ee_dd" else self.n_es)
                bg = bl + (self.n_es if stem == "ee_rr" else 0)
                _reg, st, T, mu, fn = self.kern.friction_rows_ee(
                    Vcat, self.d_edges_all, ag, bg, n, ds, dh, self.d_e_mesh32, mu_mat,
                    k, btype, ptol)
                fd["rows"].update(s=st[:, 0], t=st[:, 1], T=T, mu=mu, fn=fn)
                out["friction_" + stem] = fd
        return out, counts

    def _friction_grid(self, Vs, Vr, th, mu_mat, k):
        """friction_tables on the per-stem path: the allowed pairs with
        mu != 0 within d <= dhat of each stem (stage 1 with the mu table in
        kernel L's predicate, stage 2), then kernel J's rows."""
        btype = self.model.ipc_barrier_type
        ptol = self.model.edge_edge_cross_norm_sq_cutoff
        out, counts = {}, {}
        Vcat = self._vcat(Vs, Vr)
        zero = torch.zeros((), dtype=self.dtype, device=Vcat.device)
        for stem in self._blocks():
            q, t, act, d, dh, c = self._stem_pairs(stem, Vs, Vr, th, zero, "cf_" + stem,
                                                   "f_", extra_mat=mu_mat)
            counts.update(c)
            n = c["f_" + stem]
            qoff, toff = self._offsets(stem)
            qg, tg = (q + qoff).to(torch.int32), (t + toff).to(torch.int32)
            if stem.startswith("pt"):
                fd = self._pt_family_data(stem, q, t, act, dh)
                _reg, bary, T, mu, fn = self.kern.friction_rows_pt(
                    Vcat, self.d_tris_all, qg, tg, n, d, dh, self.d_p_mesh32,
                    self.d_t_mesh32, mu_mat, k, btype)
                fd["rows"].update(bary=bary, T=T, mu=mu, fn=fn)
            else:
                fd = self._ee_family_data(stem, q, t, act, dh)
                _reg, st, T, mu, fn = self.kern.friction_rows_ee(
                    Vcat, self.d_edges_all, qg, tg, n, d, dh, self.d_e_mesh32, mu_mat,
                    k, btype, ptol)
                fd["rows"].update(s=st[:, 0], t=st[:, 1], T=T, mu=mu, fn=fn)
            out["friction_" + stem] = fd
        return out, counts

    # ------------------------------------------------------------------
    # the staged solver's host tables (stark_tpu :1192-1231, 1512-1527,
    # 1633-1653, 1899-1903)
    # ------------------------------------------------------------------
    def _contacts_fn(self, Vs, Vr, th):
        """The contact family tables {contact_<stem>: {conn, rows}} of every
        allowed pair within d <= dhat at (Vs, Vr), with their counts. Dense
        path: kernel I's contact mode lists each kind's pairs in row-major
        order (capacities cl_pt, cl_ee), routed per family by kernel E, the
        rows of JAX's `allowed & d <= dhat` over its full distance
        matrices. Per-stem path: each stem's stage 1 and 2 at zero slack
        (kernels L, K, G, E), as JAX's `_pt_pairs`/`_ee_pairs`."""
        out, counts = {}, {}
        if self._all_dense():
            Vcat = self._vcat(Vs, Vr)
            dev = Vcat.device
            if self._pt_stems():
                cap = self._cap("cl_pt")
                q, t, _d, dhat, cnt = self.kern.contact_pairs_pt(
                    Vcat, self.d_tris_all, self.d_pt_allowed, self.d_p_mesh32,
                    self.d_t_mesh32, th, cap)
                counts["cl_pt"] = cnt
                act = torch.arange(cap, device=dev) < torch.clamp_max(cnt, cap)
                for stem, (p, tl, a2, dh, _ds, n) in self._route_pt(q, t, act, dhat).items():
                    out["contact_" + stem] = self._pt_family_data(stem, p, tl, a2, dh)
                    counts[stem] = n
            if self._ee_stems():
                cap = self._cap("cl_ee")
                a, b, _d, dhat, cnt = self.kern.contact_pairs_ee(
                    Vcat, self.d_edges_all, self.d_ee_allowed, self.d_e_mesh32, th, cap,
                    self.model.edge_edge_cross_norm_sq_cutoff)
                counts["cl_ee"] = cnt
                act = torch.arange(cap, device=dev) < torch.clamp_max(cnt, cap)
                for stem, (al, bl, a2, dh, _ds, n) in self._route_ee(a, b, act, dhat).items():
                    out["contact_" + stem] = self._ee_family_data(stem, al, bl, a2, dh)
                    counts[stem] = n
            return out, counts
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        for stem in self._blocks():
            q, t, act, _d, dh, c = self._stem_pairs(stem, Vs, Vr, th, zero, "c_" + stem, "")
            family = self._pt_family_data if stem.startswith("pt") else self._ee_family_data
            out["contact_" + stem] = family(stem, q, t, act, dh)
            counts.update(c)
        return out, counts

    def _settled(self, fn):
        """fn() -> (tables, counts), re-run with bumped capacities until no
        count overflows (one read of the counts per run); returns the tables,
        every family at its capacity as in JAX, and the counts on the host,
        and notes each table's live rows (live_rows)."""
        while True:
            tables, counts = fn()
            keys = sorted(counts)
            vals = (torch.stack([counts[k] for k in keys]).cpu().numpy().tolist()
                    if keys else [])
            if not self._check_overflow(keys, vals):
                break
        host = dict(zip(keys, vals))
        for name, fd in tables.items():
            kind, stem = name.split("_", 1)
            self._live_rows[name] = min(int(host[stem if kind == "contact" else "f_" + stem]),
                                        fd["conn"].shape[0])
        return tables, host

    def refresh_contacts(self, dt):
        """Before every staged energy evaluation: the contact tables at the
        current DOFs (x1 = x0 + dt * v1, bodies integrated over dt)."""
        u = self.model.stark._connector["get_dofs"]()
        dt_t = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        Vs, Vr = self.world_from_u(u, self.engine_state(), dt_t)
        th = self.th_vec()
        self._contact_data, _ = self._settled(lambda: self._contacts_fn(Vs, Vr, th))

    def refresh_friction(self, dt):
        """Once per staged step: the lagged friction tables from the
        step-start positions (friction_tables at dt = 0; `dt` is unused, as
        in JAX's _friction_fn); empty when no mesh pair has a nonzero mu."""
        if not any(v != 0.0 for v in self.model.pair_mu.values()):
            self._friction_data = {}
            return
        th = self.th_vec()
        mu = self._mu_mat()
        k = torch.as_tensor(self.model.contact_stiffness, dtype=self.dtype,
                            device=self.device)
        Vs, Vr = self.step_start_world(self.engine_state())
        self._friction_data, _ = self._settled(
            lambda: self.friction_tables(Vs, Vr, th, mu, k))

    def live_rows(self) -> Dict[str, int]:
        """{table: its rows before the count} of the staged tables: the
        rows past it are inactive padding, whose energy and derivatives are
        zero."""
        return self._live_rows

    def current_family_data(self):
        """The staged solver's dynamic tables: the last contact refresh and,
        with friction on, the step's friction tables."""
        data = dict(self._contact_data)
        if self.model.global_params.friction_enabled and self._friction_data:
            data.update(self._friction_data)
        return data

    def step_start_world(self, state):
        """(Vs, Vr) at dt = 0: x1 = x0 and the bodies at (t0, q0), the
        positions the lagged anchors freeze at."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        u = torch.zeros((self.layout.n_blocks, 3), dtype=self.dtype, device=self.device)
        return self.world_from_u(u, state, zero)

    # ------------------------------------------------------------------
    # intersection oracle
    # ------------------------------------------------------------------
    def _i_blocks(self):
        """The per-block intersection candidate blocks (key, n_edges,
        n_tris): soft or rigid edges against soft or rigid triangles."""
        blocks = []
        for key, ne, nt in (("i_ss", self.n_es, self.n_ts), ("i_sr", self.n_es, self.n_tr),
                            ("i_rs", self.n_er, self.n_ts), ("i_rr", self.n_er, self.n_tr)):
            if ne and nt:
                blocks.append((key, ne, nt))
        return blocks

    def _isect_stage1(self, Vs, Vr, slack):
        """Edge-triangle candidates whose exact lower bound
        d(seg, tri) >= d(mid, tri) - h_e is within `slack`: a superset of
        every pair that can cross while the motion stays inside the broad
        budget. Overflow reports as a hit."""
        counts = {}
        if not self.dense_et:
            return self._isect_blocks(Vs, Vr, slack)
        if len(self.edges_all) == 0 or len(self.tris_all) == 0:
            return {}, counts
        Vcat = self._vcat(Vs, Vr)
        m, h = self._edge_balls(Vcat)
        c, r = self._tri_balls(Vcat)
        (e, t, act), wcnt = self._ball_wide("w_et", m, h, c, r, self.d_et_allowed,
                                            slack + self._bound_pad(Vcat))
        counts["w_et"] = wcnt
        R = e.shape[0]
        _d, keep = self.kern.pt_distance(m, Vcat, self.d_tris_all, e, t, act,
                               h[e.long()], slack.reshape(1).expand(R))
        cap = self._cap("im_et")
        (e, t, act), cnt = self._refine(e, t, keep, cap, "refine_et")
        counts["im_et"] = cnt
        overflow = (cnt > cap) | (wcnt > self._cap("w_et"))
        return {"et": (e, t, act, overflow)}, counts

    def _isect_blocks(self, Vs, Vr, slack):
        """The per-block oracle candidates (stark_tpu :1725-1780): stage 1
        with the ET sphere and predicate (kernel L, on the hash grid of
        kernel K where the block is large), the exact lower bound over the
        (Ne, K) grid (G), compacted per block (E), in global ids."""
        counts = {}
        segs = []
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        L = self.d_local
        for key, ne, nt in self._i_blocks():
            E, edges = (Vs, L["es"]) if key[2] == "s" else (Vr, L["er"])
            T, tris = (Vs, L["ts"]) if key[3] == "s" else (Vr, L["tr"])
            c, r = self._balls_of_tris(T, tris)
            m, h = self._balls_of_edges(E, edges)
            K = self._cap(key)
            pred = self._pred(key)
            if self._use_grid(ne, nt):
                tid, max_row, gc = self._grid_stage1("g_" + key, m, h + slack, c, r,
                                                     pred, K)
                counts.update(gc)
            else:
                tid, max_row, _ = self.kern.rowk_select(m, c, Sphere("et", h, r, sl=slack), pred, K)
            counts[key] = max_row
            overflow = overflow | (max_row > K)
            tc = torch.clamp(tid, 0, max(nt - 1, 0)).reshape(-1)
            e_loc = torch.arange(ne, dtype=torch.int32,
                                 device=tid.device).repeat_interleave(K)
            R = e_loc.shape[0]
            _d, ok = self.kern.pt_distance(m, T, tris, e_loc, tc, (tid < nt).reshape(-1),
                                 h[e_loc.long()], slack.reshape(1).expand(R))
            mcap = self._cap("im_" + key)
            sel, cnt = self.kern.compact(ok, mcap, "isect_" + key)
            counts["im_" + key] = cnt
            overflow = overflow | (cnt > mcap)
            sel = sel.long()
            act = torch.arange(mcap, device=tid.device) < torch.clamp_max(cnt, mcap)
            segs.append((e_loc[sel] + (0 if key[2] == "s" else self.n_es),
                         tc[sel] + (0 if key[3] == "s" else self.n_ts), act))
        if not segs:
            return {}, counts
        e, t, act = (torch.cat([seg[i] for seg in segs]) for i in range(3))
        return {"et": (e.to(torch.int32), t.to(torch.int32), act, overflow)}, counts

    def isect_hit(self, Vs, Vr, icands):
        """0-d bool: does any frozen candidate intersect at (Vs, Vr)?"""
        if "et" not in icands:
            return torch.zeros((), dtype=torch.bool, device=self.device)
        e, t, act, overflow = icands["et"]
        return self.kern.segment_triangle_any(self._vcat(Vs, Vr), self.d_edges_all,
                                    self.d_tris_all, e, t, act, overflow)

    def has_intersection(self, dt) -> bool:
        """Host verdict on the current state (the initial-state check)."""
        u = self.model.stark._connector["get_dofs"]()
        dt_t = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        while True:
            Vs, Vr = self.world_from_u(u, self.engine_state(), dt_t)
            zero = torch.zeros((), dtype=self.dtype, device=self.device)
            icands, counts = self._isect_stage1(Vs, Vr, zero)
            hit = self.isect_hit(Vs, Vr, icands)
            keys = sorted(counts)
            vals = torch.stack([counts[k] for k in keys]).cpu().numpy() if keys else []
            if not self._check_overflow(keys, vals):
                return bool(hit)
