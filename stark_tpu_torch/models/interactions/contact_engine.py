"""Device-side contact pipeline of the fused solve: candidate lists, pair
tables and the intersection oracle (dense path, frictionless).

Port of the dense path of `stark_tpu/models/interactions/contact_engine.py`.
The reference rebuilds contact tables from a proximity pass over
x1 = x0 + dt*v1 at every energy evaluation (EnergyFrictionalContact.cpp:
368-530) and asks an edge-triangle oracle whether a state is
penetration-free (:774-799). The fused solve (solver/fused.py) keeps two
frozen shells instead:

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
is ROADMAP Queue 1 P10). Blocks whose dense candidate grid exceeds 2^27
pairs need the spatial-hash path of the JAX package: ROADMAP Queue 1 P9.

Exclusion rules mirror tmcd's broad phase (BroadPhasePTEEBase.cpp:540-544,
711-721): PT drops same-mesh incident pairs; EE dedups by (mesh, index)
order and drops same-mesh vertex-sharing pairs; rigid-rigid pairs of one
mesh are dropped (their distance cannot change).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.func import vmap

from ... import maths
from ...ops.ball_wide import ball_wide
from ...ops.compact import compact
from ...ops.narrow import ee_distance, pt_distance
from ...ops.segment_triangle import segment_triangle_any

GRID_PAIR_THRESHOLD = 1 << 27
P9 = "ROADMAP Queue 1 P9 (the spatial-hash broad phase)"


class ContactEngine:
    def __init__(self, model, layout, dtype: torch.dtype, device: torch.device):
        self.model = model
        self.layout = layout
        self.dtype = dtype
        self.device = device
        self._caps: Dict[str, int] = {}
        self._last_overflow = []
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
        for name, pairs in (("point-triangle", Np * Nt), ("edge-edge", Ne * Ne),
                            ("edge-triangle", Ne * Nt)):
            if pairs > GRID_PAIR_THRESHOLD:
                raise NotImplementedError(
                    f"the dense {name} candidate grid has {pairs} pairs, over "
                    f"2^27: {P9}")

        is_rigid_p = np.arange(Np) >= n_sv
        is_rigid_t = np.arange(Nt) >= self.n_ts
        is_rigid_e = np.arange(Ne) >= self.n_es
        pm, tm, em = self.p_mesh_all, self.t_mesh_all, self.e_mesh_all

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

        # ET (intersection oracle): vertex-sharing and rigid-rigid same-mesh
        # pairs out, and disable_collision pairs (the reference blacklists
        # them in the intersection detector too, cpp:114-117)
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
            return torch.as_tensor(a.astype(np.uint8), device=dev)

        self.d_pt_allowed = u8(pt)
        self.d_ee_allowed = u8(ee)
        self.d_et_allowed = u8(et)
        self.d_tris_all = i32(self.tris_all)
        self.d_edges_all = i32(self.edges_all)
        self.d_p_mesh = i64(pm)
        self.d_t_mesh = i64(tm)
        self.d_e_mesh = i64(em)
        self.d_sv_gid = i64(self.sv_gid)
        self.d_rv_body = i64(self.rv_body)
        self.d_rv_loc = torch.as_tensor(self.rv_loc, dtype=self.dtype, device=dev)
        self.d_rv_vblock = i64(self.rv_vblock)
        self.d_rv_wblock = i64(self.rv_wblock)
        self.d_ts, self.d_tr = i64(self.ts), i64(self.tr)
        self.d_es, self.d_er = i64(self.es), i64(self.er)

    # ------------------------------------------------------------------
    # capacities (the JAX package's sizing, stark_tpu contact_engine.py
    # :398-540, dense path)
    # ------------------------------------------------------------------
    def _cap(self, name: str) -> int:
        if name not in self._caps:
            n_sv, n_rv, n_es, n_er = self.n_sv, self.n_rv, self.n_es, self.n_er
            n_ts, n_tr = self.n_ts, self.n_tr
            if name == "m_pt":
                h = (24 + (16 if n_tr else 0)) * max(n_sv, 64) + 64 * n_rv
            elif name == "m_ee":
                h = 48 * max(n_es, 64) + n_er * max(64, n_es // 2)
            elif name == "im_et":
                h = 32 * max(n_es, 64) + n_er * max(64, n_ts + n_tr)
            elif name.startswith("w_"):
                kind = name[2:]
                mkey = "im_et" if kind == "et" else "m_" + kind
                Np, Nt, Ne = len(self.p_mesh_all), len(self.tris_all), len(self.edges_all)
                full = {"pt": Np * max(Nt, 1), "ee": Ne * Ne,
                        "et": Ne * max(Nt, 1)}[kind]
                h = min(2 * self._cap(mkey), max(full, 256))
            else:   # family pair tables
                h = {"pt_dd": 4 * n_sv, "pt_dr": 2 * n_sv,
                     "pt_rd": max(n_rv, n_ts), "pt_rr": n_rv,
                     "ee_dd": 4 * n_es, "ee_dr": max(n_er, n_es),
                     "ee_rr": n_er}[name]
            cap = 256
            while cap < h:
                cap *= 2
            self._caps[name] = cap
        return self._caps[name]

    def set_caps(self, caps: Dict[str, int]):
        """Start from given capacities (e.g. the JAX engine's, carried over
        by utils/from_jax.py); unknown names are ignored."""
        for k, v in caps.items():
            if k in ("w_pt", "w_ee", "w_et", "m_pt", "m_ee", "im_et") or k in self._blocks():
                self._caps[k] = int(v)

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

    def broad_count_keys(self):
        keys = []
        if self._pt_stems():
            keys += ["w_pt", "m_pt"]
        if self._ee_stems():
            keys += ["w_ee", "m_ee"]
        if self.isect_on() and len(self.edges_all) and len(self.tris_all):
            keys += ["w_et", "im_et"]
        return keys

    def pair_count_keys(self):
        keys = list(self._blocks())
        if self._pt_stems():
            keys.append("n_live_pt")
        if self._ee_stems():
            keys.append("n_live_ee")
        return keys

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

    def glob_entries(self):
        return {"contact_k": torch.as_tensor(self.model.contact_stiffness,
                                             dtype=self.dtype, device=self.device)}

    # ------------------------------------------------------------------
    # balls and compactions
    # ------------------------------------------------------------------
    def _tri_balls(self, Vcat):
        tq = self.d_tris_all.long()
        t0, t1, t2 = Vcat[tq[:, 0]], Vcat[tq[:, 1]], Vcat[tq[:, 2]]
        c = (t0 + t1 + t2) / 3.0
        r = torch.sqrt(torch.maximum(torch.maximum(
            torch.sum((t0 - c) ** 2, -1), torch.sum((t1 - c) ** 2, -1)),
            torch.sum((t2 - c) ** 2, -1)))
        return c, r

    def _edge_balls(self, Vcat):
        eq = self.d_edges_all.long()
        p0, p1 = Vcat[eq[:, 0]], Vcat[eq[:, 1]]
        return 0.5 * (p0 + p1), 0.5 * torch.linalg.norm(p1 - p0, dim=-1)

    def _bound_pad(self, Vcat):
        """Slop on the ball threshold covering the cancellation of the
        |a|^2 + |b|^2 - 2 a.b form at coordinate magnitude max|V|."""
        scale = 1.0 + torch.max(torch.abs(Vcat))
        return 8.0 * float(np.sqrt(torch.finfo(self.dtype).eps)) * scale

    def _ball_wide(self, key, A, ra, B, rb, allowed, extra):
        cap = self._cap(key)
        q, t, cnt = ball_wide(A, ra, B, rb, allowed, extra, cap)
        act = torch.arange(cap, device=q.device) < torch.clamp_max(cnt, cap)
        return (q, t, act), cnt

    @staticmethod
    def _refine(q, t, keep, cap, site):
        sel, cnt = compact(keep, cap, site)
        sl = sel.long()
        act = torch.arange(cap, device=q.device) < torch.clamp_max(cnt, cap)
        return (q[sl], t[sl], act), cnt

    # ------------------------------------------------------------------
    # routing into family pair tables
    # ------------------------------------------------------------------
    def _route_pt(self, q, t, valid, dhat_rows):
        out = {}
        ps = q < self.n_sv
        ts_ = t < self.n_ts
        masks = {"pt_dd": ps & ts_, "pt_dr": ps & ~ts_,
                 "pt_rd": ~ps & ts_, "pt_rr": ~ps & ~ts_}
        for stem in self._pt_stems():
            cap = self._cap(stem)
            sel, cnt = compact(valid & masks[stem], cap, "route_" + stem)
            sl = sel.long()
            active = torch.arange(cap, device=q.device) < torch.clamp_max(cnt, cap)
            # rows past the count (sel 0) may be of another kind: index 0
            p_loc = torch.where(active, q[sl].long() - (0 if stem[3] == "d" else self.n_sv), 0)
            t_loc = torch.where(active, t[sl].long() - (0 if stem[4] == "d" else self.n_ts), 0)
            out[stem] = (p_loc, t_loc, active, dhat_rows[sl], cnt)
        return out

    def _route_ee(self, a, b, valid, dhat_rows):
        out = {}
        as_ = a < self.n_es
        bs_ = b < self.n_es
        for stem in self._ee_stems():
            cap = self._cap(stem)
            if stem == "ee_dd":
                mask, aa, bb = as_ & bs_, a, b
            elif stem == "ee_rr":
                mask, aa, bb = ~as_ & ~bs_, a, b
            else:   # mixed rows: (rigid side, soft side)
                mask = as_ != bs_
                aa = torch.where(as_, b, a)
                bb = torch.where(as_, a, b)
            sel, cnt = compact(valid & mask, cap, "route_" + stem)
            sl = sel.long()
            active = torch.arange(cap, device=a.device) < torch.clamp_max(cnt, cap)
            a_loc = torch.where(active, aa[sl].long() - (0 if stem == "ee_dd" else self.n_es), 0)
            b_loc = torch.where(active, bb[sl].long() - (self.n_es if stem == "ee_rr" else 0), 0)
            out[stem] = (a_loc, b_loc, active, dhat_rows[sl], cnt)
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
            _d, keep = pt_distance(Vcat, Vcat, self.d_tris_all, q, t, act, None, bound)
            mcands["pt"], counts["m_pt"] = self._refine(q, t, keep, self._cap("m_pt"),
                                                        "refine_pt")
        if self._ee_stems():
            m, h = self._edge_balls(Vcat)
            (a, b, act), counts["w_ee"] = self._ball_wide(
                "w_ee", m, h + th_e, m, h + th_e, self.d_ee_allowed, margin + pad)
            bound = th_e[a.long()] + th_e[b.long()] + margin
            _d, keep = ee_distance(Vcat, self.d_edges_all, a, b,
                                   self.model.edge_edge_cross_norm_sq_cutoff, act, bound)
            mcands["ee"], counts["m_ee"] = self._refine(a, b, keep, self._cap("m_ee"),
                                                        "refine_ee")
        icands = {}
        if self.isect_on():
            icands, icounts = self._isect_stage1(Vcat, slack_b)
            counts.update(icounts)
        return mcands, icands, counts

    def pairs_fn(self, Vs, Vr, th, mcands, slack_p):
        """Pair shell: the 7 family pair tables from exact distances over the
        frozen mid lists (d <= dhat + slack_p), with the n_live_* metrics
        (d <= dhat)."""
        out, counts = {}, {}
        Vcat = self._vcat(Vs, Vr)
        if "pt" in mcands and self._pt_stems():
            q, t, act = mcands["pt"]
            dhat = th[self.d_p_mesh][q.long()] + th[self.d_t_mesh][t.long()]
            d, valid = pt_distance(Vcat, Vcat, self.d_tris_all, q, t, act, None,
                                   dhat + slack_p)
            counts["n_live_pt"] = torch.sum((act & (d <= dhat)).to(torch.int32))
            for stem, (p, tl, a2, dh, cnt) in self._route_pt(q, t, valid, dhat).items():
                out["contact_" + stem] = self._pt_family_data(stem, p, tl, a2, dh)
                counts[stem] = cnt
        if "ee" in mcands and self._ee_stems():
            a, b, act = mcands["ee"]
            the = th[self.d_e_mesh]
            dhat = the[a.long()] + the[b.long()]
            d, valid = ee_distance(Vcat, self.d_edges_all, a, b,
                                   self.model.edge_edge_cross_norm_sq_cutoff, act,
                                   dhat + slack_p)
            counts["n_live_ee"] = torch.sum((act & (d <= dhat)).to(torch.int32))
            for stem, (al, bl, a2, dh, cnt) in self._route_ee(a, b, valid, dhat).items():
                out["contact_" + stem] = self._ee_family_data(stem, al, bl, a2, dh)
                counts[stem] = cnt
        return out, counts

    # ------------------------------------------------------------------
    # intersection oracle
    # ------------------------------------------------------------------
    def _isect_stage1(self, Vcat, slack):
        """Edge-triangle candidates whose exact lower bound
        d(seg, tri) >= d(mid, tri) - h_e is within `slack`: a superset of
        every pair that can cross while the motion stays inside the broad
        budget. Overflow reports as a hit."""
        counts = {}
        if len(self.edges_all) == 0 or len(self.tris_all) == 0:
            return {}, counts
        m, h = self._edge_balls(Vcat)
        c, r = self._tri_balls(Vcat)
        (e, t, act), wcnt = self._ball_wide("w_et", m, h, c, r, self.d_et_allowed,
                                            slack + self._bound_pad(Vcat))
        counts["w_et"] = wcnt
        R = e.shape[0]
        _d, keep = pt_distance(m, Vcat, self.d_tris_all, e, t, act,
                               h[e.long()], slack.reshape(1).expand(R))
        cap = self._cap("im_et")
        (e, t, act), cnt = self._refine(e, t, keep, cap, "refine_et")
        counts["im_et"] = cnt
        overflow = (cnt > cap) | (wcnt > self._cap("w_et"))
        return {"et": (e, t, act, overflow)}, counts

    def isect_hit(self, Vs, Vr, icands):
        """0-d bool: does any frozen candidate intersect at (Vs, Vr)?"""
        if "et" not in icands:
            return torch.zeros((), dtype=torch.bool, device=self.device)
        e, t, act, overflow = icands["et"]
        return segment_triangle_any(self._vcat(Vs, Vr), self.d_edges_all,
                                    self.d_tris_all, e, t, act, overflow)

    def has_intersection(self, dt) -> bool:
        """Host verdict on the current state (the initial-state check)."""
        u = self.model.stark._connector["get_dofs"]()
        dt_t = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        while True:
            Vs, Vr = self.world_from_u(u, self.engine_state(), dt_t)
            zero = torch.zeros((), dtype=self.dtype, device=self.device)
            icands, counts = self._isect_stage1(self._vcat(Vs, Vr), zero)
            hit = self.isect_hit(Vs, Vr, icands)
            keys = sorted(counts)
            vals = torch.stack([counts[k] for k in keys]).cpu().numpy() if keys else []
            if not self._check_overflow(keys, vals):
                return bool(hit)
