"""Kernel B: the CG Hessian-vector product (csrc/hvp_bucket.cu) and its twin.

Replaces stark_tpu/solver/assembly.py `hvp_bucket` (:559-572) and its
one-hot `_scatter_q` (:514-522), and `hvp_ctx` (:186-196): q = sum_e H_e
p[conn_e], summed per block, over groups of (E, 3b, 3b) element Hessians.
Each group's CSR groups its flat entries (e, a) by block (dummy entries
dropped); it is the same CSR as `diag_bucket`'s. One launch takes every
group of a product: the fused solve's static bucket and live pool, or the
staged solver's arity groups; the groups' partial products are added in
the order given, as the twin adds them. Past MAX_GROUPS groups (user
families of many arities) the product takes one launch per MAX_GROUPS,
each adding its groups to the q of the launch before.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .segment_reduce import Csr, segment_reduce_plain

MAX_GROUPS = 8


def hvp_bucket_plain(p: torch.Tensor, conn: torch.Tensor, H: torch.Tensor,
                     csr: Csr) -> torch.Tensor:
    """Plain PyTorch twin of one group: gather p (with the zero dummy row),
    batched element matvec, ordered per-block sum."""
    E, b = conn.shape
    p_pad = torch.cat([p, torch.zeros((1, 3), dtype=p.dtype, device=p.device)])
    p_e = p_pad[conn.to(torch.int64)].reshape(E, 3 * b)
    q_e = torch.einsum("eij,ej->ei", H, p_e)
    return segment_reduce_plain(q_e.reshape(-1, 3), csr)


def hvp_groups_plain(p: torch.Tensor, groups) -> torch.Tensor:
    """The twin over groups [(conn, H, csr), ...]: each group's product,
    added in the groups' order."""
    q = None
    for conn, H, csr in groups:
        qa = hvp_bucket_plain(p, conn, H, csr)
        q = qa if q is None else q + qa
    return q


def hvp_groups(p: torch.Tensor, groups, site: str = None) -> torch.Tensor:
    """q = H p over groups [(conn, H, csr), ...], one launch per MAX_GROUPS
    groups. p (n_blocks, 3); conn (E, b) int32 with dummy id n_blocks; H
    (E, 3b, 3b); csr over conn.reshape(-1) with n_seg = n_blocks. `site`
    names a launch site other than the fused solve's for the launch count
    ("staged": hvp_bucket[staged])."""
    n_blocks = p.shape[0]
    if not groups:
        raise ValueError("hvp_bucket: no groups")
    for conn, H, csr in groups:
        E, b = conn.shape
        if H.shape != (E, 3 * b, 3 * b) or p.shape != (n_blocks, 3) \
                or csr.n_seg != n_blocks or csr.n_rows != E * b:
            raise ValueError("hvp_bucket: inconsistent shapes")
    if p.device.type == "cpu":
        return hvp_groups_plain(p, groups)
    for conn, H, csr in groups:
        build.require_cuda("hvp_bucket", p, conn, H, csr.perm, csr.offsets)
        if conn.dtype != torch.int32 or H.dtype != p.dtype:
            raise TypeError("hvp_bucket: conn must be int32 and H match p's dtype")
    fn = build.entry("stk_hvp_bucket", p.dtype)
    q = None
    for i in range(0, len(groups), MAX_GROUPS):
        chunk = groups[i:i + MAX_GROUPS]
        n = len(chunk)
        ptrs = ctypes.c_void_p * n
        q_in, q = q, torch.empty_like(p)
        rc = fn(ptrs(*[H.data_ptr() for _c, H, _s in chunk]),
                ptrs(*[c.data_ptr() for c, _H, _s in chunk]),
                (ctypes.c_int * n)(*[c.shape[1] for c, _H, _s in chunk]),
                ptrs(*[s.perm.data_ptr() for _c, _H, s in chunk]),
                ptrs(*[s.offsets.data_ptr() for _c, _H, s in chunk]),
                n, p.data_ptr(), n_blocks, None if q_in is None else q_in.data_ptr(),
                q.data_ptr(), build.stream_ptr(p.device))
        build.check_status("hvp_bucket", rc)
        build.count_launch("hvp_bucket" if site is None else f"hvp_bucket[{site}]")
    return q


def hvp_bucket(p: torch.Tensor, conn: torch.Tensor, H: torch.Tensor,
               csr: Csr, site: str = None) -> torch.Tensor:
    """q = H p over one group (hvp_groups)."""
    return hvp_groups(p, [(conn, H, csr)], site)
