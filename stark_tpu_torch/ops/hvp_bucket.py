"""Kernel B: the CG Hessian-vector product (csrc/hvp_bucket.cu) and its twin.

Replaces stark_tpu/solver/assembly.py `hvp_bucket` (:559-572) and its
one-hot `_scatter_q` (:514-522): q = sum_e H_e p[conn_e], summed per block,
over the single-bucket (E, 3b, 3b) layout. The CSR groups the flat entries
(e, a) of conn_cat by block (dummy entries dropped); it is the same CSR as
`diag_bucket`'s and is built once per topology. The staged solver launches
it once per arity group (stark_tpu assembly.py `hvp_ctx`, :186-196).
"""
from __future__ import annotations

import torch

from . import build
from .segment_reduce import Csr, segment_reduce_plain


def hvp_bucket_plain(p: torch.Tensor, conn: torch.Tensor, H: torch.Tensor,
                     csr: Csr) -> torch.Tensor:
    """Plain PyTorch twin: gather p (with the zero dummy row), batched
    element matvec, ordered per-block sum."""
    E, b = conn.shape
    p_pad = torch.cat([p, torch.zeros((1, 3), dtype=p.dtype, device=p.device)])
    p_e = p_pad[conn.to(torch.int64)].reshape(E, 3 * b)
    q_e = torch.einsum("eij,ej->ei", H, p_e)
    return segment_reduce_plain(q_e.reshape(-1, 3), csr)


def hvp_bucket(p: torch.Tensor, conn: torch.Tensor, H: torch.Tensor,
               csr: Csr, site: str = None) -> torch.Tensor:
    """q = H p. p (n_blocks, 3); conn (E, b) int32 with dummy id n_blocks;
    H (E, 3b, 3b); csr over conn.reshape(-1) with n_seg = n_blocks. `site`
    names a launch site other than the fused solve's for the launch count
    ("staged": hvp_bucket[staged], one launch per arity group)."""
    n_blocks = p.shape[0]
    E, b = conn.shape
    if H.shape != (E, 3 * b, 3 * b) or p.shape != (n_blocks, 3) \
            or csr.n_seg != n_blocks or csr.n_rows != E * b:
        raise ValueError("hvp_bucket: inconsistent shapes")
    if p.device.type == "cpu":
        return hvp_bucket_plain(p, conn, H, csr)
    build.require_cuda("hvp_bucket", p, conn, H, csr.perm, csr.offsets)
    if conn.dtype != torch.int32 or H.dtype != p.dtype:
        raise TypeError("hvp_bucket: conn must be int32 and H match p's dtype")
    fn = build.entry("stk_hvp_bucket", p.dtype)
    q = torch.empty_like(p)
    rc = fn(H.data_ptr(), conn.data_ptr(), b, p.data_ptr(), n_blocks,
            csr.perm.data_ptr(), csr.offsets.data_ptr(), q.data_ptr(),
            build.stream_ptr(p.device))
    build.check_status("hvp_bucket", rc)
    build.count_launch("hvp_bucket" if site is None else f"hvp_bucket[{site}]")
    return q
