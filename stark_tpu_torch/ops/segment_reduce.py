"""Kernel A: ordered segmented sum (csrc/segment_reduce.cu) and its twin;
its direct site, DirectLLT's dense matrix, as a write of its own.

Replaces the per-block reductions of stark_tpu/solver/assembly.py:
`_scatter_rows_payload` (:50-61, energy_grad_hess's (R, 9) payload),
`diag_bucket`'s segment_sum (:574-589) and `assemble_dense_scatter`'s
scatter-add keyed by block-pair id (:696-719). JAX's one-hot matmul scatter
is deterministic; CUDA's `index_add_` uses atomics and is not, so the port
sorts the row ids into a CSR (`build_csr`, without a host sync, once per
static topology and at every rebuild of the contact tables and the live
pool) and every launch sums each segment in CSR order.

DirectLLT's dense Hessian (stark_tpu/solver/newton.py `_direct_stage`,
:194-203) has n^2 block pairs, nearly all empty: a CSR over them and a
permute into the block-major layout would move far more than the matrix.
`sort_pairs` sorts only the R pair keys, and `dense_direct` zero-fills the
(3n, 3n) matrix and writes each run of equal keys straight into its 3x3
block, summed in the sorted order (JAX's scatter order).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import build


@dataclass(frozen=True)
class Csr:
    """Rows of a payload grouped by segment id, in stable sort order.

    perm (R,) int32: payload row indices, segment by segment; rows whose id
    is >= n_seg (or < 0) are dropped: they come last, past offsets[n_seg].
    offsets (n_seg+1,) int32: segment s is perm[offsets[s]:offsets[s+1]].
    seg (R,) int64: the segment of each perm entry, n_seg for a dropped row
    (used by the plain twin). n_rows: the payload row count R."""
    perm: torch.Tensor
    offsets: torch.Tensor
    seg: torch.Tensor
    n_seg: int
    n_rows: int


def build_csr(rows: torch.Tensor, n_seg: int) -> Csr:
    """CSR of a flat (R,) row-id vector over n_seg segments, built on the
    device without a host sync (the contact pair tables and the live pool
    change inside a solve): a stable sort of the ids, with the dropped rows
    keyed n_seg so that they sort past offsets[n_seg]."""
    rows = rows.reshape(-1).to(torch.int64)
    if rows.numel() >= 2**31 or n_seg >= 2**31:
        raise ValueError("segment_reduce: index range exceeds int32")
    key = torch.where((rows >= 0) & (rows < n_seg), rows,
                      torch.full_like(rows, n_seg))
    srt = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        srt.values, torch.arange(n_seg + 1, dtype=torch.int64, device=rows.device))
    return Csr(perm=srt.indices.to(torch.int32).contiguous(),
               offsets=offsets.to(torch.int32).contiguous(),
               seg=srt.values.contiguous(), n_seg=int(n_seg),
               n_rows=int(rows.numel()))


def segment_reduce_plain(payload: torch.Tensor, csr: Csr) -> torch.Tensor:
    """Plain PyTorch twin: the same sums, in the same order on the CPU
    (index_add_ over the sorted rows adds sequentially there). Dropped rows
    land in an extra segment that is cut off."""
    out = torch.zeros((csr.n_seg + 1, payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    return out.index_add_(0, csr.seg, payload[csr.perm.to(torch.int64)])[:csr.n_seg]


def segment_reduce(payload: torch.Tensor, csr: Csr, site: str) -> torch.Tensor:
    """(R, W) payload -> (n_seg, W) per-segment sums in CSR order. `site`
    names the call site for the launch count ("egh", "diag", "dense")."""
    if payload.dim() != 2 or payload.shape[0] != csr.n_rows:
        raise ValueError(f"segment_reduce: payload {tuple(payload.shape)} does "
                         f"not match the CSR's {csr.n_rows} rows")
    if payload.device.type == "cpu":
        return segment_reduce_plain(payload, csr)
    build.require_cuda("segment_reduce", payload, csr.perm, csr.offsets)
    fn = build.entry("stk_segment_reduce", payload.dtype)
    out = torch.empty((csr.n_seg, payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    rc = fn(payload.data_ptr(), payload.shape[1], csr.perm.data_ptr(),
            csr.offsets.data_ptr(), csr.n_seg, out.data_ptr(),
            build.stream_ptr(payload.device))
    build.check_status("segment_reduce", rc)
    build.count_launch(f"segment_reduce[{site}]")
    return out


@dataclass(frozen=True)
class PairSort:
    """The rows of an (R, 9) block-pair payload in a stable sort of their
    pair keys i * n + j (n blocks).

    perm (R,) int32: payload row indices in sorted order. key (R,) int32:
    the sorted keys, n * n for a dropped row (key >= n^2 or < 0), which
    sorts last. n: the block count; the matrix is (3n, 3n)."""
    perm: torch.Tensor
    key: torch.Tensor
    n: int


def sort_pairs(pids: torch.Tensor, n: int) -> PairSort:
    """PairSort of a flat (R,) pair-key vector over n blocks, on the device
    without a host sync."""
    pids = pids.reshape(-1).to(torch.int64)
    if pids.numel() >= 2**31 or n * n >= 2**31 - 1:
        raise ValueError("dense_direct: index range exceeds int32")
    key = torch.where((pids >= 0) & (pids < n * n), pids,
                      torch.full_like(pids, n * n)).to(torch.int32)
    srt = torch.sort(key, stable=True)
    return PairSort(perm=srt.indices.to(torch.int32).contiguous(),
                    key=srt.values.contiguous(), n=int(n))


def dense_direct_plain(payload: torch.Tensor, ps: PairSort) -> torch.Tensor:
    """Plain PyTorch twin: index_add_ of the sorted rows' 9 values at their
    scalar positions of the zero (3n, 3n) matrix, in sorted order (on the
    CPU index_add_ adds sequentially); dropped rows land in an extra entry
    that is cut off."""
    n, m = ps.n, 3 * ps.n
    key = ps.key.to(torch.int64)
    i, j = key // max(n, 1), key % max(n, 1)
    rc = torch.arange(3, device=key.device)
    idx = (3 * i[:, None, None] + rc[None, :, None]) * m + 3 * j[:, None, None] \
        + rc[None, None, :]
    idx = torch.where((key < n * n)[:, None, None], idx, torch.full_like(idx, m * m))
    out = torch.zeros(m * m + 1, dtype=payload.dtype, device=payload.device)
    out.index_add_(0, idx.reshape(-1), payload[ps.perm.to(torch.int64)].reshape(-1))
    return out[:m * m].view(m, m)


def dense_direct(payload: torch.Tensor, ps: PairSort) -> torch.Tensor:
    """(R, 9) block-pair payload -> the (3n, 3n) block-major matrix, each
    3x3 block the sum of its pair's rows in sorted order (kernel A's direct
    site)."""
    if payload.dim() != 2 or payload.shape[1] != 9 or payload.shape[0] != ps.perm.numel():
        raise ValueError(f"dense_direct: payload {tuple(payload.shape)} does not match "
                         f"the sort's {ps.perm.numel()} rows of 9")
    if payload.device.type == "cpu":
        return dense_direct_plain(payload, ps)
    payload = payload.contiguous()
    build.require_cuda("dense_direct", payload, ps.perm, ps.key)
    m = 3 * ps.n
    out = torch.empty((m, m), dtype=payload.dtype, device=payload.device)
    rc = build.entry("stk_direct_dense", payload.dtype)(
        payload.data_ptr(), ps.perm.data_ptr(), ps.key.data_ptr(), ps.perm.numel(), ps.n,
        out.data_ptr(), build.stream_ptr(payload.device))
    build.check_status("dense_direct", rc)
    build.count_launch("segment_reduce[direct]")
    return out
