"""Kernel A: ordered segmented sum (csrc/segment_reduce.cu) and its twin.

Replaces the per-block reductions of stark_tpu/solver/assembly.py:
`_scatter_rows_payload` (:50-61, energy_grad_hess's (R, 9) payload),
`diag_bucket`'s segment_sum (:574-589) and `assemble_dense_scatter`'s
scatter-add keyed by block-pair id (:696-719). JAX's one-hot matmul scatter
is deterministic; CUDA's `index_add_` uses atomics and is not, so the port
sorts the row ids into a CSR (`build_csr`, without a host sync, once per
static topology and at every rebuild of the contact tables and the live
pool) and every launch sums each segment in CSR order.
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
