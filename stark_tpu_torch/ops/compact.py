"""Kernel E: stream compaction (csrc/compact.cu) and its twin.

Replaces stark_tpu/ops/compaction.py `compact_indices` (:59-119): the
indices of the set entries of a flat mask, ascending, in a (cap,) int32
buffer padded with 0, and the TOTAL count (it may exceed cap; the caller's
overflow check reads it). The count stays on the device: the wrapper never
reads it, so a compaction adds no host sync.
"""
from __future__ import annotations

import torch

from . import build

_CHUNK = 2048   # mask entries per block of csrc/compact.cu


def compact_plain(mask: torch.Tensor, cap: int):
    """Plain PyTorch twin (torch.nonzero): the same buffer and count."""
    nz = torch.nonzero(mask.reshape(-1)).reshape(-1)
    k = min(nz.numel(), cap)
    idx = torch.zeros((cap,), dtype=torch.int32, device=mask.device)
    idx[:k] = nz[:k].to(torch.int32)
    return idx, torch.tensor(nz.numel(), dtype=torch.int32, device=mask.device)


def compact(mask: torch.Tensor, cap: int, site: str):
    """(idx (cap,) int32, count () int32) of a flat bool/uint8 mask. `site`
    names the call site for the launch count."""
    mask = mask.reshape(-1)
    if mask.device.type == "cpu":
        return compact_plain(mask, cap)
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError("compact: the mask must be bool or uint8")
    mask = mask.contiguous()
    build.require_cuda("compact", mask)
    n = mask.numel()
    if n >= 2**31:
        raise ValueError("compact: the mask exceeds the int32 index range")
    idx = torch.empty((cap,), dtype=torch.int32, device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    scratch = torch.empty((2 * max(1, -(-n // _CHUNK)),), dtype=torch.int32,
                          device=mask.device)
    rc = build.entry("stk_compact")(mask.data_ptr(), n, cap, idx.data_ptr(),
                                    count.data_ptr(), scratch.data_ptr(),
                                    build.stream_ptr(mask.device))
    build.check_status("compact", rc)
    build.count_launch(f"compact[{site}]")
    return idx, count
