"""Kernel X: CUDA-graph conditional nodes for the fused solve's loop
control (csrc/graph_ctl.cu).

Replaces the control flow of stark_tpu/solver/fused.py (the Newton
`lax.while_loop` at :593, the `lax.cond`s at :291, :304, :313, :408, the
[inv] and [bt] loops at :479, :516) and of stark_tpu/solver/pcg.py:99.
While a stream captures, `begin_body` adds a WHILE or IF node to the
capturing graph (its first value from a 0-d device bool, through the
setter kernel) and starts capturing `body_stream` into the node's body;
`end_body` ends that capture; `set_cond` launches the setter inside a WHILE
body, for the next test. `solver/program.py` drives these (GraphControl);
its EagerControl, Python loops on host reads, is the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

IF, WHILE = 0, 1


def _pred_ptr(pred: torch.Tensor) -> int:
    if pred.dtype != torch.bool or pred.numel() != 1 or pred.device.type != "cuda":
        raise ValueError("graph_ctl: the predicate must be a 0-d CUDA bool tensor")
    return pred.data_ptr()


def begin_body(stream: torch.cuda.Stream, body_stream: torch.cuda.Stream,
               kind: int, pred: torch.Tensor) -> int:
    """Add a conditional node (IF or WHILE) after `stream`'s capture
    dependencies, with pred as its first value, and begin capturing
    body_stream into its body. Returns the node's handle."""
    handle = ctypes.c_ulonglong(0)
    rc = build.entry("stk_graph_begin_body")(
        stream.cuda_stream, body_stream.cuda_stream, int(kind), _pred_ptr(pred),
        ctypes.byref(handle))
    build.check_status("graph_ctl.begin_body", rc)
    build.count_launch("graph_ctl")
    return handle.value


def set_cond(handle: int, pred: torch.Tensor, stream: torch.cuda.Stream):
    """Set a node's handle from a 0-d device bool (a WHILE body's last
    launch: the next test)."""
    rc = build.entry("stk_graph_set_cond")(handle, _pred_ptr(pred), stream.cuda_stream)
    build.check_status("graph_ctl.set_cond", rc)
    build.count_launch("graph_ctl")


def end_body(body_stream: torch.cuda.Stream) -> int:
    """End the capture of a node's body; returns the CUDA status."""
    return build.entry("stk_graph_end_body")(body_stream.cuda_stream)
