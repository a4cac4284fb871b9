"""The fused solve as one device program (K12): its control flow, its input
binder and its capture cache.

stark_tpu compiles a time step's Newton solve into one `lax.while_loop`
(stark_tpu/solver/fused.py:593) with `lax.cond`s and nested loops inside.
The port writes that program once, in solver/fused.py and solver/pcg.py,
over a `Control`:

  * `ctl.while_(pred_fn, body)` runs body while pred_fn() holds, testing it
    before the first body as lax.while_loop does; `ctl.if_(pred, fn)` runs
    fn when pred holds. Predicates are 0-d device bool tensors; bodies
    write their results into buffers allocated outside them (`copy_`,
    in-place updates), or bind tensors that nothing outside reads before
    the body has run, so that a captured body replays at fixed addresses.
  * `EagerControl` runs them as Python loops on host reads (the plain
    version of kernel X: the CPU path, and the eager driver on the card).
    Its reads are the driver's, not the program's; `strict` makes any
    `Evaluators.to_host` inside a body raise.
  * `GraphControl` adds kernel X's conditional nodes (ops/graph_ctl.py)
    while a CUDA graph is captured: WHILE for the loops, IF for the
    conditionals, each body captured on a stream of its nesting depth into
    a memory pool of its own, kept with the graph.
  * `WarmControl` runs every body once on the streams the capture will use,
    before the capture: lazily built device tables and cuBLAS's per-stream
    workspaces then exist when the capture starts (a cold cuBLAS handle
    inside a capture crashes the process).

`Program` binds a program to its inputs: every tensor of the arguments is
copied into a static buffer before each run, every other leaf is part of
the capture key. On CUDA it warms up, captures once and replays; on the
CPU, and on the card when the caller asks for the eager driver, it runs the
same program under EagerControl on the same buffers, so that a CPU test
catches an input the binder misses. A failed capture raises with its
cause: there is no fallback to the eager driver.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import torch

from ..ops import graph_ctl


class Control:
    """lax.while_loop and lax.cond over 0-d device bool predicates."""

    def while_(self, pred_fn: Callable, body: Callable):
        raise NotImplementedError

    def if_(self, pred: torch.Tensor, fn: Callable):
        raise NotImplementedError


class EagerControl(Control):
    """Python while and if on host reads. `read(pred) -> bool` reads a
    predicate (by default `.item()`, counted in `reads`); `strict_ev`, an
    Evaluators, makes its `to_host` raise while a body runs."""

    def __init__(self, read: Callable = None, strict_ev=None):
        self.reads = 0
        self._read = read
        self._strict_ev = strict_ev

    def test(self, pred: torch.Tensor) -> bool:
        if self._read is not None:
            return bool(self._read(pred))
        self.reads += 1
        return bool(pred.item())

    def _run(self, fn):
        ev = self._strict_ev
        if ev is not None:
            ev.forbid_reads += 1
        try:
            fn()
        finally:
            if ev is not None:
                ev.forbid_reads -= 1

    def while_(self, pred_fn, body):
        while self.test(pred_fn()):
            self._run(body)

    def if_(self, pred, fn):
        if self.test(pred):
            self._run(fn)


class _Streams:
    """One stream per nesting depth: depth 0 captures the program, depth d
    the bodies nested d deep."""

    def __init__(self, device):
        self.device = device
        self._streams: List[torch.cuda.Stream] = []

    def __getitem__(self, d: int) -> torch.cuda.Stream:
        while len(self._streams) <= d:
            self._streams.append(torch.cuda.Stream(self.device))
        return self._streams[d]


class WarmControl(Control):
    """Every body once, on the stream of its depth, whatever its predicate:
    the warm-up that precedes a capture (values are thrown away)."""

    def __init__(self, streams: _Streams):
        self.streams = streams
        self.depth = 0

    def _run(self, body):
        cur = self.streams[self.depth]
        side = self.streams[self.depth + 1]
        side.wait_stream(cur)
        self.depth += 1
        try:
            with torch.cuda.stream(side):
                body()
        finally:
            self.depth -= 1
        cur.wait_stream(side)

    def while_(self, pred_fn, body):
        pred_fn()
        self._run(lambda: (body(), pred_fn()))

    def if_(self, pred, fn):
        self._run(fn)


class GraphControl(Control):
    """Kernel X's WHILE and IF nodes, added while a CUDA graph captures on
    streams[0]. Each body's allocations go to a memory pool of its own
    (PyTorch refuses a second route into the graph's pool), kept in
    `pools` for as long as the graph lives."""

    def __init__(self, streams: _Streams):
        self.streams = streams
        self.depth = 0
        self.pools = []

    def _node(self, kind, pred, body):
        pred = pred.reshape(())
        cur = self.streams[self.depth]
        side = self.streams[self.depth + 1]
        dev = torch.cuda.current_device()
        handle = graph_ctl.begin_body(cur, side, kind, pred)
        pool = torch.cuda.graph_pool_handle()
        self.pools.append(pool)
        self.depth += 1
        try:
            with torch.cuda.stream(side):
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
                try:
                    nxt = body()
                    if kind == graph_ctl.WHILE:
                        graph_ctl.set_cond(handle, nxt.reshape(()), side)
                finally:
                    torch._C._cuda_endAllocateToPool(dev, pool)
                    rc = graph_ctl.end_body(side)
        finally:
            self.depth -= 1
        if rc != 0:
            raise RuntimeError(f"graph_ctl: ending a body's capture failed ({rc})")

    def while_(self, pred_fn, body):
        self._node(graph_ctl.WHILE, pred_fn(), lambda: (body(), pred_fn())[1])

    def if_(self, pred, fn):
        self._node(graph_ctl.IF, pred, fn)


# ---------------------------------------------------------------------------
# the input binder
# ---------------------------------------------------------------------------
def flatten(tree):
    """(tensor leaves, spec): spec is hashable and holds the structure, each
    tensor's shape, dtype and device and every other leaf's value."""
    leaves = []

    def go(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T", tuple(x.shape), x.dtype, str(x.device))
        if isinstance(x, dict):
            return ("D", tuple(x.keys()), tuple(go(v) for v in x.values()))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("N", type(x), tuple(go(v) for v in x))
        if isinstance(x, (list, tuple)):
            return ("L" if isinstance(x, list) else "U", tuple(go(v) for v in x))
        if dataclasses.is_dataclass(x):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("C", type(x), names, tuple(go(getattr(x, n)) for n in names))
        hash(x)
        return ("V", x)

    return leaves, go(tree)


def unflatten(spec, leaves):
    it = iter(leaves)

    def go(s):
        tag = s[0]
        if tag == "T":
            return next(it)
        if tag == "D":
            return dict(zip(s[1], (go(c) for c in s[2])))
        if tag == "N":
            return s[1](*(go(c) for c in s[2]))
        if tag == "L":
            return [go(c) for c in s[1]]
        if tag == "U":
            return tuple(go(c) for c in s[1])
        if tag == "C":
            return s[1](**dict(zip(s[2], (go(c) for c in s[3]))))
        return s[1]

    return go(spec)


class Program:
    """A program bound to static input buffers for one key. `fn(*args,
    ctl=...)` is the program; `graph` captures it (CUDA), else it runs under
    EagerControl on every call. `driver_reads` counts the eager driver's
    host reads; `capture_seconds` the warm-up and capture."""

    def __init__(self, fn: Callable, args: tuple, graph: bool, strict_ev=None):
        self.fn = fn
        leaves, self.spec = flatten(args)
        self.inputs = [t.detach().clone() for t in leaves]
        self.graph = None
        self.outputs = None
        self.driver_reads = 0
        self.capture_seconds = 0.0
        self._strict_ev = strict_ev
        self._pools = []
        if graph:
            self._capture()

    def _args(self):
        return unflatten(self.spec, self.inputs)

    def _capture(self):
        t0 = time.perf_counter()
        device = self.inputs[0].device
        streams = _Streams(device)
        s0 = streams[0]
        s0.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s0):
            self.fn(*self._args(), ctl=WarmControl(streams))
        torch.cuda.current_stream(device).wait_stream(s0)
        torch.cuda.synchronize(device)
        g = torch.cuda.CUDAGraph()
        ctl = GraphControl(streams)
        try:
            # torch.cuda.graph's context would also empty the allocator's
            # cache at every capture; the warm-up has synchronized
            with torch.cuda.stream(s0):
                g.capture_begin()
                try:
                    self.outputs = self.fn(*self._args(), ctl=ctl)
                finally:
                    g.capture_end()
        except Exception as e:
            raise RuntimeError(
                "fused solve: capturing the CUDA graph failed "
                f"({type(e).__name__}: {e})") from e
        finally:
            # the bodies' pools (the graph's own goes with graph.reset())
            self._pools = ctl.pools
        self.graph = g
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0

    def bind(self, args: tuple):
        leaves, spec = flatten(args)
        if spec != self.spec:
            raise ValueError("Program: the arguments do not match the bound key")
        if leaves:
            torch._foreach_copy_(self.inputs, leaves)

    def __call__(self, args: tuple):
        """Copy args into the buffers and run; returns the program's
        outputs (a graph's own buffers, which the next run overwrites)."""
        self.bind(args)
        if self.graph is not None:
            self.graph.replay()
            return self.outputs
        ctl = EagerControl(strict_ev=self._strict_ev)
        out = self.fn(*self._args(), ctl=ctl)
        self.driver_reads += ctl.reads
        return out

    def __del__(self):
        # the bodies' pools outlive a dropped graph unless released
        try:
            self.release()
        except Exception:
            pass

    def release(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        self.outputs = None
        if self._pools:
            torch.cuda.synchronize()
            dev = torch.cuda.current_device()
            for pool in self._pools:
                torch._C._cuda_releasePool(dev, pool)
            self._pools = []
