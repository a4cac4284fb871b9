"""Timers and the card line shared by the on-card scripts (`chip_smoke.py`,
`tools/profile_stages.py`)."""
from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() launched from the host, CUDA events around
    the launches: for work that cannot be captured in a CUDA graph, or whose
    host cost is part of what is measured."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of fn(): `iters` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events, so the host's
    launch rate does not enter the time of a short kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (iters * replays)
