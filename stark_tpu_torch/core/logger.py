"""Structured run telemetry: scoped timers, series, accumulators -> YAML.

Reference: stark/extern/symx/src/solver/Logger.h:10-137 (typed
series + accumulators + RAII timers persisted as YAML, auto-flushed every 10 s
from Stark.cpp:205-207) and OutputSink.h:8-60 (verbosity-tiered console+file
sink). The same counters are produced so the per-step console line and the
end-of-run runtime table match the reference's format.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

from .settings import Verbosity


@dataclass
class SeriesStats:
    total: float = 0.0
    avg: float = 0.0
    min: float = 0.0
    max: float = 0.0
    n: int = 0


class Logger:
    def __init__(self, path: str | None = None):
        self.path = path
        self.series: dict[str, list[float]] = defaultdict(list)
        self.values: dict[str, float] = {}
        self.accumulators: dict[str, float] = defaultdict(float)
        self.timers: dict[str, float] = defaultdict(float)
        self._last_write = time.perf_counter()

    # -- timers (Logger.h time()) --
    @contextmanager
    def time(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[label] += time.perf_counter() - t0

    # -- series / accumulators --
    def append(self, key: str, value: float):
        self.series[key].append(float(value))

    def add(self, key: str, value: float):
        self.accumulators[key] += value

    def add_and_append(self, key: str, value: float):
        self.append(key, value)

    def set(self, key: str, value):
        self.values[key] = value

    def get_int(self, key: str) -> int:
        return int(self.accumulators.get(key, 0))

    def get_stats(self, key: str) -> SeriesStats:
        s = self.series.get(key, [])
        if not s:
            return SeriesStats()
        return SeriesStats(total=sum(s), avg=sum(s) / len(s), min=min(s), max=max(s), n=len(s))

    def get_timer_labels(self):
        return list(self.timers.keys())

    def get_timer_total(self, label: str) -> float:
        return self.timers.get(label, 0.0)

    def time_since_last_write(self) -> float:
        return time.perf_counter() - self._last_write

    def save_to_disk(self):
        if not self.path:
            return
        self._last_write = time.perf_counter()
        lines = ["# stark_tpu_torch run log"]
        lines.append("values:")
        for k, v in self.values.items():
            lines.append(f"  {k}: {v}")
        lines.append("accumulators:")
        for k, v in self.accumulators.items():
            lines.append(f"  {k}: {v}")
        lines.append("timers:")
        for k, v in self.timers.items():
            lines.append(f"  {k}: {v}")
        lines.append("series:")
        for k, s in self.series.items():
            lines.append(f"  {k}: [{', '.join(f'{x:.6g}' for x in s)}]")
        try:
            with open(self.path, "w") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            pass


class OutputSink:
    """Verbosity-tiered console + file printer (reference OutputSink.h:8-60)."""

    def __init__(self, console_verbosity=Verbosity.Summary, file_verbosity=Verbosity.Full,
                 enabled=True, file_path: str | None = None):
        self.console_verbosity = console_verbosity
        self.file_verbosity = file_verbosity
        self.enabled = enabled
        self._file = None
        if file_path:
            try:
                self._file = open(file_path, "w")
            except OSError:
                self._file = None

    def print(self, msg: str, verbosity: Verbosity = Verbosity.Minimal):
        if not self.enabled:
            return
        if verbosity.value <= self.console_verbosity.value:
            print(msg, end="", flush=True)
        if self._file is not None and verbosity.value <= self.file_verbosity.value:
            self._file.write(msg)

    def print_with_new_line(self, msg: str, verbosity: Verbosity = Verbosity.Minimal):
        self.print("\n" + msg, verbosity)

    def print_new_line(self, verbosity: Verbosity = Verbosity.Minimal):
        self.print("\n", verbosity)

    def get_console_verbosity(self):
        return self.console_verbosity

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
