"""Event-driven scripting: run_when / action / delete_when event list.

Reference: stark/src/core/EventDrivenScript.h:15-94 — events
with stateful EventInfo (call count, begin time) — plus the
`Simulation::add_time_event(t0, t1, f)` sugar (Simulation.cpp:39-50).
"""
from __future__ import annotations

from typing import Callable, List, Optional


class EventInfo:
    def __init__(self):
        self.n_calls = 0
        self.begin_time: Optional[float] = None

    def is_first_call(self) -> bool:
        return self.n_calls == 0


class _Event:
    def __init__(self, run_when, action, delete_when):
        self.run_when = run_when
        self.action = action
        self.delete_when = delete_when
        self.info = EventInfo()
        self.dead = False


class EventDrivenScript:
    def __init__(self):
        self._events: List[_Event] = []

    def add_event(self, run_when: Callable[[EventInfo], bool],
                  action: Callable[[EventInfo], None],
                  delete_when: Optional[Callable[[EventInfo], bool]] = None):
        self._events.append(_Event(run_when, action, delete_when))

    def run_a_cycle(self, t: float):
        for ev in self._events:
            if ev.dead:
                continue
            if ev.delete_when is not None and ev.delete_when(ev.info):
                ev.dead = True
                continue
            if ev.run_when(ev.info):
                if ev.info.begin_time is None:
                    ev.info.begin_time = t
                ev.action(ev.info)
                ev.info.n_calls += 1
        self._events = [e for e in self._events if not e.dead]
