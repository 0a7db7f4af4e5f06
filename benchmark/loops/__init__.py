"""Load drivers, one module per ``loop`` a traffic mix names. Each has
``drive(target, traffic, mix, seconds, profiler) -> Window`` and may have
``report(window, log)``, which prints what the driver saw (latencies, how
late it ran) on earlier lines of standard error."""

from __future__ import annotations

import dataclasses
import time

GRACE_SECONDS = 60.0  # how long past its close a run waits for what it sent


@dataclasses.dataclass
class Record:
    request: object          # traffic.Request
    phase: str               # "ramp", "window" or "trace"
    t_start: float           # closed loop: sent; open loop: due
    handle: object = None    # the target's handle: .wait(timeout), .ok, .t_done, .out
    lateness: float = 0.0    # open loop: how late the generator sent it

    @property
    def latency(self) -> float:
        h = self.handle
        return h.t_done - self.t_start if h is not None and h.ok else float("inf")


@dataclasses.dataclass
class Window:
    records: list
    t0: float                # the measured window's start
    t1: float                # and its end
    marks: dict | None = None  # "start" / "end": (time, the target's counters)

    def of(self, phase: str) -> list[Record]:
        return [r for r in self.records if r.phase == phase]


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))
