"""The program's own spans in a traced run: the ``asr.*`` stage spans the
port opens while a profile records (``runtime/profiling.annotate``), Kineto
``user_annotation`` events on the clock of the trace's kernels and copies,
and the card's idle time inside them."""

from __future__ import annotations

import bisect


def spans(run, name: str) -> list[tuple[float, float]]:
    """(start, end) in µs of the trace's host events named exactly ``name``."""
    if run.trace is None:
        return []
    return [(a, b) for a, b, n in run.trace.host if n == name]


def idle_us(run, intervals) -> float:
    """Σ over ``intervals`` of each one's length less the union of the
    device events (kernels, copies, memsets, as ``idle_share`` counts them)
    clipped to it."""
    busy: list[list[float]] = []  # the union of the device events, disjoint and in order
    for a, b, _, _ in run.trace.device:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    ends = [b for _, b in busy]
    idle = 0.0
    for a, b in intervals:
        idle += b - a
        i = bisect.bisect_right(ends, a)  # the first busy stretch that ends after a
        while i < len(busy) and busy[i][0] < b:
            idle -= min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
    return idle
