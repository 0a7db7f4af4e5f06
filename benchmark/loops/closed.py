"""Closed loop: ``clients`` callers, each sending its next request when the
last one returned.

Phases: ``warm_seconds`` of ramp, then the measured window of ``seconds``,
then (traced runs only) ``trace_seconds`` under the profiler. A request
belongs to the phase in which it was sent; the window ends when the last
request sent inside it returns, so no request is cut in half.

One thread drives every client: it keeps ``clients`` requests out, and the
target tells it of each return (``submit(request, notify)``), so the load
adds no thread per client to the process it measures.
"""

from __future__ import annotations

import queue
import sys
import time

from benchmark.core import percentile
from benchmark.loops import GRACE_SECONDS, Record, Window


def drive(target, traffic, mix: dict, seconds: float, profiler=None) -> Window:
    clients = int(mix.get("clients", 1))
    t_ramp = time.perf_counter()
    t_win = t_ramp + float(mix.get("warm_seconds", 0.0))
    t_end = t_win + seconds
    t_stop = float("inf") if profiler else t_end  # traced: set once the profile runs
    records: list[Record] = []
    returned: queue.Queue = queue.Queue()
    marks: dict = {}
    t_trace = [None, None]
    out = 0

    def send(now: float) -> None:
        nonlocal out
        phase = "ramp" if now < t_win else "window" if now < t_end else "trace"
        rec = Record(traffic.next(), phase, now)
        records.append(rec)
        out += 1
        rec.handle = target.submit(rec.request, notify=returned.put)

    for _ in range(clients):
        send(time.perf_counter())
    while out:
        now = time.perf_counter()
        if "start" not in marks and now >= t_win:
            marks["start"] = (now, target.counters())
        if "end" not in marks and now >= t_end:
            marks["end"] = (now, target.counters())
            if profiler is not None:
                profiler.start()  # requests are out: a server's driver thread starts it
                t_trace[0] = time.perf_counter()
                t_stop = t_trace[0] + float(mix.get("trace_seconds", 0.0))
        if t_trace[0] is not None and t_trace[1] is None and now >= t_stop:
            profiler.stop()  # requests are still out: a server's driver thread stops it
            t_trace[1] = time.perf_counter()
        if now >= t_stop + GRACE_SECONDS:  # what never returns has failed
            break
        later = [t for t in (t_win, t_end, t_stop) if t > now]
        try:
            returned.get(timeout=max(1e-3, min(later) - now) if later else 1.0)
        except queue.Empty:
            continue
        out -= 1
        now = time.perf_counter()
        if now < t_stop:
            send(now)
    win = [r for r in records if r.phase == "window"]
    t1 = max((r.handle.t_done for r in win if r.handle.ok), default=t_end)
    return Window(records, t_win, t1, marks)


def report(window: Window, log) -> None:
    """The window's requests and their latencies, from sent to returned."""
    win = window.of("window")
    lat = [r.latency for r in win]
    if lat:
        log(f"window: {len(win)} requests over {window.t1 - window.t0:.3f} s; latency ms: "
            + ", ".join(f"p{q} {1e3 * percentile(lat, q):.1f}" for q in (50, 95, 100)),
            file=sys.stderr)
