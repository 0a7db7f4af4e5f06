"""The traced sub-window: a ``torch.profiler`` trace written to the run's
temporary directory, read once into device events and the benchmark's own
spans, then deleted.

Spans are ``record_function`` ranges named ``bench.<name>`` that the
benchmark opens around the program's entries; :class:`Spans` also keeps,
for every span, what the benchmark knew of its work (shapes, counter
deltas), so a reader can set the kernels inside a span against the work the
span asked for.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import tempfile
import threading
import time
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


class Spans:
    """Benchmark-side spans: host times (perf_counter) and their work,
    kept in memory; ``active`` is True while the profiler runs."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.records: list[dict] = []
        self.profiler = None  # polled at each span's edges (see Profiler)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, sync=None, **info):
        """Record one span; ``sync`` (a callable) runs at its start and end,
        so that the device work it launched ends inside it."""
        if not self.enabled:
            yield info
            return
        import torch

        if self.profiler is not None:
            self.profiler.poll()
        if sync is not None:
            sync()
        with self._lock:
            seq = len(self.records)
            rec = {"name": name, "seq": seq, "traced": self.active, "t0": time.perf_counter(), **info}
            self.records.append(rec)
        with torch.profiler.record_function(f"bench.{name}#{seq}"):
            yield rec
            if sync is not None:
                sync()
        rec["t1"] = time.perf_counter()
        if self.profiler is not None:
            self.profiler.poll()

    def of(self, name: str, traced: bool | None = None) -> list[dict]:
        """Finished spans named ``name`` (those opened while the profiler
        ran, or not, where ``traced`` says)."""
        return [r for r in self.records if r["name"] == name and "t1" in r
                and (traced is None or r["traced"] == traced)]


class Trace:
    """Device events and ``bench.*`` annotations of one profiler trace."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"])
                              for e in xs if e.get("cat") in DEVICE_CATEGORIES))
        self.host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                     if e.get("cat") in HOST_CATEGORIES]
        self.spans = {}  # span seq -> (start, end)
        for e in xs:
            if e.get("cat") == "user_annotation" and e["name"].startswith("bench."):
                _, _, seq = e["name"].partition("#")
                if seq.isdigit():
                    self.spans[int(seq)] = (e["ts"], e["ts"] + e["dur"])
        ts = [e["ts"] for e in xs] + [e["ts"] + e["dur"] for e in xs]
        self.t0, self.t1 = (min(ts), max(ts)) if ts else (0.0, 0.0)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @staticmethod
    def union(intervals) -> float:
        """Length of the union of (start, end) intervals."""
        total, end = 0.0, float("-inf")
        for a, b in sorted(intervals):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    def busy_us(self) -> float:
        return self.union((a, b) for a, b, _, _ in self.device)

    def kernels(self, pattern: str, within: list[tuple[float, float]] | None = None):
        """Kernel events whose name matches ``pattern``, those starting
        inside one of ``within``'s intervals where given."""
        rx = re.compile(pattern)
        out = [(a, b, n) for a, b, n, c in self.device if c == "kernel" and rx.search(n)]
        if within is None:
            return out
        iv = sorted(within)
        keep = []
        j = 0
        for a, b, n in out:
            while j < len(iv) and iv[j][1] < a:
                j += 1
            if j < len(iv) and iv[j][0] <= a <= iv[j][1]:
                keep.append((a, b, n))
        return keep

    def matched(self, records: list[dict]) -> list[tuple[dict, tuple[float, float]]]:
        """The span records that this trace holds, each with its interval."""
        return [(r, self.spans[r["seq"]]) for r in records if r["seq"] in self.spans]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [short name, seconds]."""
        tot: dict[str, float] = {}
        for a, b, n, _ in self.device:
            key = short_name(n)
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, shortest_us: float = 2.0) -> list[list]:
        """Idle stretches of the device of ``shortest_us`` or more, by what
        the host was doing in them (the innermost host event over each
        gap's middle)."""
        gaps, end = [], None
        for a, b, _, _ in self.device:
            if end is not None and a - end >= shortest_us:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted(self.host, key=lambda h: h[0])
        starts = [h[0] for h in host]
        import bisect

        tot: dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            best = None
            for h in host[max(0, i - 200) : i]:
                if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            key = short_name(best[2]) if best else "(host, no traced op)"
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's or op's name without its return type, templates,
    arguments and anonymous namespaces, at most 80 characters."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void ", "", n)
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def all_threads():
    """Kineto's option to record every thread's activity, not only the
    thread that starts the profile (the loops' clients and the server's
    driver thread launch the work)."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


class Profiler:
    """Start and stop a profile of CPU and CUDA activity; :meth:`read`
    exports it into a fresh temporary directory (under the ``TMPDIR`` the
    run was given), parses it and deletes it.

    The profile is started and stopped by the thread that launches the
    device work: with ``in_worker`` (a server whose driver thread launches
    it) :meth:`start` and :meth:`stop` only ask, and the worker does it at
    its next span edge (:meth:`poll`); a profile started from another
    thread than the launching one was seen to record no kernel."""

    WAIT_SECONDS = 60.0

    def __init__(self, spans: Spans, in_worker: bool = False):
        self.spans = spans
        self.in_worker = in_worker
        self.prof = None
        self._want = None
        self._done = threading.Event()
        spans.profiler = self if in_worker else None

    def warm(self) -> None:
        """One short profile in set-up: the profiler's first start (CUPTI's
        initialisation) takes seconds, which the traced window must not."""
        import torch

        self._start()
        torch.ones(1, device="cuda").add_(1)
        self._stop()
        self.prof = None

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            experimental_config=all_threads())
        self.prof.__enter__()
        self.spans.active = True

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.spans.active = False
        self.prof.__exit__(None, None, None)

    def _ask(self, what: str) -> None:
        if not self.in_worker:
            (self._start if what == "start" else self._stop)()
            return
        self._done.clear()
        self._want = what
        if not self._done.wait(self.WAIT_SECONDS):
            self._want = None
            raise RuntimeError(f"the worker thread did not {what} the profile")

    def start(self) -> None:
        self._ask("start")

    def stop(self) -> None:
        self._ask("stop")

    def poll(self) -> None:
        """Called by the worker thread: carry out a pending start or stop."""
        want = self._want
        if want is None:
            return
        self._want = None
        if want == "start":
            self._start()
        elif self.prof is not None:
            self._stop()
        self._done.set()

    def read(self) -> Trace:
        tmp = Path(tempfile.mkdtemp(prefix="bench_trace_"))
        try:
            path = tmp / "trace.json"
            self.prof.export_chrome_trace(str(path))
            data = json.loads(path.read_text())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.prof = None
        events = data.get("traceEvents", []) if isinstance(data, dict) else data
        return Trace(events)
