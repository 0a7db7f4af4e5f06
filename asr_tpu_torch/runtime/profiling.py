"""Tracing / profiling hooks.

Counterpart of ``asr_tpu/runtime/profiling.py``:

- :func:`trace` — a ``torch.profiler`` trace of the enclosed region, CPU
  activity and, on the card, CUDA kernels and copies (through CUPTI),
  written as one Chrome-trace JSON file that Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing`` opens. It takes the
  place of the JAX package's xprof trace. A trace on the card that holds no
  CUDA event is an error, not a quiet CPU-only file.
- :func:`annotate` — a named span (``record_function``) while a profile
  runs, and a shared no-op context otherwise. The sessions and models open
  their stage spans (``asr.*``) with it.
- :func:`device_events` / :func:`device_summary` — the kernel and copy
  events of a written trace, and their count, busy time (the union of their
  intervals) and idle share of the traced window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from pathlib import Path

import torch
from torch.autograd import profiler as autograd_profiler

# Chrome-trace categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """What :func:`trace` yields: the ``torch.profiler.profile`` object
    (``key_averages()`` and the rest) and ``path``, the Chrome-trace JSON,
    set when the region ends."""

    profile: object
    path: Path | None = None


@contextlib.contextmanager
def trace(logdir: str | Path, cuda: bool | None = None):
    """Profile the enclosed region into ``logdir``. ``cuda``: record CUDA
    activity (default: whenever a card is visible)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        out = Trace(prof)
        yield out
        if cuda:
            torch.cuda.synchronize()
    out.path = logdir / f"{os.uname().nodename}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(out.path))
    if cuda and not re.search(r'"cat":\s*"(kernel|gpu_memcpy|gpu_memset)"', out.path.read_text()):
        raise RuntimeError(f"{out.path}: the trace holds no CUDA event (is CUPTI, libcupti, "
                           "missing from the torch installation?)")


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` while a ``torch.profiler`` profile runs: a
    ``record_function``, which the trace holds as a ``user_annotation``
    event on the clock of its kernels and copies. Otherwise a shared no-op
    context: entering a ``record_function`` costs about 10 µs even with no
    profile running, reading the flag well under 1 µs.

    The flag is the one ``torch.profiler`` sets for the process whenever a
    profile runs. ``torch.autograd._profiler_enabled()`` reads False under a
    profile that records every thread (``profile_all_threads``, as the
    benchmark's traced window runs), even on the thread that started it."""
    return torch.profiler.record_function(name) if autograd_profiler._is_profiler_enabled else _NO_SPAN


def _complete_events(path: str | Path) -> list[dict]:
    events = json.loads(Path(path).read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"]


def device_events(path: str | Path) -> list[dict]:
    """The complete events of a Chrome trace that ran on the card (kernels,
    copies, memsets), in start order; each has ``name``, ``cat``, ``ts`` and
    ``dur`` in microseconds."""
    return _device_events(_complete_events(path))


def _device_events(events: list[dict]) -> list[dict]:
    return sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES), key=lambda e: e["ts"])


def device_summary(path: str | Path, name_filter: str = "") -> dict:
    """Of a Chrome trace, read once: ``kernels`` (kernel events),
    ``launches`` (those whose name holds ``name_filter``), ``busy_us`` (the
    union of every device event's interval), ``window_us`` (first to last
    event of any kind) and ``idle_share`` (the part of the window with no
    device event)."""
    events = _complete_events(path)
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events]
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) if spans else 0.0
    busy, end = 0.0, float("-inf")
    dev = _device_events(events)
    for e in dev:  # in start order: add what each interval reaches past the union so far
        a, b = e["ts"], e["ts"] + e["dur"]
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = [e["name"] for e in dev if e["cat"] == "kernel"]
    return {"kernels": len(kernels), "launches": sum(1 for n in kernels if name_filter in n),
            "busy_us": busy, "window_us": window, "idle_share": 1.0 - busy / window if window else 1.0}
