"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's configuration on the card from the seed, warms up
the shapes its traffic uses and counts as ``setup_s``. The loop then drives
the traffic for ``--seconds`` (after a short ramp); with ``--trace 1`` a
bounded sub-window under the profiler follows, and the line carries the
cell's per-layer metrics instead of its end-to-end ones. Once the window
has closed and the program is freed, a sample of the served requests is
judged against the plain reference in ``benchmark/reference``; the numbers
compared, each with its limit, are the line's last key and the last lines
on standard error.

Exits non-zero, printing no result, for a cell that ``BENCHMARK.json`` does
not list or that has no limits file, without a CUDA card (or fewer than the
cell asks for), or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402

core.set_environment()


class Run:
    """What a per-layer metric reader sees of one run."""

    def __init__(self, workload, config, mix, target, window, spans, trace):
        self.workload, self.config, self.mix = workload, config, mix
        self.target, self.window, self.spans, self.trace = target, window, spans, trace

    def delta(self, key: str) -> float:
        """A program counter's change over the window."""
        m = self.window.marks
        return m["end"][1][key] - m["start"][1][key]

    def in_window(self, records: list[dict]) -> list[dict]:
        """Span records opened inside the window (by its counter marks)."""
        a, b = self.window.marks["start"][0], self.window.marks["end"][0]
        return [r for r in records if a <= r["t0"] < b]

    @property
    def window_s(self) -> float:
        return self.window.t1 - self.window.t0

    def done(self, phase: str = "window") -> list:
        return [r for r in self.window.of(phase) if r.handle.ok]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def end_to_end(run: Run, metrics: list[dict]) -> dict:
    """The cell's end-to-end metrics but ``setup_s``, each read by
    ``end_to_end/<name>.py``."""
    out = {}
    for m in metrics:
        if m["name"] == "setup_s":
            continue
        value = core.metric_reader(m["name"], "end_to_end")(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(workload: str, win: list, gaps: list[float]) -> tuple[bool, dict]:
    """The comparison that decides ``correct``: every request of the window
    answered, and the widest of the judged requests' gaps within the cell's
    limit. Returns it and the numbers compared, each with its limit."""
    limit = core.limits(workload)["widest_gap"]["limit"]
    failed = sum(1 for r in win if not r.handle.ok)
    worst = max(gaps, default=float("inf"))
    checks = {"widest_gap": {"value": worst, "limit": limit},
              "answered": {"value": len(win) - failed, "limit": len(win)}}
    return bool(win) and failed == 0 and worst <= limit, checks


def sample(records: list, seed: int, n: int) -> list:
    """``n`` finished requests drawn from the seed, the one with the most
    served tokens (then the longest audio) always among them."""
    import numpy as np

    ok = [r for r in records if r.handle.ok]
    if not ok:
        return []
    longest = max(ok, key=lambda r: (len(r.handle.out["ids"]), r.request.audio_seconds))
    rest = [r for r in ok if r is not longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 11])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             spec: dict | None = None, cell=None, log=print, control_bits: int | None = None,
             readings_out: list | None = None) -> dict:
    """One run; returns the result line's object. ``spec`` / ``cell`` (the
    workload entry, its configuration and traffic) stand in for the files
    where a test gives its own; ``control_bits`` also reads the control (the
    reference at that width in the program's place) into each reading,
    which ``readings_out`` collects, and holds it to the same comparison
    (the result's ``control``)."""
    import torch

    from benchmark import tracing
    from benchmark.traffic import Traffic

    spec = spec or core.load_spec()
    entry, config, mix = cell or core.cell(spec, workload)
    fam = core.family_module(config)
    loop = core.loop_module(mix)
    spans = tracing.Spans(enabled=trace)
    target = fam.build(config, mix, seed, device, spans)
    traffic = Traffic(mix, seed, target.sample_rate, target.scale)
    target.warmup(traffic)
    setup_s = time.perf_counter() - T_PROCESS
    # set-up's objects out of the collector's way: a full collection inside
    # the window then scans only what the window made
    gc.collect()
    gc.freeze()
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()

    profiler = (tracing.Profiler(spans, in_worker=getattr(target, "profile_in_worker", False))
                if trace and is_cuda else None)
    if profiler is not None:
        profiler.warm()
    window = loop.drive(target, traffic, mix, seconds, profiler)
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    log(f"peak device memory {peak} bytes; card {power_limit() if is_cuda else 'cpu'}",
        file=sys.stderr)
    win = window.of("window")
    report = getattr(loop, "report", None)
    if report is not None:
        report(window, log)

    trace_obj = profiler.read() if profiler is not None else None
    if trace_obj is not None:
        log(f"trace: {len(trace_obj.device)} device events, {len(trace_obj.host)} host events, "
            f"{len(trace_obj.spans)} spans over {trace_obj.window_us * 1e-3:.3f} ms, "
            f"busy {trace_obj.busy_us() * 1e-3:.3f} ms", file=sys.stderr)
    run = Run(workload, config, mix, target, window, spans, trace_obj)
    if trace:
        metrics = {}
        for m in core.cell_metrics(spec, workload, "per_layer"):
            value = core.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = end_to_end(run, core.cell_metrics(spec, workload, "end_to_end"))
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # the window has closed: free the program, then judge a sample
    judged = sample(win, seed, int(mix.get("judge_requests", 4)))
    outs = [r.handle.out for r in judged]
    target.close()
    if is_cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_judge = time.perf_counter()
    readings = target.judge([r.request for r in judged], outs, control_bits)
    if readings_out is not None:
        readings_out.extend(readings)
    log(f"reference over {len(judged)} requests: {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    for r, got in zip(judged, readings):
        log(f"judged request {r.request.index}: {json.dumps(got)}", file=sys.stderr)

    correct, checks = verdict(workload, win, [g["widest_gap"] for g in readings])
    failed = sum(1 for r in win if not r.handle.ok)
    result = {"correct": correct, "attempted": len(win), "failed": failed, "metrics": metrics}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace_obj is not None:
        dev["busy_s"] = trace_obj.busy_us() * 1e-6
        dev["window_s"] = trace_obj.window_us * 1e-6
    result["device"] = dev
    if trace_obj is not None:
        result["breakdown"] = {"device_ops": trace_obj.device_ops(), "idle_gaps": trace_obj.idle_gaps()}
    if control_bits is not None:
        c_correct, c_checks = verdict(workload, win, [g["control_gap"] for g in readings])
        result["control"] = {"correct": c_correct, "checks": c_checks}
    result["checks"] = checks
    return result


def finite(x):
    """The result with every non-finite number as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = core.load_spec()
    try:
        entry, _, _ = core.cell(spec, args.workload)
        core.limits(args.workload)
    except KeyError as exc:
        print(f"refused: {exc.args[0]}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec)
    bad = core.forbidden_loaded()
    if bad:
        print(f"loaded what the benchmark may not: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
