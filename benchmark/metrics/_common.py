"""Helpers the per-layer readers share."""

from __future__ import annotations

from benchmark.core import PEAK_BF16_FLOPS


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def queue_wait_ms(run) -> float | None:
    """Mean of the program's ``t_admit - t_enqueue`` over the window's
    finished requests."""
    return mean(1e3 * r.handle.out["queue_wait"] for r in run.done())


def idle_share(run) -> float | None:
    """Percent of the traced sub-window with no kernel, copy or memset on
    the card."""
    t = run.trace
    if t is None or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)


def mfu_throughput(run) -> float | None:
    """Model operations of the work the window completed (real windows,
    the tokens decoded) over the window at the bf16 peak, in percent."""
    done = run.done()
    if not done or run.window_s <= 0:
        return None
    flops = sum(run.target.work_flops(r.handle.out) for r in done)
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
