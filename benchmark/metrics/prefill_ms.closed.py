"""Mean prefill (ms): the benchmark's span around the session's
``continuous_prefill`` (encoder, [SOT] probe, prompt), opened and closed by
a synchronise, over the spans opened in the window."""

from benchmark.metrics._common import mean


def read(run):
    return mean(1e3 * (r["t1"] - r["t0"]) for r in run.in_window(run.spans.of("prefill")))
