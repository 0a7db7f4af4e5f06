"""``csrc/fused_aed_multi.cu``: one decode step of every slot of the
continuous batch, the same work per active slot as the batch-1 step
(``aed_step.cost``), the weights read once a step."""

from __future__ import annotations

from benchmark.core import bound_seconds
from benchmark.kernels import share
from benchmark.kernels.aed_step import NAMES, cost


def roofline(run, span: str, geometry: dict) -> float | None:
    """Σ bound of the steps opened while the profiler ran (each span one
    call, its active slots' rows recorded) ÷ the union of the step kernels'
    device time in the trace; None unless every span made one launch (the
    program's counter)."""
    if run.trace is None:
        return None
    recs = run.spans.of(span, traced=True)
    if not recs or any(r.get("launches") != 1 for r in recs):
        return None
    bound_s = sum(bound_seconds(*cost(slots=r["slots"], **geometry)) for r in recs)
    kern = run.trace.kernels(NAMES)
    return share(bound_s, run.trace.union((a, b) for a, b, _ in kern) * 1e-6)
