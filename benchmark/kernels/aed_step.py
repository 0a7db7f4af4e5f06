"""``csrc/fused_aed_step.cu`` (batch 1) and ``csrc/fused_aed_multi.cu``
(slots): one decode step of every AED decoder layer and the q8 tied head,
for each slot that is active in it.

Per step, whatever the slots: the int8 weights (per layer q|k|v|o|cq|co|fc1
``D x (6D + F)`` and fc2 ``F x D``, the head ``D x V``), their f32 scales and
zero points (one per 128 rows and column), the f32 biases and LayerNorm
parameters. Per active slot: its input row and its logits, the cache rows
the step attends (self rows up to and including the fresh one, the valid
cross rows; k and v, every layer), the fresh k and v rows written.
Operations per slot: 2 per weight element, and scores plus P.V over the
attended rows (4 D per row and layer).
"""

from __future__ import annotations

from benchmark.core import bound_seconds
from benchmark.kernels import share

# the step's kernels (matvec, LayerNorm, staging, attention), all in
# ``csrc/aed_step.cuh``'s ``aedstep`` namespace
NAMES = r"\baedstep::"
BLOCK = 128


def weight_elems(d: int, f: int, nl: int, v: int) -> int:
    return nl * (d * (6 * d + f) + f * d) + d * v


def cost(d: int, f: int, nl: int, v: int, slots, cache_bytes: int = 4) -> tuple[float, float]:
    """(bytes, operations) of one step; ``slots`` = [(self rows, cross
    rows)] of the active slots."""
    w = weight_elems(d, f, nl, v)
    scales = 8 * (nl * ((d // BLOCK) * (6 * d + f) + (f // BLOCK) * d) + (d // BLOCK) * v)
    params = 4 * (nl * (6 * d + f + d + 6 * d) + 2 * d)
    nbytes = w + scales + params
    flops = 0.0
    for self_rows, cross_rows in slots:
        nbytes += 4 * d + 4 * v                                    # input row, logits
        nbytes += 2 * nl * (self_rows - 1 + cross_rows) * d * cache_bytes  # rows attended
        nbytes += 2 * nl * d * cache_bytes                          # fresh k, v written
        flops += 2.0 * w + 4.0 * nl * (self_rows + cross_rows) * d
    return nbytes, flops


def roofline(run, span: str, geometry: dict) -> float | None:
    """Batch 1: Σ bound of the steps of the traced spans named ``span``
    (whole requests, each ended by a synchronise) ÷ the union of the step
    kernels' device time inside them; None unless each span's launches (the
    program's counter) equal its steps."""
    if run.trace is None:
        return None
    pairs = run.trace.matched(run.spans.of(span))
    if not pairs:
        return None
    bound_s, device_us = 0.0, 0.0
    for rec, iv in pairs:
        if rec.get("step_launches") != len(rec["steps"]):
            return None
        bound_s += sum(bound_seconds(*cost(slots=s, **geometry)) for s in rec["steps"])
        device_us += run.trace.union((a, b) for a, b, _ in run.trace.kernels(NAMES, [iv]))
    return share(bound_s, device_us * 1e-6)
