"""``csrc/fused_aed_multi.cu``'s share (%) of its roofline: Σ bound of the
traced steps, each over the slots active in it, over the step kernels'
device time. The share rises with the slots a step carries (each adds its
cross rows to the bytes; the step's time grows less), so an earlier line of
standard error gives the traced steps' mean active slots beside it."""

import sys

from benchmark.kernels import aed_multi
from benchmark.models.whisper import geometry


def read(run):
    cache = 2 if run.mix["server"]["kv_dtype"] == "bf16" else 4
    value = aed_multi.roofline(run, "aed_multi", {**geometry(run.config), "cache_bytes": cache})
    recs = run.spans.of("aed_multi", traced=True)
    if recs:
        slots = sum(len(r["slots"]) for r in recs) / len(recs)
        print(f"aed_multi: {len(recs)} traced steps, {slots:.3f} slots active a step", file=sys.stderr)
    return value
