"""``csrc/fused_aed_step.cu``'s share (%) of its roofline: Σ bound of the
steps of the traced requests over the step kernels' device time inside
them."""

from benchmark.kernels import aed_step
from benchmark.models.whisper import geometry


def read(run):
    return aed_step.roofline(run, "request", geometry(run.config))
