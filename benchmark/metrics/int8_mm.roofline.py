"""``csrc/quant_matmul_int8.cu``'s share (%) of its roofline: Σ bound of the
calls that the traced spans' shapes give (whole requests, or whole
prefills) over the union of the kernel's device time inside them."""

from benchmark.kernels import int8_mm


def read(run):
    for span in ("prefill", "request"):
        recs = run.spans.of(span, traced=True)
        if recs and "int8_calls" in recs[0]:
            return int8_mm.roofline(run, span)
    return None
