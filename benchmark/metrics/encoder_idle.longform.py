"""The card's idle share (%) of the time inside the program's
``asr.sv.encode`` spans (the SANM stack): the launch-bound share of the
eager encoder."""

from benchmark.metrics._program import idle_us, spans


def read(run):
    enc = spans(run, "asr.sv.encode")
    if not enc:
        return None
    return 100.0 * idle_us(run, enc) / sum(b - a for a, b in enc)
