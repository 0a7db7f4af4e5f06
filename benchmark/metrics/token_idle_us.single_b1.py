"""Card-idle µs inside the program's ``asr.decode.token`` spans (a decode
step's launches and the host sync that reads it back) per span: the host's
per-token cost that the card waits on."""

from benchmark.metrics._program import idle_us, spans


def read(run):
    tokens = spans(run, "asr.decode.token")
    if not tokens:
        return None
    return idle_us(run, tokens) / len(tokens)
