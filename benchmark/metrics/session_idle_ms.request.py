"""Card-idle ms inside the session's own stage spans (``asr.session.pack``,
``upload``, ``download``, ``collect``) per ``asr.session.transcribe`` span:
the session's host work that the card waits on, per request."""

from benchmark.metrics._program import idle_us, spans

STAGES = ("asr.session.pack", "asr.session.upload", "asr.session.download", "asr.session.collect")


def read(run):
    requests = spans(run, "asr.session.transcribe")
    if not requests:
        return None
    return 1e-3 * idle_us(run, [s for name in STAGES for s in spans(run, name)]) / len(requests)
