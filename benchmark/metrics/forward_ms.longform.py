"""Mean forward (ms) of the window's requests: the session's own
``TranscribeResult.elapsed_seconds``, host time around the windows' padded
batch forward, which ends in a copy to the host."""

from benchmark.metrics._common import mean


def read(run):
    return mean(1e3 * r.handle.out["elapsed"] for r in run.done())
