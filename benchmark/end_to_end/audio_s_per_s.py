"""Audio seconds transcribed per wall second: the audio of every request of
the window that completed, over the whole window (a closed loop's window
ends when the last request sent in it returns)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(r.request.audio_seconds for r in run.done()) / run.window_s
