"""Seconds of audio of every request completed in the window, over the window's seconds
(the window runs until the last request started within ``--seconds`` completes)."""


def read(run):
    if not run.requests:
        return None
    return sum(r.audio_s for r in run.requests) / run.window_s
