"""The share of the traced window in which nothing ran on the card: 1 - (the union of the
device events' intervals) / the window, in percent."""


def read(run):
    if run.trace is None or not len(run.trace.start):
        return None
    return 100.0 * (1.0 - run.trace.busy_s(*run.window) / run.window_s)
