"""The card's busy time a request: the union of the device events' intervals in the traced
window over the requests completed in it (a served group's rows each count as a request),
in seconds. It moves with the work the card does for a request, not with the host's pace."""


def read(run):
    if run.trace is None or not len(run.trace.start) or not run.requests:
        return None
    return run.trace.busy_s(*run.window) / len(run.requests)
