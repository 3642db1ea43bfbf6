"""The mean wall of every request completed in the window, from its submission to its
audio as a host array (served: from the client's call to its return)."""


def read(run):
    if not run.requests:
        return None
    return sum(r.end - r.start for r in run.requests) / len(run.requests)
