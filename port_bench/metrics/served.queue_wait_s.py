"""The mean time from a request's submission (the client's call) to its group's
``device_start`` in the service's ``events``."""


def read(run):
    if run.cell["traffic"] != "served":
        return None
    waits = [g.start - run.requests[i].start for g in run.groups for i in g.requests]
    return sum(waits) / len(waits) if waits else None
