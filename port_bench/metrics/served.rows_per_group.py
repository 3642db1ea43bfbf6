"""Requests a coalesced generation served: the window's requests over the groups the
service formed for them (its ``events``)."""


def read(run):
    groups = [g for g in run.groups if g.rows]
    if run.cell["traffic"] != "served" or not groups:
        return None
    return sum(g.rows for g in groups) / len(groups)
