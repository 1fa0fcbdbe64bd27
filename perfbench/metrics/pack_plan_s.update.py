"""Seconds of ``pack.plan`` spans, the region plan of the repair (order,
degrees, chunk plan, pads), per update."""


def read(run):
    if run.loop != "session":
        return None
    return run.span_seconds("pack.plan")
