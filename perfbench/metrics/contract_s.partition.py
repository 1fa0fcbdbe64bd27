"""Seconds of ``vcycle.contract`` spans, the device contraction of each
level up to its four-scalar host read, per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("vcycle.contract")
