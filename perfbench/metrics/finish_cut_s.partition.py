"""Seconds of ``finish.cut`` spans, the host cut of the finest level
inside ``vcycle.finish``, per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("finish.cut")
