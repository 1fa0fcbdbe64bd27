"""Seconds of ``vcycle.pack`` spans, chunk and ELL packs: host planning and device gathers, per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("vcycle.pack")
