"""Seconds of ``repair.*`` spans (expand, gather, sweep, gain, balance) per
update."""


def read(run):
    if run.loop != "session":
        return None
    return run.span_seconds("repair.")
