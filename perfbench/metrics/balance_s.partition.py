"""Seconds of ``finish.balance`` spans, the balance repair of the finest
level inside ``vcycle.finish``, per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("finish.balance")
