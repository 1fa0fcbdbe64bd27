"""Seconds of ``vcycle.finish`` spans, the V-cycle driver's host finish (repair_balance and the cut), per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("vcycle.finish")
