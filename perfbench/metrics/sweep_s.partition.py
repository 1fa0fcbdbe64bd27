"""Seconds of ``vcycle.sweep`` spans, chunked and dense sweeps (cluster, refine, dense), per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("vcycle.sweep")
