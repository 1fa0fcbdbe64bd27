"""Seconds of ``vcycle.evolve`` spans, the coarsest level's GA, per ``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("vcycle.evolve")
