"""Seconds of ``pack.plan`` spans, the pack builders' host planning (and
any host copy of a device graph the plan reads), per ``partition()``
call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("pack.plan")
