"""``lp.step`` spans, the chunk steps of the region sweep, per update."""


def read(run):
    n = sum(1 for name, _, _ in run.spans if name == "lp.step")
    if run.loop != "session" or not n or not run.calls:
        return None
    return n / run.calls
