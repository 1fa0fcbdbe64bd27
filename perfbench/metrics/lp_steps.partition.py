"""``lp.step`` spans, the chunk steps of every chunked sweep (cluster,
refine, the GA's batched sweeps), per ``partition()`` call."""


def read(run):
    n = sum(1 for name, _, _ in run.spans if name == "lp.step")
    if run.loop != "partition" or not n or not run.calls:
        return None
    return n / run.calls
