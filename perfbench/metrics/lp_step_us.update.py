"""The mean duration of an ``lp.step`` span in the session loop, in
microseconds: the host's time to dispatch one chunk step of the region
sweep."""


def read(run):
    sel = [b - a for name, a, b in run.spans if name == "lp.step"]
    if run.loop != "session" or not sel:
        return None
    return 1e6 * sum(sel) / len(sel)
