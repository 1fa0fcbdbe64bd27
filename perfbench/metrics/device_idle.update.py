"""The share of the traced window, in %, in which no device operation ran."""


def read(run):
    tl = run.timeline
    if run.loop != "session" or tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
