"""The 90th percentile of the seconds of every update of the window."""

from perfbench.benchlib.stats import percentile


def read(run):
    if run.loop != "session" or not run.durations:
        return None
    return percentile(run.durations, 90)
