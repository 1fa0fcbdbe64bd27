"""Seconds per ``partition()`` call: all the window's completed calls' time
over their count."""


def read(run):
    if run.loop != "partition" or not run.durations:
        return None
    return sum(run.durations) / len(run.durations)
