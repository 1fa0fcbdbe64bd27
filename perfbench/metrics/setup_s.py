"""Seconds from process start to the first timed call: imports, generation,
the input pool, kernel load or build, the warm call or the session's start."""


def read(run):
    return run.setup_s
