"""The time a user waits for one whole count: the window's time over the
jobs it completed (host clock; not a median of jobs)."""


def read(run):
    return run.window_s / len(run.jobs) * 1e3
