"""Bases decomposed a second: the bp of every job of the window over the
window's seconds (host clock)."""


def read(run):
    return sum(j.input.bp for j in run.jobs) / run.window_s
