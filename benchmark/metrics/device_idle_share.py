"""Share of the window in which no operation runs on the card: 1 minus the
union of every kernel, copy and set of the profiler's trace over the
window (%)."""


def read(run):
    if not run.trace or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
