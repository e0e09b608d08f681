"""Share of the window the card runs operations launched inside the
benchmark's bench.k1 spans: the union of their intervals over the window
(the profiler's trace, %)."""


def read(run):
    t = run.trace.span_union_s.get("k1", 0.0) if run.trace else 0.0
    if t <= 0:
        return None
    return 100.0 * t / run.trace.window_s
