"""K1's share of its roofline: the least time the card could take for the
window's K1 work (harness/roofline.py: 15 int32 operations a real cell of
each window against each DP row, or the bytes, whichever bounds) over the
device time of the operations launched inside the benchmark's bench.k1
spans (the profiler's trace, %)."""

from harness.roofline import bound_s


def read(run):
    t = run.trace.span_device_s.get("k1", 0.0) if run.trace else 0.0
    if t <= 0 or not run.work.get("k1_ops"):
        return None
    return 100.0 * bound_s(run.work["k1_bytes"], run.work["k1_ops"]) / t
