"""K2's share of its roofline: the least time the card could take for the
window's K2 work (harness/roofline.py: 11 int32 operations a cell of each
(block, monomer) pair the mode scores, or the bytes) over the device time
of the operations launched inside the benchmark's bench.k2 spans (the
profiler's trace, %)."""

from harness.roofline import bound_s


def read(run):
    t = run.trace.span_device_s.get("k2", 0.0) if run.trace else 0.0
    if t <= 0 or not run.work.get("k2_ops"):
        return None
    return 100.0 * bound_s(run.work["k2_bytes"], run.work["k2_ops"]) / t
