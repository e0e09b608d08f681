"""Share of the program's device dispatches (K1 batches, finishing groups)
that found none of their job's earlier device work still running on the
card: the stagetimer counters dispatch.starved over dispatch.n (%). Read
from the stagetimer the traced run filled; None where the program keeps
no such counters."""


def read(run):
    if not run.stages:
        return None
    from stringdecomposer_tpu_torch.utils import stagetimer

    counters = getattr(stagetimer, "counters", None)
    c = counters() if counters else {}
    if not c.get("dispatch.n") or "dispatch.starved" not in c:
        return None
    return 100.0 * c["dispatch.starved"] / c["dispatch.n"]
