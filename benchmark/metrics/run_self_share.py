"""Share of the clients' window that is job wall in no stage: the self time
of the program's root spans `run` (one a pipeline.run call, less the time
of every span nested in it on the job's thread), summed over clients, over
the window times the clients (%). Read from the stagetimer the traced run
filled; None where the program's stagetimer keeps no self times."""


def read(run):
    if not run.stages:
        return None
    from stringdecomposer_tpu_torch.utils import stagetimer

    self_snapshot = getattr(stagetimer, "self_snapshot", None)
    s = self_snapshot().get("run") if self_snapshot else None
    if s is None:
        return None
    return 100.0 * s / (run.window_s * run.clients)
