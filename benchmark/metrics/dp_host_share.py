"""Share of the clients' window the DP stream's host work takes: the
stagetimer spans dp.prep, dp.dispatch, dp.replay, dp.postprocess and
host.raw_rows, summed over clients, over the window times the clients (%)."""

STAGES = ("dp.prep", "dp.dispatch", "dp.replay", "dp.postprocess", "host.raw_rows")


def read(run):
    if not run.stages:
        return None
    return 100.0 * sum(run.stages.get(s, 0.0) for s in STAGES) / (run.window_s * run.clients)
