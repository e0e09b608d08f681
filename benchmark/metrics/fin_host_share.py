"""Share of the clients' window the finishing stage's host work takes: the
stagetimer spans fin.dispatch, fin.assemble and fin.write, summed over
clients, over the window times the clients (%)."""

STAGES = ("fin.dispatch", "fin.assemble", "fin.write")


def read(run):
    if not run.stages:
        return None
    return 100.0 * sum(run.stages.get(s, 0.0) for s in STAGES) / (run.window_s * run.clients)
