"""Share of the clients' window the host waits on K2's results: the
stagetimer span fin.gather, summed over clients, over the window times
the clients (%)."""


def read(run):
    if not run.stages:
        return None
    return 100.0 * run.stages.get("fin.gather", 0.0) / (run.window_s * run.clients)
