"""Share of the clients' window the host waits on K1's batches: the
program's stagetimer span dp.gather, summed over clients, over the window
times the clients (%)."""


def read(run):
    if not run.stages:
        return None
    return 100.0 * run.stages.get("dp.gather", 0.0) / (run.window_s * run.clients)
