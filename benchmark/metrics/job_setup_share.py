"""Share of the clients' window the program's per-job set-up takes: the
stagetimer spans run.setup (run()'s entry to the DP stream: FASTA loads,
validation, fingerprint, state upload, the finisher's start) and dp.setup
(the DP stream's prelude: read encoding, windows), summed over clients,
over the window times the clients (%). None where the program has no
run.setup span."""

STAGES = ("run.setup", "dp.setup")


def read(run):
    if not run.stages or "run.setup" not in run.stages:
        return None
    return 100.0 * sum(run.stages.get(s, 0.0) for s in STAGES) / (run.window_s * run.clients)
