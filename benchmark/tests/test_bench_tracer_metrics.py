"""The readers of the program's own tracer: job_setup_share and
run_self_share (stagetimer spans) and dispatch_starved_share (its
dispatch counters), on a stub run and a filled tracer, and None where the
run was not traced or the program keeps no such span or counter."""

import time

import pytest
from harness import spec
from harness.session import Run

from stringdecomposer_tpu_torch.utils import stagetimer

NAMES = ("job_setup_share", "run_self_share", "dispatch_starved_share")


def _run(stages, window_s=2.0, clients=2):
    return Run(cell={}, config={}, traffic={}, clients=clients, setup_s=1.0, jobs=[],
               window_s=window_s, stages=stages)


@pytest.fixture
def filled():
    """A tracer holding two jobs on two threads' worth of spans: each job a
    root `run` with run.setup, dp.setup and a dp.gather inside it, and five
    dispatches of which two found the card drained."""

    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    stagetimer.enable()
    for _ in range(2):
        with stagetimer.job():
            with stagetimer.stage("run.setup"):
                time.sleep(0.002)
            with stagetimer.stage("dp.setup"):
                time.sleep(0.001)
            time.sleep(0.003)  # in no stage
            with stagetimer.stage("dp.gather"):
                time.sleep(0.001)
    with stagetimer.job():
        stagetimer.dispatching(True)  # starved: nothing held
        stagetimer.hold(Event(False))
        stagetimer.dispatching(True)
        stagetimer.dispatching(True)
        stagetimer.hold(None)
    with stagetimer.job():
        stagetimer.dispatching(True)  # starved
        stagetimer.hold(Event(False))
        stagetimer.dispatching(True)
    stagetimer.disable()
    yield stagetimer
    stagetimer.enable()
    stagetimer.disable()


def test_the_readers_read_the_filled_tracer(filled):
    stages = filled.snapshot()
    run = _run(stages)
    want_setup = 100.0 * (stages["run.setup"] + stages["dp.setup"]) / (2.0 * 2)
    assert spec.reader("job_setup_share")(run) == pytest.approx(want_setup)
    self_run = filled.self_snapshot()["run"]
    assert self_run == pytest.approx(stages["run"] - stages["run.setup"] - stages["dp.setup"]
                                     - stages["dp.gather"], abs=1e-9)
    assert self_run > 0.005
    assert spec.reader("run_self_share")(run) == pytest.approx(100.0 * self_run / 4.0)
    assert spec.reader("dispatch_starved_share")(run) == pytest.approx(40.0)


def test_a_stub_run_gives_the_expected_setup_share(filled):
    run = _run({"run.setup": 0.3, "dp.setup": 0.1, "dp.gather": 1.0}, window_s=4.0, clients=1)
    assert spec.reader("job_setup_share")(run) == pytest.approx(10.0)
    del run.stages["dp.setup"]
    assert spec.reader("job_setup_share")(run) == pytest.approx(7.5)


@pytest.mark.parametrize("name", NAMES)
def test_none_untraced_or_without_the_programs_spans(filled, name, monkeypatch):
    read = spec.reader(name)
    assert read(_run(None)) is None and read(_run({})) is None
    # a program without the span, the self times or the counters (the
    # parent of the tracer's repair)
    run = _run({"dp.gather": 1.0})
    for attr in ("self_snapshot", "counters"):
        monkeypatch.delattr(stagetimer, attr)
    assert read(run) is None


def test_no_dispatch_counted_reads_none():
    stagetimer.enable()
    with stagetimer.job():
        stagetimer.dispatching(False)  # the CPU: no starved counter
    stagetimer.disable()
    assert spec.reader("dispatch_starved_share")(_run({"run": 1.0})) is None
    stagetimer.enable()
    stagetimer.disable()
    assert spec.reader("dispatch_starved_share")(_run({"run": 1.0})) is None


def test_the_entries_name_these_readers():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert m["workloads"] == ["cenx_dxz1.assembly"] and m["moves"] == "bp_per_s"
        assert m["source"] == ("program_counter" if name.startswith("dispatch")
                               else "program_span")
