"""The port's tracer (utils/stagetimer.py) on the CPU: span records and
their nesting, self time, per-thread sums, job ids and counters through
pipeline.run, the disabled path, and the sd.* ranges a torch.profiler
trace holds on the records' clock."""

import json
import pathlib
import sys
import threading
import time

import pytest
import torch

from stringdecomposer_tpu_torch import cli, pipeline
from stringdecomposer_tpu_torch.io.fasta import load_fasta
from stringdecomposer_tpu_torch.utils import stagetimer as st

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent.parent / "stringdecomposer_tpu_torch" / "test_data"
NEW_SPANS = {"run", "run.setup", "dp.setup", "run.close"}
WINDOWS = dict(batch_size=1500, overlap=150)


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    st.disable()


@pytest.fixture(scope="module")
def golden4k(tmp_path_factory):
    """The golden read's first 4 kbp (three windows at WINDOWS) and the
    DXZ1 monomers."""
    d = tmp_path_factory.mktemp("golden4k")
    read = load_fasta(str(DATA / "read.fa"))[0]
    fa = d / "read4k.fa"
    fa.write_text(f">{read.name}\n{read.seq[:4000]}\n")
    return str(fa), str(DATA / "DXZ1_star_monomers.fa"), d


def _counting(fn, calls):
    def wrapped(*a, **k):
        calls.append(threading.get_native_id())
        return fn(*a, **k)
    return wrapped


def _run(golden, out, threads=1, **kw):
    fa, mono, d = golden
    k1, k2 = [], []
    pipeline.run(fa, mono, out_dir=str(d / out), second_best=True, device="cpu",
                 device_batch=1, threads=threads, **WINDOWS, **kw,
                 forward_fn=_counting(pipeline.chain_dp_forward_cuda, k1),
                 packed_fn=_counting(pipeline.nw_identity_packed_both, k2))
    return k1, k2


def test_records_nest_and_self_time_is_duration_less_children():
    st.enable()
    with st.stage("a"):
        time.sleep(0.002)
        with st.stage("b"):
            time.sleep(0.003)
            with st.stage("c"):
                time.sleep(0.002)
        with st.stage("b"):
            time.sleep(0.001)
    with st.stage("d"):
        pass
    st.disable()
    recs = st.records()
    assert [r.name for r in recs] == ["a", "b", "c", "b", "d"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert {r.job for r in recs} == {None} and {r.tid for r in recs} == {threading.get_native_id()}
    for i, r in enumerate(recs):
        kids = [c for c in recs if c.parent == i]
        assert all(r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns for c in kids)
    dur = {n: sum(r.end_ns - r.start_ns for r in recs if r.name == n) * 1e-9 for n in "abcd"}
    assert st.snapshot() == pytest.approx(dur, abs=1e-12)
    selfs = st.self_snapshot()
    assert selfs["a"] == pytest.approx(dur["a"] - dur["b"], abs=1e-12)
    assert selfs["b"] == pytest.approx(dur["b"] - dur["c"], abs=1e-12)
    assert selfs["c"] == pytest.approx(dur["c"], abs=1e-12) and selfs["a"] > 0.0015
    assert st.counts() == {"a": 1, "b": 2, "c": 1, "d": 1}
    st.enable()  # clears every record, sum and counter
    assert st.records() == [] and st.snapshot() == {} and st.counters() == {}


def test_two_threads_keep_their_own_sums():
    st.enable()
    go = threading.Barrier(2)

    def work(n):
        go.wait()
        for _ in range(n):
            with st.stage("x"):
                with st.stage("y"):
                    time.sleep(0.001)
        st.count("k", n)
        st.peak("k_max", n)

    threads = [threading.Thread(target=work, args=(n,)) for n in (3, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    st.disable()
    recs = st.records()
    by_tid = {}
    for r in recs:
        by_tid.setdefault(r.tid, []).append(r)
    assert sorted(len(v) for v in by_tid.values()) == [6, 10]
    for v in by_tid.values():  # each y is the child of its own thread's x
        for r in v:
            p = recs[r.parent] if r.parent >= 0 else None
            assert (r.name == "x") == (p is None) and (p is None or p.tid == r.tid)
    for name in ("x", "y"):
        want = sum(r.end_ns - r.start_ns for r in recs if r.name == name) * 1e-9
        assert st.snapshot()[name] == pytest.approx(want, abs=1e-12)
    assert st.counts() == {"x": 8, "y": 8}
    assert st.counters() == {"k": 8, "k_max": 5}


def test_many_threads_lose_no_update():
    """More threads than cores, switching often: every span, counter and
    dispatch lands once, in its own thread's job."""

    class Event:
        def query(self):
            return True

    n_threads, n = 32, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        st.enable()
        go = threading.Barrier(n_threads)

        def work():
            go.wait(timeout=30)  # all alive at once: no native id reused
            with st.job():
                for _ in range(n):
                    with st.stage("s"):
                        st.count("c")
                        st.dispatching(True)
                        st.hold(Event())

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        st.disable()
    finally:
        sys.setswitchinterval(old)
    assert st.counts() == {"run": n_threads, "s": n_threads * n}
    assert st.counters() == {"c": n_threads * n, "dispatch.n": n_threads * n,
                             "dispatch.starved": n_threads * n}
    recs = st.records()
    jobs = {r.job for r in recs}
    assert len(jobs) == n_threads and len({r.tid for r in recs}) == n_threads
    for j in jobs:
        assert st.counters(j) == {"c": n, "dispatch.n": n, "dispatch.starved": n}
    assert all(recs[r.parent].job == r.job for r in recs if r.parent >= 0)


@pytest.mark.parametrize("threads", [1, 2])
def test_pipeline_run_spans_jobs_and_counters(golden4k, threads):
    st.enable()
    k1, k2 = _run(golden4k, f"t{threads}", threads=threads)
    st.disable()
    recs = st.records()
    roots = [r for r in recs if r.name == "run"]
    assert len(roots) == 1 and roots[0].parent == -1 and roots[0].job is not None
    root = roots[0]
    names = {r.name for r in recs}
    assert NEW_SPANS | {"dp.dispatch", "dp.gather", "fin.dispatch", "fin.gather",
                        "fin.write", "host.raw_rows", "host.pend"} <= names
    for r in recs:  # every span inside the run root, with its job id
        assert r.job == root.job and root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
        if r.tid == root.tid and r is not root:
            assert r.parent >= 0
    main = [r for r in recs if r.tid == root.tid]
    # on the job's thread the spans tile the root: self times add up to it
    self_ns = {i: r.end_ns - r.start_ns for i, r in enumerate(recs)}
    for r in recs:
        if r.parent >= 0 and r.tid == root.tid:
            self_ns[r.parent] -= r.end_ns - r.start_ns
    assert sum(self_ns[i] for i, r in enumerate(recs) if r.tid == root.tid) == \
        root.end_ns - root.start_ns
    total = sum(v for k, v in st.self_snapshot().items())
    on_pool = sum(r.end_ns - r.start_ns for r in recs if r.tid != root.tid) * 1e-9
    assert total == pytest.approx((root.end_ns - root.start_ns) * 1e-9 + on_pool, abs=1e-6)
    close = next(r for r in main if r.name == "run.close")
    assert any(recs[r.parent] is close for r in main if r.name == "fin.write" and r.parent >= 0)
    c = st.counters()
    assert c == st.counters(root.job) and st.counters(root.job + 1) == {}
    assert c["dp.batches"] == len(k1) == 3 and c["dp.windows"] == 3 and c["dp.redo"] == 0
    assert c["fin.groups"] == len(k2) >= 1 and c["fin.blocks"] > 0
    assert c["dispatch.n"] == len(k1) + len(k2)
    assert 1 <= c["dp.depth_max"] <= pipeline.MAX_INFLIGHT and c["fin.depth_max"] >= 1
    assert "dispatch.starved" not in c  # no events on the CPU
    if threads > 1:  # the pool's fin.dispatch spans carry the job id
        pool = [r for r in recs if r.tid != root.tid]
        assert pool and {r.name for r in pool} == {"fin.dispatch"}
        assert set(k2) == {r.tid for r in pool}


def test_each_run_is_a_job_and_every_path_has_its_spans(golden4k):
    st.enable()
    _run(golden4k, "a")
    _run(golden4k, "a", resume=True)  # finishing from the raw TSV
    _run(golden4k, "s", stream_reads=1)
    st.disable()
    recs = st.records()
    roots = [r for r in recs if r.name == "run"]
    assert len(roots) == 3 and len({r.job for r in roots}) == 3
    for root in roots:
        mine = {r.name for r in recs if r.job == root.job}
        assert {"run.setup", "run.close"} <= mine
        assert ("dp.setup" in mine) == (root is not roots[1])  # resume runs no DP
    assert st.counters(roots[1].job).get("dp.batches") is None
    assert st.counters(roots[2].job)["dp.batches"] == 3


def test_an_overflowed_batch_counts_as_redone():
    """A 3,000 bp window against TTTT holds ~750 blocks, past the cap of
    the block records brought back: each such batch is recomputed."""
    from stringdecomposer_tpu_torch.io.fasta import Record, add_reverse_complement

    reads = [Record("t", "T" * 3000), Record("a", "ACGT" * 500), Record("u", "T" * 2000)]
    monos = add_reverse_complement([Record("m", "TTTT")])
    cfg = pipeline.PipelineConfig(part_size=3000, overlap=8, device_batch=1)
    calls = []
    st.enable()
    pipeline.decompose_reads(reads, monos, cfg, device="cpu",
                             forward_fn=_counting(pipeline.chain_dp_forward_cuda, calls))
    st.disable()
    c = st.counters()
    assert c["dp.batches"] == 3 and c["dp.redo"] == 2 and len(calls) == 5


def test_disabled_records_nothing_and_queries_no_event(golden4k, monkeypatch):
    class Event:
        def query(self):
            raise AssertionError("an event was queried")

    def no_range(*a, **k):
        raise AssertionError("record_function was called")

    st.enable()
    st.disable()
    monkeypatch.setattr(st, "_record_function", no_range)
    assert st.stage("x") is st._NULL and st.job() is st._NULL
    fn = object()
    assert st.bind(fn) is fn
    st.hold(Event())
    st.dispatching(True)
    st.count("k")
    k1, k2 = _run(golden4k, "off")
    assert k1 and k2
    assert st.records() == [] and st.snapshot() == {} and st.counters() == {}


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    st.enable()
    monkeypatch.setattr(st, "_record_function", None)  # a call would raise
    with st.job():
        with st.stage("x"):
            pass
    st.disable()
    assert [r.name for r in st.records()] == ["run", "x"]


def test_a_dispatch_is_starved_when_no_held_event_is_pending():
    class Event:
        def __init__(self, done):
            self.done = done
            self.queries = 0

        def query(self):
            self.queries += 1
            return self.done

    st.enable()
    with st.job():
        st.dispatching(True)  # nothing held: starved
        a, b = Event(False), Event(True)
        st.hold(a)
        st.hold(b)
        st.dispatching(True)  # a still runs
        a.done = True
        st.dispatching(True)  # both done
        st.hold(None)
        st.dispatching(False)  # no starved count off the card
    st.disable()
    assert st.counters() == {"dispatch.n": 4, "dispatch.starved": 2}
    assert b.queries == 1  # a completed event is dropped once seen


def test_sd_ranges_land_in_the_profiler_trace_on_the_records_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with record_function("warm"):  # a process's first range is slow to enter
        pass
    st.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.job():
            with st.stage("dp.prep"):
                time.sleep(0.01)
            with st.stage("fin.write"):
                torch.ones(64).sum()
                time.sleep(0.005)
    st.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    got = {e["name"]: e for e in trace["traceEvents"]
           if e.get("cat") == "user_annotation" and e.get("name", "").startswith("sd.")}
    recs = st.records()
    job = recs[0].job
    assert set(got) == {f"sd.{r.name}#{job}" for r in recs}
    for r in recs:
        e = got[f"sd.{r.name}#{job}"]
        assert abs(e["ts"] - (st.epoch_ns(r.start_ns) - base) / 1000) < 1000  # us
        assert abs(e["dur"] - (r.end_ns - r.start_ns) / 1000) < 1000


def test_profile_dir_traces_the_stages_and_logs_them(golden4k, caplog):
    import logging

    fa, mono, d = golden4k
    caplog.set_level(logging.INFO, logger="SD-TPU")
    args = [fa, mono, "--second-best", "--device", "cpu", "--device-batch", "1",
            "-b", str(WINDOWS["batch_size"]), "-v", str(WINDOWS["overlap"]), "-o", str(d / "prof")]
    assert cli.main([*args, "--profile-dir", str(d / "trace")]) == 0
    traces = list((d / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    roots = [n for n in names if n.startswith("sd.run#")]
    assert len(roots) == 1
    job = roots[0].split("#")[1]
    assert {f"sd.{n}#{job}" for n in NEW_SPANS | {"dp.dispatch", "fin.gather"}} <= names
    assert "stage run: " in caplog.text and "dispatch.n=" in caplog.text
    assert not st._enabled
