"""The port's in-process tracer: per-stage wall attribution for the
overlapped pipeline, span records, and counters; grown from the JAX
package's utils/stagetimer.py.

The e2e `--second-best` run interleaves DP batches and finishing batches on
one device queue with async dispatch, so a single wall number can't say
where time goes. This registry splits each HOST thread's wall into named
segments at batch/group granularity. Spans nest by a per-thread stack;
each `pipeline.run()` call is one job with its own id and a root span:

  run            one pipeline.run() call (root; its self time is job wall
                 that no other span covers: generator glue, submit glue)
  run.setup      run()'s entry to the DP stream's start: FASTA loads,
                 validation, RC doubling, fingerprint, state upload,
                 AsyncFinisher start
  run.close      after the last raw chunk: finisher drain (fin.gather,
                 fin.assemble and the tail's fin.write nest in it), the
                 published TSVs' renames, the stamp
  dp.setup       decompose_stream's prelude: read encoding, windows, streams
  dp.prep        window slicing + batch padding (host)
  dp.filter      --ed_thr: K3 and the monomer filter, and the wait on its
                 kept count
  dp.dispatch    forward_fn call (queues device work)
  dp.gather      .cpu() on DP results == wait on device + transfer (and
                 an overflowed batch's uncapped redo)
  dp.replay      a batch's int32 block records -> one array in reading
                 order and read coordinates (one gather; under --ed_thr
                 the monomer column through the filter's permutation)
  dp.postprocess the halo dedup of each run of done windows of a read (one
                 native call a run) and splitting it into window chunks
  host.raw_rows  a finishing group's records -> raw TSV bytes (native,
                 seeded with the read's last end) + write (host)
  host.pend      a finishing group's records -> the finisher's columns
                 (monomer index, starts, ends) (host)
  fin.dispatch   finishing encode + device-call queueing (host)
  fin.gather     .cpu() on identity results == wait on device + transfer
  fin.assemble   [Nb, M] score matrix -> Rows host logic
  fin.write      final/alt TSV formatting + write

Segments marked "wait" are device- or transfer-bound; the rest is host CPU.

Counters, per thread and per job:

  dp.batches       K1 batches the DP stream dispatched
  dp.windows       windows in them
  dp.redo          batches recomputed uncapped after a block-record overflow
  dp.depth_max     most K1 batches queued at once (a maximum)
  fin.groups       finishing groups that queued device work
  fin.blocks       blocks in them
  fin.depth_max    most finishing groups queued at once (a maximum)
  host.native_fallback  dedup pushes and raw-row groups that took the
                   Python fallback because libsdnative was unavailable
                   (0 wherever the library builds)
  dispatch.n       K1 batches and finishing groups about to be queued
  dispatch.starved those of them that found none of the job's earlier
                   device work still running (its done events all
                   complete, or none held); kept only on a CUDA device

Disabled by default, and then `stage()` is one global check returning a
shared null context: no record, no `record_function`, no event query.
Enabled, while a torch.profiler runs, each span also enters
`torch.profiler.record_function("sd.<name>#<job>")`, so the profiler's
trace holds the stages on its own clock, with the kernels each launched
(with no profiler running a range records nothing, so none is entered: it
would cost more than the rest of the span). `epoch_ns()` maps the
records' `perf_counter_ns` stamps to that trace's wall clock, through the
(perf_counter_ns, time_ns) pair enable() reads.

Sums, call counts and self times (a span's duration less its children's
on the same thread) are kept per thread, so no thread's time lands in
another's; `snapshot()` sums them over threads, and a finishing pool
(-t > 1) adds its threads' fin.dispatch to the calling thread's stages.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple

_enabled = False
_NULL = nullcontext()
_lock = threading.Lock()
_local = threading.local()
_logs: list["_ThreadLog"] = []  # every thread's log since the last enable()
_gen = 0  # enable() count: a thread's log of an older one is dropped
_jobs = itertools.count(1)
_held: dict = {}  # job -> done events of its queued device work
_anchor = (0, 0)  # (perf_counter_ns, time_ns) read together at enable()
_record_function = None
_profiler = None  # torch.autograd.profiler: its _is_profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    tid: int  # native thread id, as a profiler's trace gives it
    job: int | None
    parent: int  # index of the parent span in records(), -1 at a root


class _ThreadLog:
    __slots__ = ("gen", "tid", "records", "stack", "total", "self_ns", "calls", "counters")

    def __init__(self, gen: int):
        self.gen = gen
        self.tid = threading.get_native_id()
        self.records: list = []
        self.stack: list = []
        self.total: dict[str, int] = {}
        self.self_ns: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.counters: dict[tuple, int] = {}


def _log() -> _ThreadLog:
    log = getattr(_local, "log", None)
    if log is None or log.gen != _gen:
        log = _local.log = _ThreadLog(_gen)
        with _lock:
            _logs.append(log)
    return log


def _job():
    return getattr(_local, "job", None)


def enable() -> None:
    """Clear every record, sum and counter, and start recording."""
    global _enabled, _gen, _anchor, _record_function, _profiler
    import torch.autograd.profiler as profiler
    from torch.profiler import record_function

    _record_function, _profiler = record_function, profiler
    with _lock:
        _gen += 1
        _logs.clear()
        _held.clear()
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _enabled = True


def disable() -> None:
    """Stop recording; what was recorded stays until the next enable()."""
    global _enabled
    _enabled = False


def _threads() -> list[_ThreadLog]:
    with _lock:
        return list(_logs)


def _sum(attr: str) -> dict:
    out: dict = {}
    for log in _threads():
        for k, v in list(getattr(log, attr).items()):
            out[k] = out.get(k, 0) + v
    return out


def snapshot() -> dict[str, float]:
    """Seconds per stage, summed over threads."""
    return {k: v * 1e-9 for k, v in _sum("total").items()}


def self_snapshot() -> dict[str, float]:
    """Self seconds per stage (less the time of child spans on the same
    thread), summed over threads."""
    return {k: v * 1e-9 for k, v in _sum("self_ns").items()}


def counts() -> dict[str, int]:
    """Calls per stage, summed over threads."""
    return _sum("calls")


def counters(job: int | None = None) -> dict[str, int]:
    """Counters summed over threads and jobs (a `*_max` counter: the
    largest), or of one job."""
    out: dict[str, int] = {}
    for log in _threads():
        for (j, name), v in list(log.counters.items()):
            if job is not None and j != job:
                continue
            if name not in out:
                out[name] = v
            else:
                out[name] = max(out[name], v) if name.endswith("_max") else out[name] + v
    return out


def records() -> list[Span]:
    """Every finished span since enable(), thread by thread in start order;
    `parent` indexes this list."""
    out: list[Span] = []
    for log in _threads():
        index: dict[int, int] = {}
        for i, r in enumerate(list(log.records)):
            if r is None:  # still open
                continue
            index[i] = len(out)
            name, t0, t1, job, parent = r
            out.append(Span(name, t0, t1, log.tid, job, index.get(parent, -1)))
    return out


def epoch_ns(t_ns: int) -> int:
    """A record's perf_counter_ns stamp on the wall clock (time_ns), the
    clock of a torch.profiler chrome trace: its `ts` is (this -
    baseTimeNanoseconds) / 1000."""
    return t_ns - _anchor[0] + _anchor[1]


class _Span:
    __slots__ = ("name", "log", "idx", "parent", "child", "t0", "job", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log = self.log = _log()
        job = self.job = _job()
        self.rf = None
        if getattr(_profiler, "_is_profiler_enabled", True):
            self.rf = _record_function(f"sd.{self.name}" if job is None
                                       else f"sd.{self.name}#{job}")
            self.rf.__enter__()
        self.parent = log.stack[-1] if log.stack else None
        self.idx = len(log.records)
        log.records.append(None)
        log.stack.append(self)
        self.child = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        log = self.log
        log.stack.pop()
        dur = t1 - self.t0
        p = self.parent
        if p is not None:
            p.child += dur
        log.records[self.idx] = (self.name, self.t0, t1, self.job, -1 if p is None else p.idx)
        name = self.name
        log.total[name] = log.total.get(name, 0) + dur
        log.self_ns[name] = log.self_ns.get(name, 0) + dur - self.child
        log.calls[name] = log.calls.get(name, 0) + 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def stage(name: str):
    """Context manager attributing the enclosed wall to `name` (no-op and
    allocation-free when disabled)."""
    return _Span(name) if _enabled else _NULL


class _JobSpan(_Span):
    __slots__ = ("prev",)

    def __enter__(self):
        self.prev = _job()
        _local.job = next(_jobs)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            with _lock:
                _held.pop(self.job, None)
            _local.job = self.prev


def job():
    """The root span `run` of one job: a new job id from a process-wide
    counter, carried by every span and counter the job's thread records
    inside it (and by work handed on through `bind`)."""
    return _JobSpan("run") if _enabled else _NULL


def bind(fn):
    """`fn`, to be run on another thread (a pool) on behalf of the calling
    thread's job: its spans and counters carry that job's id."""
    if not _enabled:
        return fn
    jid = _job()

    def call(*args, **kwargs):
        prev = _job()
        _local.job = jid
        try:
            return fn(*args, **kwargs)
        finally:
            _local.job = prev

    return call


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the current thread and job."""
    if not _enabled:
        return
    c = _log().counters
    key = (_job(), name)
    c[key] = c.get(key, 0) + n


def peak(name: str, value: int) -> None:
    """Raise counter `name` (a `*_max`) of the current thread and job to
    `value`."""
    if not _enabled:
        return
    c = _log().counters
    key = (_job(), name)
    c[key] = max(c.get(key, value), value)


def dispatching(cuda: bool) -> None:
    """Count one dispatch of device work about to be queued. On CUDA, also
    count it starved when none of the job's held done events (`hold`) is
    still pending: the card has nothing of this job left to run."""
    if not _enabled:
        return
    count("dispatch.n")
    if not cuda:
        return
    with _lock:
        held = _held.get(_job())
        if held:
            held[:] = [ev for ev in held if not ev.query()]
    count("dispatch.starved", 0 if held else 1)


def hold(event) -> None:
    """Keep the done event of device work just queued for the job's later
    `dispatching` checks (dropped once it has completed)."""
    if not _enabled or event is None:
        return
    with _lock:
        _held.setdefault(_job(), []).append(event)
