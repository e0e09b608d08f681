"""Per-stage wall attribution for the overlapped pipeline; the port's copy
of the JAX package's utils/stagetimer.py.

The e2e `--second-best` run interleaves DP batches and finishing batches on
one device queue with async dispatch, so a single wall number can't say
where time goes. This registry splits the HOST
thread's wall into named, non-overlapping segments at batch/group
granularity:

  dp.prep        window slicing + batch padding (host)
  dp.dispatch    forward_fn call (queues device work)
  dp.gather      .cpu() on DP results == wait on device + transfer
  dp.replay      block-record walk -> Block lists (host)
  dp.postprocess halo dedup + emission bookkeeping (host)
  host.raw_rows  raw TSV formatting + write (host)
  host.pend      finishing work-list building (host)
  fin.dispatch   finishing encode + device-call queueing (host)
  fin.gather     .cpu() on identity results == wait on device + transfer
  fin.assemble   [Nb, M] score matrix -> Rows host logic
  fin.write      final/alt TSV formatting + write

Segments marked "wait" are device- or transfer-bound; the rest is host CPU.
Disabled by default: `stage()` costs one dict lookup + a truthiness check per
call site (call sites are per-batch, never per-block). With a finishing
thread pool (-t > 1) fin.dispatch runs off-thread, so segment sums can
exceed wall — attribution runs use -t 1.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

_enabled = False
_acc: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_NULL = nullcontext()


def enable() -> None:
    global _enabled
    _acc.clear()
    _counts.clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def snapshot() -> dict[str, float]:
    """Accumulated seconds per stage (copy)."""
    return dict(_acc)


def counts() -> dict[str, int]:
    return dict(_counts)


@contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _counts[name] += 1


def stage(name: str):
    """Context manager attributing the enclosed wall to `name` (no-op and
    allocation-free when disabled)."""
    return _timed(name) if _enabled else _NULL
