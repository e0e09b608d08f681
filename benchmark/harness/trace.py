"""The device trace of a traced run: torch.profiler over the window, every
client thread profiled, and its reduction to device intervals.

The benchmark's own spans are `record_function` ranges named "bench.*"
(bench.job around each run() call, bench.k1 around the K1 entry, bench.k2
around the K2 entries). A device operation belongs to the innermost span
that was open on the host thread when the runtime call that launched it
was made (the trace links the two by their correlation id).
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def profiler():
    """A started profiler of CPU and CUDA activity on every thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=cfg)
    prof.start()
    return prof


@dataclass
class TraceSummary:
    window_s: float  # first bench.job start to last bench.job end
    busy_s: float  # union of device operations within the window
    span_device_s: dict = field(default_factory=dict)  # span -> summed op seconds
    span_union_s: dict = field(default_factory=dict)  # span -> union of its ops' seconds
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most time first
    idle_gaps: list = field(default_factory=list)  # [[host spans, seconds]], longest first


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(intervals, lo, hi) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):  # cut at the argument list, past template brackets
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:120]


class _Spans:
    """The bench.* spans of each host thread: bench.job spans, and the
    spans inside them (which do not nest in each other); innermost lookup
    by time."""

    def __init__(self, events: list[dict]):
        outer: dict = defaultdict(list)
        inner: dict = defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("bench."):
                name = e["name"][6:]
                (outer if name == "job" else inner)[e["tid"]].append(
                    (e["ts"], e["ts"] + e.get("dur", 0), name))
        self.tids = sorted(set(outer) | set(inner))
        self.outer = {t: sorted(v) for t, v in outer.items()}
        self.inner = {t: sorted(v) for t, v in inner.items()}

    @staticmethod
    def _find(spans, ts):
        i = bisect.bisect_right(spans, (ts, float("inf"), "")) - 1
        if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
            return spans[i][2]
        return None

    def at(self, tid, ts: float) -> str | None:
        return (self._find(self.inner.get(tid, []), ts)
                or self._find(self.outer.get(tid, []), ts))

    def jobs(self) -> list[tuple[float, float]]:
        return [(s, e) for v in self.outer.values() for s, e, _ in v]


def summarize(path: str, top: int = 10) -> TraceSummary:
    """Reduce an exported chrome trace (timestamps in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = _Spans(events)
    jobs = spans.jobs()
    if not jobs:
        raise RuntimeError("the trace holds no bench.job span")
    lo, hi = min(s for s, _ in jobs), max(e for _, e in jobs)
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
              if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    by_span: dict = defaultdict(list)
    by_name: dict = defaultdict(float)
    for e in dev:
        host = launch.get(e.get("args", {}).get("correlation"))
        span = spans.at(*host) if host else None
        by_span[span or "none"].append((e["ts"], e["ts"] + e["dur"]))
        by_name[short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]] += e["dur"]
    busy = _union([iv for v in by_span.values() for iv in v])
    gaps = []
    prev = lo
    for s, e in busy + [(hi, hi)]:
        s = min(max(s, lo), hi)
        if s > prev:
            mid = (prev + s) / 2
            names = sorted({spans.at(t, mid) or "idle" for t in spans.tids})
            gaps.append(["+".join(names), (s - prev) * 1e-6])
        prev = max(prev, min(e, hi))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=_clip(busy, lo, hi) * 1e-6,
        span_device_s={k: sum(e - s for s, e in v) * 1e-6 for k, v in by_span.items()},
        span_union_s={k: _clip(_union(v), lo, hi) * 1e-6 for k, v in by_span.items()},
        device_ops=[[n, t * 1e-6] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        idle_gaps=gaps[:top],
    )


def export_and_summarize(prof, run_dir: str) -> TraceSummary:
    path = os.path.join(run_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return summarize(path)
    finally:
        os.remove(path)
