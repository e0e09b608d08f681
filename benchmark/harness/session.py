"""One run of one cell: set-up, the measured window, the trace, the check.

Clients are threads of this one process (one process uses the card), each
on a CUDA stream of its own. A job is one call of
stringdecomposer_tpu_torch.pipeline.run on one FASTA, as the CLI and
`--serve` make it. Each client starts a job whenever its last one ended
(a closed loop), until `seconds` have passed since the window opened.
Every job started inside the window runs to its end; the window runs
from the first job's start to the last job's end.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from . import check, inputs, roofline, spec
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "stringdecomposer_tpu")


@dataclass
class JobRecord:
    client: int
    index: int
    input: inputs.Input
    out_dir: str
    kept: bool
    start: float = 0.0
    end: float = 0.0
    error: str | None = None


@dataclass
class Run:
    """What a metric reader reads (benchmark/metrics/<name>.py)."""
    cell: dict
    config: dict
    traffic: dict
    clients: int
    setup_s: float
    jobs: list  # [JobRecord] of the window
    window_s: float
    stages: dict | None = None  # stagetimer seconds by stage, all clients (traced)
    trace: trace_mod.TraceSummary | None = None
    work: dict = field(default_factory=dict)  # k1_ops, k1_bytes, k2_ops, k2_bytes
    card: dict = field(default_factory=dict)  # power limit, sampled SM clocks


class Counters:
    """The program's K1 and K2 entries wrapped in the benchmark's spans,
    with the work each call is given (traced runs only). Device-side sums
    are kept as tensors and read once the window has closed."""

    def __init__(self, fns: dict, mono_fin: list):
        import torch

        self.torch = torch
        self.fns = fns
        self.lock = threading.Lock()
        self.device_sums: list = []  # [k1 records, k2 cells, k2 query bases, k2 target bases, k2 pairs]
        self.host = {"k2_ops": 0, "k2_bytes": 0}
        raw = [len(s) for _, s in mono_fin]
        hom = [int(1 + roofline.homo_prefix(np.frombuffer(s.encode(), np.uint8))[-1])
               for _, s in mono_fin]
        self.fin = dict(raw_sum=sum(raw), homo_sum=sum(hom), M=len(mono_fin),
                        mono_bytes=sum(raw) + sum(hom) + 8 * len(mono_fin))

    def reset(self):
        """Forget the warm jobs' work: the window's alone is counted."""
        with self.lock:
            self.device_sums.clear()
            self.host = {"k2_ops": 0, "k2_bytes": 0}

    def _add(self, vec):
        with self.lock:
            self.device_sums.append(vec)

    def for_job(self, prefix: np.ndarray) -> dict:
        from torch.profiler import record_function

        torch = self.torch
        fns = self.fns

        def forward_fn(*a, **k):
            with record_function("bench.k1"):
                blocks, counts = fns["forward_fn"](*a, **k)
            z = torch.zeros(4, dtype=torch.int64, device=counts.device)
            self._add(torch.cat([counts.sum().to(torch.int64).reshape(1), z]))
            return blocks, counts

        def identity_fn(q, ql, t, tl):
            with record_function("bench.k2"):
                out = fns["identity_fn"](q, ql, t, tl)
            qi, ti = ql.to(torch.int64), tl.to(torch.int64)
            self._add(torch.stack([torch.zeros_like(qi[0]), (qi * ti).sum(), qi.sum(), ti.sum(),
                                   torch.ones_like(qi).sum()]))
            return out

        def packed_fn(read, starts, lens, *rest, **kw):
            with record_function("bench.k2"):
                out = fns["packed_fn"](read, starts, lens, *rest, **kw)
            w = roofline.k2_packed(starts, lens, prefix, **self.fin)
            with self.lock:
                self.host["k2_ops"] += w["ops"]
                self.host["k2_bytes"] += w["bytes"]
            return out

        return dict(forward_fn=forward_fn, identity_fn=identity_fn, packed_fn=packed_fn)

    def totals(self) -> dict:
        torch = self.torch
        s = [int(x) for x in torch.stack(self.device_sums).sum(dim=0).tolist()] \
            if self.device_sums else [0] * 5
        light = roofline.k2_pairs(s[1], s[2], s[3], s[4])
        return {"k1_records": s[0], "k2_ops": self.host["k2_ops"] + light["ops"],
                "k2_bytes": self.host["k2_bytes"] + (light["bytes"] if s[4] else 0)}


def nvidia_smi(fields: str) -> list[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return [x.strip() for x in out.stdout.strip().split(",")]
    except (OSError, subprocess.SubprocessError):
        return []


class ClockSampler:
    """nvidia-smi's SM clock every `every` seconds while the window is open."""

    def __init__(self, every: float = 2.0):
        self.every = every
        self.samples: list[float] = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self.stop.is_set():
            v = nvidia_smi("clocks.sm")
            if v and v[0].replace(".", "").isdigit():
                self.samples.append(float(v[0]))
            self.stop.wait(self.every)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, t_process: float,
             device: str = "cuda", wrap=None,
             log=print) -> tuple[dict, list[tuple[str, float, float]]]:
    """One run of a cell. Returns the result line's object and the check's
    (name, number, limit) triples. `wrap`, for the tests, maps the
    program's kernel entries to functions put in their place."""
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    return run_spec(bench, cell, config, traffic, seed, seconds, trace, t_process, device, wrap,
                    log)


def run_spec(bench, cell, config, traffic, seed, seconds, trace, t_process, device="cuda",
             wrap=None, log=print):
    import torch

    from stringdecomposer_tpu_torch import pipeline
    from stringdecomposer_tpu_torch.ops.chain_dp_cuda import chain_dp_forward_cuda
    from stringdecomposer_tpu_torch.ops.identity_cuda import (
        nw_identity_batch_cuda, nw_identity_packed_both,
    )
    from stringdecomposer_tpu_torch.utils import stagetimer

    cuda = device == "cuda"
    dev = torch.device(device)
    if cuda:
        from stringdecomposer_tpu_torch.runtime.build import library

        library()  # builds the kernels on a checkout's first run
        torch.zeros(1, device=dev)
    fns = dict(forward_fn=chain_dp_forward_cuda, identity_fn=nw_identity_batch_cuda,
               packed_fn=nw_identity_packed_both)
    if wrap:
        fns = {k: wrap.get(k, lambda f: f)(f) for k, f in fns.items()}
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    run_dir = tempfile.mkdtemp(prefix="sdbench-", dir=base)
    try:
        return _run(bench, cell, config, traffic, seed, seconds, trace, t_process, dev, fns,
                    run_dir, pipeline, stagetimer, log)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _run(bench, cell, config, traffic, seed, seconds, trace, t_process, dev, fns, run_dir,
         pipeline, stagetimer, log):
    import torch

    cuda = dev.type == "cuda"
    cli = config["cli"]
    inp = inputs.make(config, traffic, seed, run_dir)
    from reference.fasta import finishing_order  # the monomer orders are the tool's

    counters = Counters(fns, finishing_order(inp.monomers)) if trace else None
    prefixes = {}
    k1_mono = [len(s) for _, s in inp.monomers] * 2
    clients = traffic["clients"]
    records: list[JobRecord] = []
    rec_lock = threading.Lock()
    errors: list[str] = []

    def job_fns(inp_: inputs.Input) -> dict:
        if counters is None:
            return fns
        if inp_.name not in prefixes:
            from reference.fasta import encode

            prefixes[inp_.name] = roofline.homo_prefix(encode(inp_.seq))
        return counters.for_job(prefixes[inp_.name])

    if counters is not None:  # every input's prefix, before the window
        for x in inp.jobs:
            job_fns(x)

    def call(inp_: inputs.Input, out_dir: str, record: JobRecord | None):
        kw = job_fns(inp_)
        ctx = torch.profiler.record_function("bench.job") if trace and record else nullcontext()
        with ctx:
            pipeline.run(inp_.fasta, inp.monomers_fa, out_dir=out_dir,
                         scoring=cli["scoring"], batch_size=cli["batch_size"],
                         overlap=cli["overlap"], second_best=cli["second_best"],
                         min_identity=cli["min_identity"], threads=cli["threads"],
                         device_batch=cli["device_batch"], device=dev, **kw)

    def run_job(r: JobRecord):
        r.start = time.perf_counter()
        try:
            call(r.input, r.out_dir, r)
        except Exception:  # a failed job counts as failed; the run goes on
            r.error = traceback.format_exc()
            with rec_lock:
                errors.append(r.error)
        r.end = time.perf_counter()
        with rec_lock:
            records.append(r)

    def out_dir(c: int, i: int, kept: bool) -> str:
        return os.path.join(run_dir, "out", f"c{c}_j{i}" if kept else f"c{c}_scratch")

    keep_every = traffic["check"]["keep_every"]
    ready = threading.Barrier(clients + 1)  # every client warm
    go = threading.Barrier(clients + 1)  # the window opens
    t0_box: list[float] = []

    def client(c: int):
        stream = torch.cuda.Stream(dev) if cuda else None
        with torch.cuda.stream(stream) if cuda else nullcontext():
            try:
                for w in inp.warm[c]:
                    call(w, os.path.join(run_dir, "warm", f"c{c}"), None)
                if cuda:
                    torch.cuda.current_stream(dev).synchronize()
            except Exception:  # set-up failed: no window
                errors.append(traceback.format_exc())
                ready.abort()
                return
            try:
                ready.wait()
                go.wait()
            except threading.BrokenBarrierError:
                return
            t0 = t0_box[0]
            i = 0
            while time.perf_counter() < t0 + seconds:
                kept = i % keep_every == inp.phase[c]
                run_job(JobRecord(c, i, inp.jobs[c], out_dir(c, i, kept), kept))
                i += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    prof = None
    if trace:  # the profiler's first start is slow: pay it in set-up
        trace_mod.profiler().stop()
    try:
        ready.wait()
    except threading.BrokenBarrierError:
        go.abort()
        for t in threads:
            t.join()
        raise RuntimeError("a client's warm job failed:\n" + "\n".join(errors)) from None
    if trace:
        counters.reset()
        stagetimer.enable()
        prof = trace_mod.profiler()
    sampler = ClockSampler() if trace and cuda else nullcontext()
    with sampler:
        t0 = time.perf_counter()
        t0_box.append(t0)
        setup_s = t0 - t_process
        go.wait()
        for t in threads:
            t.join()
        if cuda:
            torch.cuda.synchronize(dev)
    summary = stages = None
    card = {}
    if trace:
        prof.stop()
        stages = stagetimer.snapshot()
        stagetimer.disable()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace:
        summary = trace_mod.export_and_summarize(prof, run_dir)
        limit = nvidia_smi("power.limit")
        card = {"power_limit_w": limit[0] if limit else "unread",
                "sm_clock_mhz": sampler.samples if cuda else []}
    records.sort(key=lambda r: r.start)
    window_s = max(r.end for r in records) - min(r.start for r in records)
    work = {}
    if counters is not None:
        tot = counters.totals()
        k1_ops = k1_bytes = 0
        for r in records:
            wins = [n for _, n in _windows(r.input.bp, cli)]
            w = roofline.k1_job(wins, k1_mono)
            k1_ops += w["ops"]
            k1_bytes += w["bytes"]
        work = {"k1_ops": k1_ops, "k1_bytes": k1_bytes + 16 * tot["k1_records"],
                "k2_ops": tot["k2_ops"], "k2_bytes": tot["k2_bytes"]}
    run = Run(cell, config, traffic, clients, setup_s, records, window_s, stages, summary, work,
              card)
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if cuda:
        torch.cuda.empty_cache()
    walls = sorted(r.end - r.start for r in records)
    log(f"run: {len(records)} jobs in {window_s:.3f} s, set-up {setup_s:.3f} s; job wall s "
        f"min {walls[0]:.4f} median {statistics.median(walls):.4f} max {walls[-1]:.4f}; "
        f"load {_proc('/proc/loadavg')}; written so far: {_written()}")
    numbers = check.judge(records, inp, config, traffic, seed, dev, log)
    numbers.insert(0, ("failed_jobs", float(len(errors)), 0.0))
    for e in errors[:3]:
        log(e)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(v <= lim for _, v, lim in numbers),
              "attempted": len(records), "failed": len(errors), "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        result["card"] = card
    return result, numbers


def _windows(bp: int, cli: dict):
    from reference.chain_dp import make_windows

    return make_windows(bp, cli["batch_size"], cli["overlap"])


def _proc(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return "unread"


def _written() -> str:
    """This process's write counters (/proc/self/io), where the OS has them."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
    except OSError:
        return "unread"
    return f"wchar {int(io['wchar'])} B, write_bytes {int(io['write_bytes'])} B"


def loaded_forbidden() -> list[str]:
    """Top-level names of modules in sys.modules that the port's run may
    not load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

