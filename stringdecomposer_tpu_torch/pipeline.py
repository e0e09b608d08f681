"""End-to-end decomposition pipeline, ported from stringdecomposer_tpu/pipeline.py.

Stages:
  1. FASTA load + validation + RC monomer doubling    (io/fasta.py)
  2. halo windowing of every read                      (ops/oracle.make_windows)
  3. with --ed_thr: per-window monomer pre-filter      (ops/hw_filter_cuda.py, K3)
     batched chain DP + block walk on the device       (ops/chain_dp_cuda.py, K1)
  4. host replay of block records, merge to global coordinates, halo dedup
     (int32 records throughout: ops/records.py)
  5. raw TSV                                           (report.py)
  6. rescoring (--second-best or light)                (finishing.py, K2)
  7. final + alt TSVs

The device is explicit: `run(device=...)` takes "cuda" or "cpu". On "cuda"
every kernel wrapper launches its kernel; "cpu" runs the plain PyTorch twins.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pathlib
import time
from collections import deque
from contextlib import ExitStack, contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from .convert import (
    DeviceState, done_event, numpy_state, state_from_numpy, to_host, upload, wait_done,
)
from .io.fasta import Record, encode
from .ops.chain_dp import build_window_batch
from .ops.chain_dp_cuda import chain_dp_forward_cuda
from .ops.hw_filter import filter_monomers_device
from .ops.hw_filter_cuda import hw_distance_batch_cuda
from .ops.identity_cuda import nw_identity_batch_cuda, nw_identity_packed_both
from .ops.oracle import Block, Scoring, make_windows
from .ops.records import EMPTY, DedupStream, replay_batch, to_blocks
from .utils import stagetimer
from .utils.stagetimer import stage

logger = logging.getLogger("SD-TPU")

# pending blocks of one read that make a finishing group without waiting
# for the read's last window
FIN_CHUNK = 4096
# DP batches queued on the device before the host replays the oldest
MAX_INFLIGHT = 4
# windows in the first batches of a run (later ones take device_batch)
RAMP = (24, 48)


@dataclass
class WindowTask:
    read_idx: int
    offset: int
    length: int


@dataclass
class PipelineConfig:
    scoring: Scoring = field(default_factory=Scoring)
    part_size: int = 5000
    overlap: int = 500
    device_batch: int = 64  # windows per kernel launch
    ed_thr: int = -1  # > -1: per-window monomer pre-filter (src/main.cpp:128-149)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device a run computes on. Asking for CUDA without one is an
    error: the port never carries on on the CPU unless told to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass --device cpu to run the plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def _levels(W: int) -> list[int]:
    """Window-width buckets W, W/2, W/4, ... >= 512: short reads stop paying
    for full-width padding, tail windows stay in the full-width bucket."""
    levels = [W]
    while levels[-1] // 2 >= 512:
        levels.append(levels[-1] // 2)
    return levels


@dataclass
class _Batch:
    """One dispatched DP batch: its tasks, its K1 inputs on the device (kept
    for the overflow redo), host copies of its block records, counts and,
    under --ed_thr, monomer permutation, and the event after which those
    copies may be read."""
    tidxs: list[int]
    inputs: tuple
    blocks: torch.Tensor
    counts: torch.Tensor
    perm: torch.Tensor | None
    done: object


def decompose_stream(
    reads: list[Record],
    monomers: list[Record],
    cfg: PipelineConfig = PipelineConfig(),
    device: str | torch.device = "cuda",
    forward_fn=chain_dp_forward_cuda,
    state: DeviceState | None = None,
    hw_fn=hw_distance_batch_cuda,
):
    """Generator over finalized block chunks in strict (read, window) order.

    Yields (read_idx, blocks, final): `blocks` [n, 4] int32 records
    (monomer, start, end, identity) of postprocessed blocks in read
    coordinates that will not change (the halo-dedup lookahead is carried
    in an ops/records.DedupStream); `final` marks a read's last chunk.
    Every read yields exactly one final chunk (possibly empty), in input
    order, and each window the blocks it made final, as
    oracle.PostprocessStream would a window at a time. Windows are bucketed
    by width within slabs of consecutive tasks, so emission tracks input
    order.

    Up to MAX_INFLIGHT batches are queued on the device at once, each
    copying its block records to pinned host memory as soon as K1 and the
    walk are done; the host waits on a batch's event only when the bound is
    reached or at the end, so that it replays one batch while later ones
    run. The uploads, K3 and the filter run on a side stream: under
    --ed_thr the host waits for the kept count on that stream alone, not on
    the K1 batches queued before it. On the CPU the events are no-ops and
    the same code runs the plain twins."""
    with stage("dp.setup"):
        dev = resolve_device(device)
        if state is None:
            mono_np, lens_np = numpy_state(monomers, [])[:2]
            mono = torch.from_numpy(mono_np).to(dev)
            mono_lens = torch.from_numpy(lens_np).to(dev)
        else:
            mono, mono_lens = state.mono, state.mono_lens
        tasks: list[WindowTask] = []
        read_codes = [encode(r.seq) for r in reads]
        for ridx, r in enumerate(reads):
            for off, ln in make_windows(len(r.seq), cfg.part_size, cfg.overlap):
                tasks.append(WindowTask(ridx, off, ln))
        W = cfg.part_size + cfg.overlap
        logger.info("Prepared %d windows from %d reads", len(tasks), len(reads))
        sc = cfg.scoring
        kw = dict(ins=sc.ins, dele=sc.dele, mismatch=sc.mismatch, match=sc.match)
        per_window: list = [None] * len(tasks)
        done = [False] * len(tasks)
        cuda = dev.type == "cuda"
        main = torch.cuda.current_stream(dev) if cuda else None
        side = torch.cuda.Stream(dev) if cuda else None
        inflight: deque[_Batch] = deque()

    def dispatch(tidxs: list[int], W_b: int) -> None:
        with stage("dp.prep"):
            wins = [read_codes[tasks[t].read_idx][tasks[t].offset : tasks[t].offset + tasks[t].length]
                    for t in tidxs]
            wbatch, wlens = build_window_batch(wins, W_b)
        perm = None
        with torch.cuda.stream(side) if cuda else nullcontext():
            wb, wl = upload(wbatch, dev), upload(wlens, dev)
            fwd = (wb, wl, mono, mono_lens)
            if cfg.ed_thr > -1:
                # per-window monomer subset in (distance, index) order: both
                # decide the DP's ties. Rows past a window's kept count have
                # length 0 (end score NEG, never picked), so K1 runs only the
                # first max(kept) rows of the per-window set.
                with stage("dp.filter"):
                    dist = hw_fn(wb, wl, mono, mono_lens)
                    mono_w, lens_w, perm = filter_monomers_device(dist, mono, mono_lens,
                                                                  cfg.ed_thr)
                    m_eff = to_host((dist <= cfg.ed_thr).sum(dim=1).clamp(min=1).max())
                    perm = to_host(perm)
            ready = done_event(dev)
        if cfg.ed_thr > -1:
            with stage("dp.filter"):
                wait_done(ready)
                m = int(m_eff)
                fwd = (wb, wl, mono_w[:, :m], lens_w[:, :m])
        if cuda:
            main.wait_event(ready)
            for t in fwd:  # read on the main stream; most were made on the side one
                t.record_stream(main)
        # cap the block records brought back: real windows hold ~W/170
        # blocks; an overflow is detected in drain() and recomputed uncapped
        cap = min(W_b, max(256, W_b // 8))
        with stage("dp.dispatch"):
            fwd = tuple(t.contiguous() for t in fwd)
            stagetimer.dispatching(cuda)
            blocks, counts = forward_fn(*fwd, max_blocks=cap, **kw)
            inflight.append(_Batch(tidxs, fwd, to_host(blocks), to_host(counts), perm,
                                   done_event(dev)))
            stagetimer.hold(inflight[-1].done)

    def drain(every: bool) -> None:
        """Replay the oldest batches: all of them, or down to one under the
        bound."""
        nonlocal n_redo
        while inflight and (every or len(inflight) >= MAX_INFLIGHT):
            b = inflight.popleft()
            with stage("dp.gather"):
                wait_done(b.done)
                blocks_np, counts_np = b.blocks.numpy(), b.counts.numpy()
                if counts_np.max() > blocks_np.shape[1]:
                    # a window past the cap (the walk counts past it):
                    # recompute this batch uncapped from its own inputs
                    n_redo += 1
                    blocks, counts = forward_fn(*b.inputs, **kw)
                    blocks, counts = to_host(blocks), to_host(counts)
                    wait_done(done_event(dev))
                    blocks_np, counts_np = blocks.numpy(), counts.numpy()
            with stage("dp.replay"):
                offsets = [tasks[t].offset for t in b.tidxs]
                recs, bounds = replay_batch(blocks_np, counts_np, offsets,
                                            None if b.perm is None else b.perm.numpy())
                for i, t in enumerate(b.tidxs):
                    per_window[t] = recs[bounds[i] : bounds[i + 1]]
                    done[t] = True

    cursor = 0
    dedup: DedupStream | None = None
    next_final = 0

    def emit_ready() -> list[tuple[int, np.ndarray, bool]]:
        """Push each run of done windows of one read through the read's
        dedup at once; a chunk a window that made blocks final, and the
        read's final chunk."""
        nonlocal cursor, dedup, next_final
        out: list[tuple[int, np.ndarray, bool]] = []
        with stage("dp.postprocess"):
            while cursor < len(tasks) and done[cursor]:
                ridx = tasks[cursor].read_idx
                while next_final < ridx:  # reads without windows
                    out.append((next_final, EMPTY, True))
                    next_final += 1
                end = cursor + 1
                while end < len(tasks) and done[end] and tasks[end].read_idx == ridx:
                    end += 1
                last = end == len(tasks) or tasks[end].read_idx != ridx
                if dedup is None:
                    dedup = DedupStream()
                chunks = dedup.push(per_window[cursor:end], final=last)
                per_window[cursor:end] = [None] * (end - cursor)
                out.extend((ridx, c, False) for c in chunks[:-1] if len(c))
                if last:
                    out.append((ridx, chunks[-1], True))
                    next_final = ridx + 1
                    dedup = None
                elif len(chunks[-1]):
                    out.append((ridx, chunks[-1], False))
                cursor = end
        return out

    levels = _levels(W)
    B = cfg.device_batch
    S = max(4 * B, 96)  # tasks per slab
    n_batches = n_windows = n_redo = depth = 0
    for s0 in range(0, len(tasks), S):
        buckets: dict[int, list[int]] = {}
        for t in range(s0, min(s0 + S, len(tasks))):
            lv = next((lv for lv in reversed(levels) if tasks[t].length <= lv), W)
            buckets.setdefault(lv, []).append(t)
        for W_b in sorted(buckets):
            order = buckets[W_b]
            s = 0
            while s < len(order):
                # the first batches of a run are small, so that the first
                # chunks, and the finishing stage's device work, start sooner
                size = RAMP[n_batches] if n_batches < len(RAMP) else B
                tidxs = order[s : s + min(size, B)]
                s += len(tidxs)
                n_batches += 1
                n_windows += len(tidxs)
                dispatch(tidxs, W_b)
                depth = max(depth, len(inflight))
                drain(every=False)
                yield from emit_ready()
    drain(every=True)
    yield from emit_ready()
    while next_final < len(reads):  # trailing reads without windows
        yield (next_final, EMPTY, True)
        next_final += 1
    logger.info("DP stream: %d batches, at most %d in flight", n_batches, depth)
    stagetimer.count("dp.batches", n_batches)
    stagetimer.count("dp.windows", n_windows)
    stagetimer.count("dp.redo", n_redo)
    stagetimer.count("host.native_fallback", 0)  # in the counter line at 0 too
    stagetimer.peak("dp.depth_max", depth)


def decompose_reads(
    reads: list[Record],
    monomers: list[Record],
    cfg: PipelineConfig = PipelineConfig(),
    device: str | torch.device = "cuda",
    forward_fn=chain_dp_forward_cuda,
    hw_fn=hw_distance_batch_cuda,
) -> list[tuple[str, list[Block]]]:
    """Raw decomposition of all reads: [(read_name, blocks)] in input order,
    blocks in global coordinates, halo-deduplicated."""
    acc: list[list[np.ndarray]] = [[] for _ in reads]
    for ridx, blocks, final in decompose_stream(reads, monomers, cfg, device, forward_fn,
                                                hw_fn=hw_fn):
        acc[ridx].append(blocks)
        if final:
            logger.info("%d%%: Aligned %s", (ridx + 1) * 100 // len(reads), reads[ridx].name)
    # every read has its final chunk, empty or not
    return [(r.name, to_blocks(np.concatenate(acc[i]))) for i, r in enumerate(reads)]


def _pump_reads(reads, monomers_dp, cfg, device, forward_fn, hw_fn, state, finisher,
                fraw, fout, falt, dp_names, min_identity) -> int:
    """DP and finishing interleaved over one read list: window chunks
    gather into a finishing group, which closes at the first chunk that
    brings it to FIN_CHUNK blocks and at a read's end; a closed group's raw
    rows are written (`fraw` is binary), the group is submitted and
    final/alt rows are written as groups complete. Returns the number of
    raw blocks written."""
    from .finishing import BlockColumns, write_final_rows
    from .report import format_raw_rows
    from .runtime.native import NameTable, format_raw_native

    # DP row -> the finisher's monomer index (a duplicated name: its last)
    fin_idx = np.array([finisher.name_to_idx[n] for n in dp_names], dtype=np.int32)
    names = NameTable(dp_names)
    n_blocks = 0
    cur_ridx = -1
    prev_end = 0
    pend: list[np.ndarray] = []
    n_pend = 0
    for ridx, blocks, final in decompose_stream(reads, monomers_dp, cfg, device,
                                                forward_fn, state, hw_fn):
        if ridx != cur_ridx:
            cur_ridx, prev_end = ridx, 0
        name = reads[ridx].name
        if len(blocks):
            pend.append(blocks)
            n_pend += len(blocks)
        if final or n_pend >= FIN_CHUNK:
            recs = np.concatenate(pend or [EMPTY])
            if len(recs):
                with stage("host.raw_rows"):
                    raw = format_raw_native(recs, name, names, prev_end)
                    if raw is None:
                        stagetimer.count("host.native_fallback")
                        raw = "".join(r + "\n" for r in format_raw_rows(
                            name, to_blocks(recs), dp_names, prev_end)).encode()
                    fraw.write(raw)
                prev_end = int(recs[-1, 2])
                n_blocks += len(recs)
            with stage("host.pend"):
                cols = BlockColumns(fin_idx[recs[:, 0]], recs[:, 1].astype(np.int64),
                                    recs[:, 2].astype(np.int64))
            # key by read INDEX: duplicate read names score their own sequence
            ready = finisher.submit(name, cols, key=ridx)
            with stage("fin.write"):
                write_final_rows(fout, falt, ready, identity_th=min_identity)
            pend, n_pend = [], 0
        if final:
            logger.info("%d%%: Aligned %s", (ridx + 1) * 100 // max(1, len(reads)), name)
    return n_blocks


def stage_fingerprint(sequences_path: str, monomers_path: str, scoring: str,
                      batch_size: int, overlap: int, ed_thr: int) -> str:
    """Hash of everything the raw DP stage depends on (the stamp beside the
    raw TSV; same form as the JAX package's)."""
    h = hashlib.sha256()
    for p in (sequences_path, monomers_path):
        with open(p, "rb") as f:
            while chunk := f.read(1 << 20):
                h.update(chunk)
        h.update(b"\x00")
    h.update(f"{scoring}|{batch_size}|{overlap}|{ed_thr}".encode())
    return h.hexdigest()


def run(
    sequences_path: str,
    monomers_path: str,
    out_dir: str = ".",
    out_file: str = "final_decomposition",
    min_identity: int = 0,
    scoring: str = "-1,-1,-1,1",
    batch_size: int = 5000,
    overlap: int = 500,
    second_best: bool = False,
    device_batch: int = 64,
    device: str | torch.device = "cuda",
    threads: int = 1,
    ed_thr: int = -1,
    resume: bool = False,
    stream_reads: int = 0,
    forward_fn=chain_dp_forward_cuda,
    identity_fn=nw_identity_batch_cuda,
    packed_fn=nw_identity_packed_both,
    hw_fn=hw_distance_batch_cuda,
) -> str:
    """Full pipeline: FASTA -> raw TSV -> rescoring -> final + alt TSVs
    (<out_file>_raw.tsv, <out_file>.tsv, <out_file>_alt.tsv in out_dir),
    byte-compatible with the reference. Returns the final TSV path.
    ed_thr > -1 turns on the per-window monomer pre-filter. `resume` reuses
    a raw TSV whose stamp matches the inputs and only rescores it;
    `stream_reads` > 0 runs reads in groups of that many (_run_streaming).
    forward_fn / identity_fn / packed_fn / hw_fn default to the kernel
    wrappers; passing the plain twins runs the plain route on the same
    device."""
    from .finishing import AsyncFinisher, finish_reads, write_final_rows
    from .io.fasta import add_rc_interleaved, add_reverse_complement, load_fasta, validate_acgtn
    from .report import parse_raw_tsv

    with stagetimer.job():
        dev = resolve_device(device)
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
        fin_kw = dict(second_best=second_best, identity_fn=identity_fn, packed_fn=packed_fn,
                      threads=threads)
        if stream_reads > 0:
            return _run_streaming(sequences_path, monomers_path, out_dir, out_file,
                                  min_identity, scoring, batch_size, overlap, device_batch, dev,
                                  ed_thr, stream_reads, forward_fn, hw_fn, fin_kw)
        with stage("run.setup"):
            reads = load_fasta(sequences_path)
            monomers_fwd = load_fasta(monomers_path)
            validate_acgtn(reads, sequences_path)
            validate_acgtn(monomers_fwd, monomers_path)
            cfg = _config(scoring, batch_size, overlap, device_batch, ed_thr)
            monomers_dp = add_reverse_complement(monomers_fwd)  # DP stage order
            monomers_fin = add_rc_interleaved(load_fasta(monomers_path, upper=True))
            raw_path, final_path, alt_path = _out_paths(out_dir, out_file)
            stamp_path = raw_path + ".stamp"
            fp = stage_fingerprint(sequences_path, monomers_path, scoring, batch_size, overlap,
                                   ed_thr)
            stamp_ok = False
            if resume and os.path.exists(raw_path) and os.path.exists(stamp_path):
                with open(stamp_path) as f:
                    stamp_ok = f.read().strip() == fp
                if not stamp_ok:
                    logger.warning("--resume: %s was produced from different inputs; "
                                   "recomputing", raw_path)
            if not stamp_ok:
                state = state_from_numpy(*numpy_state(monomers_dp, monomers_fin), dev)
                # drop any old stamp before touching the raw TSV: a crash
                # mid-write must not leave a truncated TSV beside a matching stamp
                try:
                    os.remove(stamp_path)
                except FileNotFoundError:
                    pass
                t0 = time.perf_counter()
                dp_names = [m.name for m in monomers_dp]
                # positional keys: duplicate read names each score their own sequence
                reads_by_key = {i: r.seq.upper() for i, r in enumerate(reads)}
                finisher = AsyncFinisher(reads_by_key, monomers_fin, state, dev, **fin_kw)
        if stamp_ok:
            # the raw TSV is the resumable stage boundary: finishing re-runs
            # from the parsed TSV alone, with reads keyed by name
            logger.info("Resuming from existing raw decomposition %s", raw_path)
            with open(raw_path) as f:
                per_read_raw = parse_raw_tsv(f.read())
            reads_by_name = {r.name: r.seq for r in load_fasta(sequences_path, upper=True)}
            t0 = time.perf_counter()
            finished = finish_reads(per_read_raw, reads_by_name, monomers_fin, dev, **fin_kw)
            logger.info("Rescoring stage finished in %.2fs", time.perf_counter() - t0)
            with stage("run.close"), _published(final_path, alt_path) as (fout, falt):
                write_final_rows(fout, falt, finished, identity_th=min_identity)
            logger.info("Transformation finished. Results can be found in %s", final_path)
            return final_path
        with ExitStack() as closing:
            try:
                with _published(raw_path, final_path, alt_path,
                                binary=(raw_path,)) as (fraw, fout, falt):
                    n_blocks = _pump_reads(reads, monomers_dp, cfg, dev, forward_fn, hw_fn,
                                           state, finisher, fraw, fout, falt, dp_names,
                                           min_identity)
                    # run.close: the drain, the tail's rows, the renames, the stamp
                    closing.enter_context(stage("run.close"))
                    tail = finisher.drain()
                    with stage("fin.write"):
                        write_final_rows(fout, falt, tail, identity_th=min_identity)
            finally:
                finisher.close()
            with open(stamp_path, "w") as f:
                f.write(fp + "\n")
        dt = time.perf_counter() - t0
        logger.info("Saved raw decomposition to %s (%d assignments in %.2fs, %.0f/s)",
                    raw_path, n_blocks, dt, n_blocks / dt if dt > 0 else 0.0)
        logger.info("Transformation finished. Results can be found in %s", final_path)
        return final_path


def _config(scoring: str, batch_size: int, overlap: int, device_batch: int,
            ed_thr: int) -> PipelineConfig:
    ins, dele, mm, match = (int(x) for x in scoring.split(","))
    return PipelineConfig(scoring=Scoring(ins, dele, mm, match), part_size=batch_size,
                          overlap=overlap, device_batch=device_batch, ed_thr=ed_thr)


def _out_paths(out_dir: str, out_file: str) -> tuple[str, str, str]:
    """The raw, final and alt TSV paths."""
    base = os.path.join(out_dir, out_file)
    return base + "_raw.tsv", base + ".tsv", base + "_alt.tsv"


@contextmanager
def _published(*paths: str, binary: tuple[str, ...] = ()):
    """Open each path's `.tmp` for writing (in binary mode those in
    `binary`) and, when the block completes, publish them all by rename: a
    killed run never leaves a truncated file under the real name."""
    with ExitStack() as files:
        yield tuple(files.enter_context(open(p + ".tmp", "wb" if p in binary else "w"))
                    for p in paths)
    for p in paths:
        os.replace(p + ".tmp", p)


def _run_streaming(sequences_path, monomers_path, out_dir, out_file, min_identity, scoring,
                   batch_size, overlap, device_batch, dev, ed_thr, stream_reads, forward_fn,
                   hw_fn, fin_kw) -> str:
    """Bounded-memory runner: reads go through the pipeline in groups of
    `stream_reads` (decompose_reads, then finish_reads), and the raw, final
    and alt rows are appended as each group completes, so a flowcell-scale
    FASTA never sits in memory whole. The output bytes equal the one-shot
    run's."""
    from .finishing import finish_reads, write_final_rows
    from .io.fasta import (
        add_rc_interleaved, add_reverse_complement, iter_fasta, load_fasta, validate_acgtn,
    )
    from .report import format_raw_rows

    with stage("run.setup"):
        monomers_fwd = load_fasta(monomers_path)
        validate_acgtn(monomers_fwd, monomers_path)
        monomers_dp = add_reverse_complement(monomers_fwd)
        monomers_fin = add_rc_interleaved(load_fasta(monomers_path, upper=True))
        dp_names = [m.name for m in monomers_dp]
        cfg = _config(scoring, batch_size, overlap, device_batch, ed_thr)
    t0 = time.perf_counter()
    n_blocks = n_reads = 0
    with ExitStack() as closing, _published(*_out_paths(out_dir, out_file)) as (fraw, fout, falt):
        group: list[Record] = []

        def flush_group() -> None:
            nonlocal n_blocks, n_reads
            if not group:
                return
            validate_acgtn(group, sequences_path)
            result = decompose_reads(group, monomers_dp, cfg, dev, forward_fn, hw_fn)
            per_read_raw = []
            for gi, (rname, blocks) in enumerate(result):
                rows = format_raw_rows(rname, blocks, dp_names)
                if rows:
                    fraw.write("\n".join(rows) + "\n")
                # positional key: duplicate names stay distinct. Names are
                # the header's first word already, or "" for a blank header
                per_read_raw.append((rname, [
                    {"m": dp_names[b.monomer], "start": b.start, "end": b.end}
                    for b in blocks], gi))
                n_blocks += len(blocks)
            finished = finish_reads(per_read_raw, {gi: r.seq for gi, r in enumerate(group)},
                                    monomers_fin, dev, **fin_kw)
            write_final_rows(fout, falt, finished, identity_th=min_identity)
            n_reads += len(group)
            logger.info("streamed %d reads (%d assignments)", n_reads, n_blocks)
            group.clear()

        for rec in iter_fasta(sequences_path):
            group.append(rec)
            if len(group) >= stream_reads:
                flush_group()
        flush_group()
        closing.enter_context(stage("run.close"))  # the renames
    logger.info("Streaming run finished: %d reads, %d assignments in %.2fs",
                n_reads, n_blocks, time.perf_counter() - t0)
    final_path = _out_paths(out_dir, out_file)[1]
    logger.info("Transformation finished. Results can be found in %s", final_path)
    return final_path


def precompile_menu(
    monomers_path: str,
    device_batch: int = 64,
    batch_size: int = 5000,
    overlap: int = 500,
    second_best: bool = True,
    scoring: str = "-1,-1,-1,1",
    threads: int = 1,
    device: str | torch.device = "cuda",
) -> None:
    """Serve-mode warm-up: one synthetic job for this monomer set through
    every window-width level (W, W/2, ... >= 512) and batch size (24, 48,
    device_batch) the pipeline routes to. The port has no compile keys;
    what the job warms is the kernel library's first build and load, the
    CUDA context, the cluster-occupancy queries and the first launch of each
    K1 body and K2 entry this monomer set takes, so that the first real job
    pays none of them. The synthetic reads are concatenated monomers, so
    the finishing stage sees blocks of this set's lengths."""
    import itertools
    import tempfile

    from .io.fasta import load_fasta

    units = itertools.cycle(m.seq for m in load_fasta(monomers_path))

    def synth(n: int) -> str:
        parts: list[str] = []
        got = 0
        while got < n:
            parts.append(next(units))
            got += len(parts[-1])
        return "".join(parts)[:n]

    levels = _levels(batch_size + overlap)
    # one full-width read a batch size, one short read a narrower level
    reads = [(f"warm_full_{i}", synth(n_win * batch_size))
             for i, n_win in enumerate(sorted({*RAMP, device_batch}))]
    reads += [(f"warm_lv{i}", synth(max(1, lv - 8))) for i, lv in enumerate(levels[1:])]
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "warm.fa")
        with open(fa, "w") as f:
            for name, seq in reads:
                f.write(f">{name}\n{seq}\n")
        logger.info("precompile: warming %d synthetic reads", len(reads))
        t0 = time.perf_counter()
        run(fa, monomers_path, out_dir=os.path.join(td, "out"), scoring=scoring,
            batch_size=batch_size, overlap=overlap, second_best=second_best,
            device_batch=device_batch, device=device, threads=threads)
        logger.info("precompile: menu warm in %.1fs", time.perf_counter() - t0)
