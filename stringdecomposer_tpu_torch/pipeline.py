"""End-to-end decomposition pipeline, ported from stringdecomposer_tpu/pipeline.py.

Stages:
  1. FASTA load + validation + RC monomer doubling    (io/fasta.py)
  2. halo windowing of every read                      (ops/oracle.make_windows)
  3. with --ed_thr: per-window monomer pre-filter      (ops/hw_filter_cuda.py, K3)
     batched chain DP + block walk on the device       (ops/chain_dp_cuda.py, K1)
  4. host replay of block records, merge to global coordinates, halo dedup
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
from dataclasses import dataclass, field

import torch

from .convert import DeviceState, numpy_state, state_from_numpy
from .io.fasta import Record, encode
from .ops.chain_dp import build_window_batch
from .ops.chain_dp_cuda import chain_dp_forward_cuda
from .ops.hw_filter import filter_monomers_device
from .ops.hw_filter_cuda import hw_distance_batch_cuda
from .ops.identity_cuda import nw_identity_batch_cuda, nw_identity_packed_both
from .ops.oracle import Block, PostprocessStream, Scoring, make_windows
from .ops.traceback import blocks_from_device
from .utils.stagetimer import stage

logger = logging.getLogger("SD-TPU")

# pending blocks of one read that make a finishing group without waiting
# for the read's last window
FIN_CHUNK = 4096


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

    Yields (read_idx, blocks, final): `blocks` are postprocessed blocks in
    global coordinates that will not change (the halo-dedup lookahead is
    carried in a PostprocessStream); `final` marks a read's last chunk.
    Every read yields exactly one final chunk (possibly empty), in input
    order. Windows are bucketed by width within slabs of consecutive tasks,
    so emission tracks input order."""
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

    def run_batch(tidxs: list[int], W_b: int) -> None:
        with stage("dp.prep"):
            wins = [read_codes[tasks[t].read_idx][tasks[t].offset : tasks[t].offset + tasks[t].length]
                    for t in tidxs]
            wbatch, wlens = build_window_batch(wins, W_b)
            wb = torch.from_numpy(wbatch).to(dev)
            wl = torch.from_numpy(wlens).to(dev)
        perm_np = None
        fwd_mono, fwd_lens = mono, mono_lens
        if cfg.ed_thr > -1:
            # per-window monomer subset in (distance, index) order: both
            # decide the DP's ties. Rows past a window's kept count have
            # length 0 (end score NEG, never picked), so K1 runs only the
            # first max(kept) rows of the per-window set.
            with stage("dp.filter"):
                dist = hw_fn(wb, wl, mono, mono_lens)
                mono_w, lens_w, perm = filter_monomers_device(dist, mono, mono_lens, cfg.ed_thr)
                n_keep = (dist <= cfg.ed_thr).sum(dim=1).clamp(min=1)
                perm_np = perm.cpu().numpy()
                m_eff = int(n_keep.max())
                fwd_mono = mono_w[:, :m_eff].contiguous()
                fwd_lens = lens_w[:, :m_eff].contiguous()
        # cap the block records brought back: real windows hold ~W/170
        # blocks; an overflow is detected below and recomputed uncapped
        cap = min(W_b, max(256, W_b // 8))
        with stage("dp.dispatch"):
            blocks, counts = forward_fn(wb, wl, fwd_mono, fwd_lens, max_blocks=cap, **kw)
        with stage("dp.gather"):
            blocks_np, counts_np = blocks.cpu().numpy(), counts.cpu().numpy()
            if counts_np.max() > blocks_np.shape[1]:
                blocks, counts = forward_fn(wb, wl, fwd_mono, fwd_lens, **kw)
                blocks_np, counts_np = blocks.cpu().numpy(), counts.cpu().numpy()
        with stage("dp.replay"):
            for b, t in enumerate(tidxs):
                per_window[t] = blocks_from_device(blocks_np[b], int(counts_np[b]))
                if perm_np is not None:  # filtered DP row -> input monomer index
                    for blk in per_window[t]:
                        blk.monomer = int(perm_np[b][blk.monomer])
                done[t] = True

    cursor = 0
    pp: PostprocessStream | None = None
    next_final = 0

    def emit_ready() -> list[tuple[int, list[Block], bool]]:
        nonlocal cursor, pp, next_final
        out: list[tuple[int, list[Block], bool]] = []
        with stage("dp.postprocess"):
            while cursor < len(tasks) and done[cursor]:
                t = tasks[cursor]
                while next_final < t.read_idx:  # reads without windows
                    out.append((next_final, [], True))
                    next_final += 1
                if pp is None:
                    pp = PostprocessStream()
                shifted = [Block(b.monomer, b.start + t.offset, b.end + t.offset, b.identity)
                           for b in per_window[cursor]]
                per_window[cursor] = None
                ready = pp.push(shifted)
                if cursor + 1 == len(tasks) or tasks[cursor + 1].read_idx != t.read_idx:
                    out.append((t.read_idx, ready + pp.finish(), True))
                    next_final = t.read_idx + 1
                    pp = None
                elif ready:
                    out.append((t.read_idx, ready, False))
                cursor += 1
        return out

    levels = _levels(W)
    B = cfg.device_batch
    S = max(4 * B, 96)  # tasks per slab
    for s0 in range(0, len(tasks), S):
        buckets: dict[int, list[int]] = {}
        for t in range(s0, min(s0 + S, len(tasks))):
            lv = next((lv for lv in reversed(levels) if tasks[t].length <= lv), W)
            buckets.setdefault(lv, []).append(t)
        for W_b in sorted(buckets):
            order = buckets[W_b]
            for s in range(0, len(order), B):
                run_batch(order[s : s + B], W_b)
                yield from emit_ready()
    yield from emit_ready()
    while next_final < len(reads):  # trailing reads without windows
        yield (next_final, [], True)
        next_final += 1


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
    acc: list[list[Block]] = [[] for _ in reads]
    for ridx, blocks, final in decompose_stream(reads, monomers, cfg, device, forward_fn,
                                                hw_fn=hw_fn):
        acc[ridx].extend(blocks)
        if final:
            logger.info("%d%%: Aligned %s", (ridx + 1) * 100 // len(reads), reads[ridx].name)
    return [(r.name, acc[i]) for i, r in enumerate(reads)]


def _pump_reads(reads, monomers_dp, cfg, device, forward_fn, hw_fn, state, finisher,
                fraw, fout, falt, dp_names, min_identity) -> int:
    """DP and finishing interleaved over one read list: raw rows stream out
    as window chunks finalize, finishing groups are submitted as they fill
    and final/alt rows are written as groups complete. Returns the number of
    raw blocks written."""
    from .finishing import write_final_rows
    from .report import format_raw_rows

    n_blocks = 0
    cur_ridx = -1
    prev_end = 0
    pend: list[dict] = []
    for ridx, blocks, final in decompose_stream(reads, monomers_dp, cfg, device,
                                                forward_fn, state, hw_fn):
        if ridx != cur_ridx:
            cur_ridx, prev_end = ridx, 0
        name = reads[ridx].name
        if blocks:
            with stage("host.raw_rows"):
                rows = format_raw_rows(name, blocks, dp_names, prev_end=prev_end)
                fraw.write("\n".join(rows) + "\n")
            prev_end = blocks[-1].end
            n_blocks += len(blocks)
            with stage("host.pend"):
                pend.extend({"m": dp_names[b.monomer].split()[0], "start": b.start, "end": b.end}
                            for b in blocks)
        if final or len(pend) >= FIN_CHUNK:
            # key by read INDEX: duplicate read names score their own sequence
            ready = finisher.submit(name, pend, key=ridx)
            with stage("fin.write"):
                write_final_rows(fout, falt, ready, identity_th=min_identity)
            pend = []
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
    forward_fn=chain_dp_forward_cuda,
    identity_fn=nw_identity_batch_cuda,
    packed_fn=nw_identity_packed_both,
    hw_fn=hw_distance_batch_cuda,
) -> str:
    """Full pipeline: FASTA -> raw TSV -> rescoring -> final + alt TSVs
    (<out_file>_raw.tsv, <out_file>.tsv, <out_file>_alt.tsv in out_dir),
    byte-compatible with the reference. Returns the final TSV path.
    ed_thr > -1 turns on the per-window monomer pre-filter. forward_fn /
    identity_fn / packed_fn / hw_fn default to the kernel wrappers; passing
    the plain twins runs the plain route on the same device."""
    from .finishing import AsyncFinisher, write_final_rows
    from .io.fasta import add_rc_interleaved, add_reverse_complement, load_fasta, validate_acgtn

    dev = resolve_device(device)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    reads = load_fasta(sequences_path)
    monomers_fwd = load_fasta(monomers_path)
    validate_acgtn(reads, sequences_path)
    validate_acgtn(monomers_fwd, monomers_path)
    ins, dele, mm, match = (int(x) for x in scoring.split(","))
    cfg = PipelineConfig(scoring=Scoring(ins, dele, mm, match), part_size=batch_size,
                         overlap=overlap, device_batch=device_batch, ed_thr=ed_thr)
    monomers_dp = add_reverse_complement(monomers_fwd)  # DP stage order
    monomers_fin = add_rc_interleaved(load_fasta(monomers_path, upper=True))
    state = state_from_numpy(*numpy_state(monomers_dp, monomers_fin), dev)
    raw_path = os.path.join(out_dir, out_file + "_raw.tsv")
    final_path = os.path.join(out_dir, out_file + ".tsv")
    alt_path = os.path.join(out_dir, out_file + "_alt.tsv")
    stamp_path = raw_path + ".stamp"
    fp = stage_fingerprint(sequences_path, monomers_path, scoring, batch_size, overlap, ed_thr)
    # drop any old stamp before touching the raw TSV: a crash mid-write must
    # not leave a truncated TSV beside a matching stamp
    try:
        os.remove(stamp_path)
    except FileNotFoundError:
        pass
    t0 = time.perf_counter()
    dp_names = [m.name for m in monomers_dp]
    # positional keys: duplicate read names each score their own sequence
    reads_by_key = {i: r.seq.upper() for i, r in enumerate(reads)}
    finisher = AsyncFinisher(reads_by_key, monomers_fin, state, dev, second_best=second_best,
                             identity_fn=identity_fn, packed_fn=packed_fn, threads=threads)
    # outputs build under .tmp and publish by rename: a killed run never
    # leaves a truncated file under the real name
    try:
        with open(raw_path + ".tmp", "w") as fraw, \
                open(final_path + ".tmp", "w") as fout, \
                open(alt_path + ".tmp", "w") as falt:
            n_blocks = _pump_reads(reads, monomers_dp, cfg, dev, forward_fn, hw_fn, state,
                                   finisher, fraw, fout, falt, dp_names, min_identity)
            tail = finisher.drain()
            with stage("fin.write"):
                write_final_rows(fout, falt, tail, identity_th=min_identity)
    finally:
        finisher.close()
    os.replace(raw_path + ".tmp", raw_path)
    os.replace(final_path + ".tmp", final_path)
    os.replace(alt_path + ".tmp", alt_path)
    with open(stamp_path, "w") as f:
        f.write(fp + "\n")
    dt = time.perf_counter() - t0
    logger.info("Saved raw decomposition to %s (%d assignments in %.2fs, %.0f/s)",
                raw_path, n_blocks, dt, n_blocks / dt if dt > 0 else 0.0)
    logger.info("Transformation finished. Results can be found in %s", final_path)
    return final_path
