"""Multi-host execution: per-host read sharding + deterministic TSV merge,
ported from stringdecomposer_tpu/parallel/multihost.py.

The reference is single-node (SURVEY.md §2: OpenMP threads + one fork/exec,
no network communication). The scale-out model replaces that with:

  - `torch.distributed` for process topology only (parallel/mesh.py);
  - reads sharded across hosts round-robin by input index: the network
    carries only the rendezvous, never DP traffic (windows are independent
    by construction of the halo chunking scheme, src/main.cpp:73-75);
  - each host runs the ordinary single-host pipeline on its own devices
    (data-parallel window sharding within the host via parallel/sharding.py)
    and writes a raw-TSV *fragment*, final and alt fragments and one `.done`
    sentinel: the fragments are a per-host checkpoint, so a failed run
    resumes per host;
  - host 0 merges fragments by global read index, reproducing the
    reference's order-restoring sort (src/main.cpp:103-120) across hosts:
    output bytes are identical to a single-host run for any host count.

No collective rides the output path; the merge is pure filesystem, so the
same code runs under `torch.distributed` across machines or as plain
processes (on one GPU, or in tests on the CPU).
"""

from __future__ import annotations

import logging
import os
import pathlib
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger("SD-TPU")


@dataclass
class HostTopology:
    num_hosts: int = 1
    host_id: int = 0


def detect_topology() -> HostTopology:
    """Topology from an initialized torch.distributed process group (1 host
    if there is none)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return HostTopology()
    return HostTopology(num_hosts=dist.get_world_size(), host_id=dist.get_rank())


def shard_indices(n_reads: int, topo: HostTopology) -> list[int]:
    """Global read indices owned by this host (round-robin by input index,
    the multi-host analog of the reference's chunk interleaving)."""
    return list(range(topo.host_id, n_reads, topo.num_hosts))


def fragment_path(out_dir: str, out_file: str, host_id: int) -> str:
    return os.path.join(out_dir, f"{out_file}_raw.shard{host_id:05d}.tsv")


def final_fragment_path(out_dir: str, out_file: str, host_id: int) -> str:
    return os.path.join(out_dir, f"{out_file}.shard{host_id:05d}.tsv")


def alt_fragment_path(out_dir: str, out_file: str, host_id: int) -> str:
    return os.path.join(out_dir, f"{out_file}_alt.shard{host_id:05d}.tsv")


def _sentinel(frag: str) -> str:
    return frag + ".done"


def _sentinel_matches(path: str, fingerprint: str) -> bool:
    """True iff the sentinel exists and was written for `fingerprint`.

    Checking content (not mere existence) means a stale sentinel from a
    previous run with different inputs, or one mid-rewrite by another
    host, never admits its fragment into the merge."""
    try:
        with open(path) as f:
            return f.read().strip() == fingerprint
    except OSError:
        return False


_HEARTBEAT_PERIOD = 10.0


def _heartbeat(frag: str) -> str:
    return frag + ".alive"


class _HeartbeatThread:
    """Touches the host's `.alive` file every few seconds while its shard
    is computed, so host 0 can tell 'still computing' from 'dead'. (A
    fragment file is only written at the shard's end, so its size carries
    no liveness signal during compute.)"""

    def __init__(self, frag: str, period: float = _HEARTBEAT_PERIOD):
        import threading

        self._path = _heartbeat(frag)
        self._period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                with open(self._path, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass
            self._stop.wait(self._period)

    def __enter__(self) -> "_HeartbeatThread":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # a left-behind .alive from a finished run would bypass the
        # "never-heartbeated -> grace from wait start" fallback on the NEXT
        # run into the same out_dir and get a healthy host declared dead
        try:
            os.remove(self._path)
        except OSError:
            pass


def _wait_for(
    paths: list[str],
    fingerprint: str,
    timeout: float = 3600.0,
    poll: float = 0.2,
    liveness_grace: float = 120.0,
    salvage: bool = False,
) -> list[str]:
    """Block until every sentinel exists with the current fingerprint.

    Dead-host detection: a host whose sentinel is missing AND whose
    heartbeat file has not been touched for `liveness_grace` seconds is
    declared dead. With salvage=False host 0 fails fast with a message
    naming it (instead of silently burning the whole `timeout`); with
    salvage=True the stalled sentinel paths are RETURNED so the caller can
    recompute those shards itself. A host that never wrote a heartbeat
    gets the same grace measured from when the wait began (covers
    start-up and kernel-build skew)."""
    start_wall = time.time()
    deadline = time.monotonic() + timeout
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not _sentinel_matches(p, fingerprint)]
        if not missing:
            return []
        now_wall = time.time()
        stalled = []
        for p in missing:
            hb = _heartbeat(p[: -len(".done")])
            try:
                last = os.path.getmtime(hb)
            except OSError:
                last = start_wall
            if now_wall - last > liveness_grace:
                stalled.append(p)
        if stalled:
            if salvage:
                return stalled
            hosts = ", ".join(
                p.rsplit(".shard", 1)[1].split(".")[0].lstrip("0") or "0"
                for p in stalled
            )
            raise RuntimeError(
                f"host(s) {hosts} appear dead: no heartbeat for "
                f"{liveness_grace:.0f}s (sentinels still missing: {stalled}). "
                "Re-run with --resume to recompute only the missing fragments."
            )
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for host fragments: {missing}")
        time.sleep(poll)
    return []


def _merge_by_counts(
    dest: str, frags: list[str], counts: list[list[int]], topo: HostTopology,
    n_reads: int,
) -> str:
    """Interleave per-host fragments back into global read order.

    Each fragment holds its host's reads in ascending global index (the
    single-host pipeline preserves input order), so the merge is one
    sequential pass per fragment: the cross-host version of the
    reference's index re-sort (src/main.cpp:103-120). The pass streams:
    one open file handle per host, rows copied line by line, so merge
    memory is O(num_hosts), flat in the input size (a centromere
    assembly's TSV can be many GB)."""
    handles = []
    try:
        handles = [open(f) for f in frags]
        cursors = [0] * topo.num_hosts
        with open(dest + ".tmp", "w") as out:
            for gi in range(n_reads):
                h = gi % topo.num_hosts
                for _ in range(counts[h][cursors[h]]):
                    out.write(handles[h].readline())
                cursors[h] += 1
    finally:
        for fh in handles:
            fh.close()
    os.replace(dest + ".tmp", dest)
    return dest


def merge_raw_fragments(
    out_dir: str, out_file: str, topo: HostTopology, n_reads: int
) -> str:
    # the sidecar written next to each fragment records exact per-read row
    # counts, so zero-block reads and duplicate read names merge unambiguously
    counts: list[list[int]] = []
    for h in range(topo.num_hosts):
        frag = fragment_path(out_dir, out_file, h)
        with open(frag + ".reads") as f:
            counts.append(
                [int(ln.rsplit("\t", 1)[1]) for ln in f.read().split("\n")[:-1]]
            )
    return _merge_by_counts(
        os.path.join(out_dir, out_file + "_raw.tsv"),
        [fragment_path(out_dir, out_file, h) for h in range(topo.num_hosts)],
        counts, topo, n_reads,
    )


def merge_final_fragments(
    out_dir: str, out_file: str, topo: HostTopology, n_reads: int
) -> str:
    """Merge the per-host FINAL and ALT fragments (each host finishes its
    own shard; the reference finishes everything in one process,
    main.py:124-142). Counts sidecar: read \\t final_rows \\t alt_rows."""
    fin_counts: list[list[int]] = []
    alt_counts: list[list[int]] = []
    for h in range(topo.num_hosts):
        ffrag = final_fragment_path(out_dir, out_file, h)
        with open(ffrag + ".reads") as f:
            rows = [ln.split("\t") for ln in f.read().split("\n")[:-1]]
        fin_counts.append([int(r[1]) for r in rows])
        alt_counts.append([int(r[2]) for r in rows])
    _merge_by_counts(
        os.path.join(out_dir, out_file + "_alt.tsv"),
        [alt_fragment_path(out_dir, out_file, h) for h in range(topo.num_hosts)],
        alt_counts, topo, n_reads,
    )
    return _merge_by_counts(
        os.path.join(out_dir, out_file + ".tsv"),
        [final_fragment_path(out_dir, out_file, h) for h in range(topo.num_hosts)],
        fin_counts, topo, n_reads,
    )


def _row_counts(rows, min_identity: int) -> tuple[int, int]:
    """A finished read's final and alt row counts under -i, as
    finishing.write_final_rows writes them: a final row for each block
    scoring >= min_identity, and one alt row a distinct monomer name for
    each of those blocks (none in light mode)."""
    kept = int(np.count_nonzero(np.asarray(rows.score) >= min_identity))
    return kept, kept * (len(rows.uniq_names) if rows.alt is not None else 0)


@contextmanager
def _hosts(topology, coordinator, num_processes, process_id):
    """The hosts' topology: with `coordinator`, from a torch.distributed
    group brought up there and left again on the way out, whatever
    happens; else `topology`, or one host."""
    from .mesh import initialize_distributed, shutdown_distributed

    if coordinator is None:
        yield topology or HostTopology()
        return
    try:
        initialize_distributed(coordinator, num_processes, process_id)
        topo = detect_topology()
        if (num_processes or 1) > 1 and topo.num_hosts == 1:
            # a runtime that cannot aggregate the processes still gave a
            # working rendezvous; fall back to the explicit topology so
            # hosts never race on the same fragment
            logger.warning(
                "torch.distributed reports a single process; using explicit "
                "topology %s/%s", process_id, num_processes,
            )
            topo = HostTopology(num_processes, process_id or 0)
        yield topo
    finally:
        shutdown_distributed()


def run_multihost(
    sequences_path: str,
    monomers_path: str,
    out_dir: str = ".",
    out_file: str = "final_decomposition",
    min_identity: int = 0,
    scoring: str = "-1,-1,-1,1",
    batch_size: int = 5000,
    overlap: int = 500,
    second_best: bool = False,
    ed_thr: int = -1,
    device_batch: int = 16,
    topology: HostTopology | None = None,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    resume: bool = False,
    data_parallel: bool = False,
    barrier_timeout: float = 3600.0,
    liveness_grace: float = 120.0,
    salvage_dead_hosts: bool = True,
    stream_reads: int = 0,
    threads: int = 1,
    device: str = "cuda",
) -> str | None:
    """Full pipeline across hosts. Returns the final TSV path on host 0,
    None on other hosts.

    If `coordinator` is given, torch.distributed is initialized (and left
    again on the way out, whatever happens) and the topology is taken from
    it; otherwise `topology` (or single-host) is used, which lets plain
    processes cooperate through the shared out_dir. With `resume=True` a
    host whose fragment sentinel already matches its inputs skips its DP
    and finishing stages entirely (per-host checkpoint/restart).

    With `stream_reads > 0` each host streams the FASTA (iter_fasta),
    retaining only the reads it owns in groups of that size: memory stays
    flat in the input size on every host, and output bytes are unchanged.
    `device` is where each host computes ("cuda": its GPUs, all of them
    under `data_parallel`; "cpu": the plain twins)."""
    from ..finishing import finish_reads, write_final_rows
    from ..io.fasta import (
        add_rc_interleaved, add_reverse_complement, iter_fasta, load_fasta, validate_acgtn,
    )
    from ..pipeline import _config, decompose_reads, resolve_device, stage_fingerprint
    from ..report import format_raw_rows

    with _hosts(topology, coordinator, num_processes, process_id) as topo:
        dev = resolve_device(device)
        dp_kw: dict = {}
        fin_kw: dict = {}
        if data_parallel:
            # AFTER the torch.distributed bring-up, as in the JAX package
            from .mesh import get_devices
            from .sharding import make_sharded_forward, make_sharded_identity, make_sharded_packed

            devices = get_devices(device)
            dp_kw = dict(forward_fn=make_sharded_forward(devices))
            fin_kw = dict(identity_fn=make_sharded_identity(devices),
                          packed_fn=make_sharded_packed(devices))
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)

        monomers_fwd = load_fasta(monomers_path)
        validate_acgtn(monomers_fwd, monomers_path)
        n_reads = -1  # total input reads; host 0 needs it for the merges
        if stream_reads > 0:
            reads = None  # never materialized; shards stream via iter_fasta
        else:
            reads = load_fasta(sequences_path)
            validate_acgtn(reads, sequences_path)
            n_reads = len(reads)
        monomers_dp = add_reverse_complement(monomers_fwd)

        fp = stage_fingerprint(sequences_path, monomers_path, scoring, batch_size, overlap, ed_thr)
        # the sentinel covers the host's raw AND final/alt fragments, so the
        # fingerprint must also pin the finishing-stage parameters
        fp += f"|fin:{int(second_best)}:{min_identity}"
        frag = fragment_path(out_dir, out_file, topo.host_id)
        resumable = False
        if resume and os.path.exists(_sentinel(frag)):
            with open(_sentinel(frag)) as f:
                resumable = f.read().strip() == fp
            if not resumable:
                logger.warning(
                    "--resume: host %d fragment was produced from different "
                    "inputs; recomputing", topo.host_id,
                )
        cfg = _config(scoring, batch_size, overlap, device_batch, ed_thr)
        monomers_fin = add_rc_interleaved(load_fasta(monomers_path, upper=True))
        dp_names = [m.name for m in monomers_dp]

        def compute_shard(host_id: int) -> None:
            """DP stage + finishing for one host's read shard -> raw fragment +
            final/alt fragments + sidecars + one sentinel covering all of them
            (atomic renames). Every host rescoring its own shard is the
            multi-host analog of the single-process finishing loop (reference
            main.py:124-142). Deterministic: recomputing a shard on a DIFFERENT
            machine (dead-host salvage) yields byte-identical files, so even a
            concurrent late write by the presumed-dead host is harmless.

            With stream_reads > 0 the shard streams through in bounded groups
            (only owned reads are ever retained) and rows append incrementally
            to the .tmp files; the atomic rename contract is unchanged."""
            nonlocal n_reads
            fragh = fragment_path(out_dir, out_file, host_id)
            ffrag = final_fragment_path(out_dir, out_file, host_id)
            afrag = alt_fragment_path(out_dir, out_file, host_id)
            # drop any stale sentinel/fragments/heartbeat BEFORE recomputing:
            # host 0 must never observe an old-fingerprint sentinel next to a
            # mid-rewrite fragment (silently-wrong-merge race on rerun into a
            # reused out_dir)
            for stale in (_sentinel(fragh), fragh, fragh + ".reads", ffrag,
                          ffrag + ".reads", afrag, _heartbeat(fragh)):
                try:
                    os.remove(stale)
                except OSError:
                    pass

            def flush_group(group, fr, frc, fo, fa, foc) -> None:
                """One group: DP + raw rows/sidecar + finishing rows/sidecar."""
                validate_acgtn(group, sequences_path)
                result = decompose_reads(group, monomers_dp, cfg, dev, **dp_kw)
                per_read_raw = []
                for gi, (rname, blocks) in enumerate(result):
                    for row in format_raw_rows(rname, blocks, dp_names):
                        fr.write(row + "\n")
                    frc.write(f"{rname}\t{len(blocks)}\n")
                    # positional key: duplicate names stay distinct
                    per_read_raw.append((rname, [
                        {"m": dp_names[b.monomer], "start": b.start, "end": b.end}
                        for b in blocks], gi))
                seqs = {gi: r.seq.upper() for gi, r in enumerate(group)}
                finished = finish_reads(per_read_raw, seqs, monomers_fin, dev,
                                        second_best=second_best, threads=threads, **fin_kw)
                write_final_rows(fo, fa, finished, identity_th=min_identity)
                for rname, rows in finished:
                    nf, na = _row_counts(rows, min_identity)
                    foc.write(f"{rname}\t{nf}\t{na}\n")

            with _HeartbeatThread(fragh):
                # write-then-rename so a crash mid-write never leaves a truncated
                # fragment that a later merge or --resume could mistake for complete
                with open(fragh + ".tmp", "w") as fr, \
                        open(fragh + ".reads.tmp", "w") as frc, \
                        open(ffrag + ".tmp", "w") as fo, \
                        open(afrag + ".tmp", "w") as fa, \
                        open(ffrag + ".reads.tmp", "w") as foc:
                    if stream_reads > 0:
                        group: list = []
                        seen = 0
                        for gi, rec in enumerate(iter_fasta(sequences_path)):
                            seen = gi + 1
                            if gi % topo.num_hosts != host_id:
                                continue  # non-owned reads are never retained
                            group.append(rec)
                            if len(group) >= stream_reads:
                                flush_group(group, fr, frc, fo, fa, foc)
                                group = []
                        if group:
                            flush_group(group, fr, frc, fo, fa, foc)
                        n_reads = seen
                    else:
                        mine = shard_indices(n_reads, HostTopology(topo.num_hosts, host_id))
                        local = [reads[i] for i in mine]
                        logger.info(
                            "host %d/%d: decomposing %d of %d reads",
                            host_id, topo.num_hosts, len(local), n_reads,
                        )
                        flush_group(local, fr, frc, fo, fa, foc)
                os.replace(fragh + ".tmp", fragh)
                os.replace(fragh + ".reads.tmp", fragh + ".reads")
                os.replace(ffrag + ".tmp", ffrag)
                os.replace(afrag + ".tmp", afrag)
                os.replace(ffrag + ".reads.tmp", ffrag + ".reads")
                with open(_sentinel(fragh) + ".tmp", "w") as f:
                    f.write(fp + "\n")
                os.replace(_sentinel(fragh) + ".tmp", _sentinel(fragh))

        if not resumable:
            compute_shard(topo.host_id)
        else:
            logger.info("host %d: fragment exists, resuming past DP stage", topo.host_id)

        if topo.host_id != 0:
            return None

        # host 0: wait for every fragment; salvage shards of hosts that died
        # (missing sentinel + stale heartbeat) by recomputing them locally.
        # _wait_for returns the DEAD subset as soon as any host is declared
        # dead, even while other hosts are still computing, so after each
        # salvage the wait is entered again until EVERY sentinel matches:
        # merging earlier would open() fragments of still-live hosts that do
        # not exist yet. One shared deadline bounds the whole loop.
        sentinels = [
            _sentinel(fragment_path(out_dir, out_file, h)) for h in range(topo.num_hosts)
        ]
        deadline = time.monotonic() + barrier_timeout
        while True:
            stalled = _wait_for(
                sentinels,
                fp,
                timeout=max(1.0, deadline - time.monotonic()),
                liveness_grace=liveness_grace,
                salvage=salvage_dead_hosts,
            )
            if not stalled:
                break
            dead = sorted(
                int(p.rsplit(".shard", 1)[1].split(".")[0]) for p in stalled
            )
            logger.warning(
                "host(s) %s appear dead (no heartbeat for %.0fs); host 0 is "
                "salvaging their shards locally", dead, liveness_grace,
            )
            for h in dead:
                compute_shard(h)
        if n_reads < 0:
            # streaming host 0 resumed past its own compute: one cheap counting
            # pass (headers only are retained) establishes the merge length
            n_reads = sum(1 for _ in iter_fasta(sequences_path))
        raw_path = merge_raw_fragments(out_dir, out_file, topo, n_reads)
        logger.info("Saved merged raw decomposition to %s", raw_path)
        # final/alt rows were produced per host alongside each shard's DP; the
        # merge is the same streaming count-guided interleave as the raw one
        final_path = merge_final_fragments(out_dir, out_file, topo, n_reads)
        logger.info("Transformation finished. Results can be found in %s", final_path)
        return final_path
