"""Rescoring / finishing stage, ported from stringdecomposer_tpu/finishing.py.

Every (block, monomer, variant) pair is scored by one batched kernel (K2,
ops/identity_cuda.py); the per-block logic (second-best selection,
homopolymer ranking, reliability flag, formatting) runs on the host with
the reference's ordering semantics (main.py:107-165):

  - the monomer order of this stage is the INTERLEAVED RC order of the
    reference Python loader (main.py:79-84), unlike the DP stage's order;
  - second-best: first strict improvement wins (main.py:131-135);
  - homopolymer ranking: stable sort on -score (main.py:142);
  - identity float op order (m/L)*100 and "{:.2f}" formatting (main.py:59,157).

`--second-best` takes one route on every device: the packed one, where
the read's codes stay resident on the device and block extraction,
homopolymer collapse and the cross product run there too.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from stringdecomposer_tpu.io.fasta import Record, encode
from stringdecomposer_tpu.models.reliability import classify
from stringdecomposer_tpu.utils.stagetimer import stage

from .convert import DeviceState, numpy_state, pad_codes, state_from_numpy
from .ops.identity_cuda import nw_identity_batch_cuda, nw_identity_packed_both

# blocks (packed route) or pairs (light mode) per K2 call
K2_CHUNK = 4096


def homo_compress(seq: str) -> str:
    """Collapse homopolymer runs (main.py:87-92)."""
    if not seq:
        return seq
    arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    keep = np.concatenate([[True], arr[1:] != arr[:-1]])
    return arr[keep].tobytes().decode()


@dataclass
class FinishedBlock:
    monomer_name: str
    start: int
    end: int
    score: float
    second_best: str
    second_best_score: float
    homo_best: str
    homo_best_score: float
    homo_second_best: str
    homo_second_best_score: float
    alt: dict  # name -> score (empty in light mode)
    reliable: bool


class Rows:
    """Array-backed finished blocks for one read chunk, emitted by the
    native formatter without per-block Python objects; iteration and
    indexing materialize FinishedBlock instances.

    Name columns are indices: best/homo into `names` (the full interleaved
    monomer order), second-best and the alt matrix into `uniq_names`
    (first-occurrence unique names — the reference collapses scores into a
    name-keyed dict, main.py:123-126). -1 encodes "None".
    """

    __slots__ = ("names", "uniq_names", "best_idx", "best_upos", "starts",
                 "ends", "score", "sb_idx", "sb_score", "hb_idx", "hb_score",
                 "hs_idx", "hs_score", "reliable", "alt")

    def __init__(self, names, uniq_names, best_idx, best_upos, starts, ends,
                 score, sb_idx, sb_score, hb_idx, hb_score, hs_idx, hs_score,
                 reliable, alt):
        self.names = names
        self.uniq_names = uniq_names
        self.best_idx = best_idx
        self.best_upos = best_upos
        self.starts = starts
        self.ends = ends
        self.score = score
        self.sb_idx = sb_idx
        self.sb_score = sb_score
        self.hb_idx = hb_idx
        self.hb_score = hb_score
        self.hs_idx = hs_idx
        self.hs_score = hs_score
        self.reliable = reliable
        self.alt = alt  # [n, U] float64 or None (light mode)

    def __len__(self) -> int:
        return len(self.starts)

    def _name(self, table, idx: int) -> str:
        return "None" if idx < 0 else table[idx]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        alt = (dict(zip(self.uniq_names, self.alt[i].tolist()))
               if self.alt is not None else {})
        return FinishedBlock(
            self._name(self.names, int(self.best_idx[i])),
            int(self.starts[i]), int(self.ends[i]), float(self.score[i]),
            self._name(self.uniq_names, int(self.sb_idx[i])),
            float(self.sb_score[i]),
            self._name(self.names, int(self.hb_idx[i])), float(self.hb_score[i]),
            self._name(self.names, int(self.hs_idx[i])), float(self.hs_score[i]),
            alt, bool(self.reliable[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @staticmethod
    def concat(parts: list["Rows"]) -> "Rows":
        """Concatenate chunks of one read (same name tables)."""
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        cat = np.concatenate
        alt = None if first.alt is None else cat([p.alt for p in parts], axis=0)
        return Rows(
            first.names, first.uniq_names,
            cat([p.best_idx for p in parts]), cat([p.best_upos for p in parts]),
            cat([p.starts for p in parts]), cat([p.ends for p in parts]),
            cat([p.score for p in parts]),
            cat([p.sb_idx for p in parts]), cat([p.sb_score for p in parts]),
            cat([p.hb_idx for p in parts]), cat([p.hb_score for p in parts]),
            cat([p.hs_idx for p in parts]), cat([p.hs_score for p in parts]),
            cat([p.reliable for p in parts]), alt,
        )


class _CodesCache:
    """Encodes each read once; block substrings become int8 slice views.
    Keys are display names or positional indices (duplicate read names must
    each score against their own sequence)."""

    def __init__(self, reads_by_key: dict):
        self.reads = reads_by_key
        self.codes: dict = {}

    def get(self, key) -> np.ndarray:
        c = self.codes.get(key)
        if c is None:
            c = self.codes[key] = encode(self.reads[key])
        return c


def _entry(e) -> tuple[str, list, object]:
    """(name, blocks) or (name, blocks, key) -> (name, blocks, key); the key
    defaults to the display name."""
    if len(e) == 3:
        return e
    name, blocks = e
    return name, blocks, name


def _homo_codes(c: np.ndarray) -> np.ndarray:
    """homo_compress on encoded int8 codes (run collapse commutes with
    encoding)."""
    if len(c) == 0:
        return c
    return c[np.concatenate(([True], c[1:] != c[:-1]))]


class _DeviceFinishCtx:
    """Device residency for the packed route: the monomer tensors come from
    the DeviceState; each read's codes upload once (FIFO-bounded). The
    finisher's worker threads share it, so the FIFO is locked."""

    MAX_READS = 8  # resident read codes

    def __init__(self, state: DeviceState, device: torch.device):
        self.state = state
        self.device = device
        self._reads: dict = {}
        self._lock = threading.Lock()

    def read_dev(self, key, codes: np.ndarray) -> torch.Tensor:
        with self._lock:
            dev = self._reads.get(key)
            if dev is None:
                while len(self._reads) >= self.MAX_READS:
                    self._reads.pop(next(iter(self._reads)))
                dev = self._reads[key] = torch.from_numpy(codes).to(self.device)
            return dev


def _dispatch_group_packed(per_read_blocks, codes_cache, ctx, packed_fn):
    """Packed route: one scorer call and one [2, n * M, 2] result per block
    chunk, covering both variants."""
    n_names = sum(len(blocks) for _, blocks, _ in per_read_blocks)
    starts = np.fromiter(
        (d["start"] for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int64, count=n_names,
    )
    lens = np.fromiter(
        (d["end"] - d["start"] + 1 for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int32, count=n_names,
    )
    if n_names == 0:
        return []
    uniq_keys = list(dict.fromkeys(key for _, blocks, key in per_read_blocks if blocks))
    if len(uniq_keys) == 1:
        read_dev = ctx.read_dev(uniq_keys[0], codes_cache.get(uniq_keys[0]))
    else:
        # multi-read group: concatenate its reads and shift the starts
        offs, parts, off = {}, [], 0
        for key in uniq_keys:
            c = codes_cache.get(key)
            offs[key] = off
            parts.append(c)
            off += len(c)
        read_np = np.concatenate(parts) if parts else np.zeros(1, dtype=np.int8)
        read_dev = torch.from_numpy(read_np).to(ctx.device)
        starts = starts + np.fromiter(
            (offs[key] for _, blocks, key in per_read_blocks for _ in blocks),
            dtype=np.int64, count=n_names,
        )
    st = ctx.state
    pending = []
    for s in range(0, len(starts), K2_CHUNK):
        part_lens = lens[s : s + K2_CHUNK]
        n = len(part_lens)
        dev = packed_fn(
            read_dev, starts[s : s + K2_CHUNK], part_lens,
            st.t_raw, st.tl_raw, st.t_homo, st.tl_homo,
            n_pad=n, Lq=max(1, int(part_lens.max())),
        )
        pending.append((s, n, dev))
    return pending


def _dispatch_pairs(pairs_q, pairs_t, identity_fn, device):
    """Light mode: score each block against its own monomer; returns
    (pos, n, matches, columns) per chunk."""
    pending = []
    for pos in range(0, len(pairs_q), K2_CHUNK):
        q, ql = pad_codes(pairs_q[pos : pos + K2_CHUNK])
        t, tl = pad_codes(pairs_t[pos : pos + K2_CHUNK])
        _, mt, ln = identity_fn(*(torch.from_numpy(a).to(device) for a in (q, ql, t, tl)))
        pending.append((pos, len(ql), mt, ln))
    return pending


def _gather_finish_group(pg: dict, mono_names, name_to_idx, coef):
    """Bring a dispatched group's results to the host and run the
    vectorized per-block logic (main.py:107-150)."""
    per_read_blocks = pg["group"]
    second_best = pg["second_best"]
    M_ = len(mono_names)
    n = pg["n"]
    mt_raw = ln_raw = mt_homo = ln_homo = matches = totals = None
    with stage("fin.gather"):
        if second_best:
            mt_raw = np.zeros((n, M_), dtype=np.int64)
            ln_raw = np.zeros((n, M_), dtype=np.int64)
            mt_homo = np.zeros((n, M_), dtype=np.int64)
            ln_homo = np.zeros((n, M_), dtype=np.int64)
            for s, cn, dev in pg["pend_packed"]:
                arr = dev.cpu().numpy().astype(np.int64)  # [2, n * M, 2]
                for v, (mt_o, ln_o) in enumerate(((mt_raw, ln_raw), (mt_homo, ln_homo))):
                    d2 = arr[v].reshape(-1, M_, 2)[:cn]
                    ln_o[s : s + cn] = d2[..., 1]
                    mt_o[s : s + cn] = d2[..., 1] - d2[..., 0]  # columns - D
        else:
            matches = np.zeros(n, dtype=np.int64)
            totals = np.zeros(n, dtype=np.int64)
            for s, cn, mt, ln in pg["pend_light"]:
                matches[s : s + cn] = mt.cpu().numpy()[:cn]
                totals[s : s + cn] = ln.cpu().numpy()[:cn]
    with stage("fin.assemble"):
        return _assemble_group(
            per_read_blocks, second_best, mono_names, name_to_idx, coef,
            mt_raw, ln_raw, mt_homo, ln_homo, matches, totals,
        )


def _assemble_group(
    per_read_blocks, second_best, mono_names, name_to_idx, coef,
    mt_raw, ln_raw, mt_homo, ln_homo, matches, totals,
) -> list[tuple[str, Rows]]:
    # Per-block host logic (main.py:107-150), vectorized over the group.
    # Bit-exactness: aai's float op order (m/L)*100 is elementwise, argmax
    # returns the FIRST max (== "first strict improvement wins",
    # main.py:131-135), stable argsort == the reference's stable sort on
    # -score (main.py:142). With duplicate monomer names the LAST
    # occurrence's score represents the name and tie order is the FIRST
    # occurrence order (dict semantics, main.py:123-126); a single distinct
    # name keeps (None, -1).
    M = len(mono_names)
    out: list[tuple[str, Rows]] = []
    uniq_names: list[str] = []
    upos: dict[str, int] = {}
    for nm in mono_names:
        if nm not in upos:
            upos[nm] = len(uniq_names)
            uniq_names.append(nm)
    U = len(uniq_names)
    if second_best:
        Nb = mt_raw.shape[0]
        with np.errstate(invalid="ignore"):
            sc_all = np.where(ln_raw == 0, 0.0, (mt_raw.astype(np.float64) / ln_raw) * 100.0)
            hsc_all = np.where(ln_homo == 0, 0.0, (mt_homo.astype(np.float64) / ln_homo) * 100.0)
        best_idx_all = np.fromiter(
            (name_to_idx[d["m"]] for _, blocks, _ in per_read_blocks for d in blocks),
            dtype=np.int32, count=Nb,
        )
        best_upos_all = np.fromiter(
            (upos[d["m"]] for _, blocks, _ in per_read_blocks for d in blocks),
            dtype=np.int32, count=Nb,
        )
        rows = np.arange(Nb)
        best_score_all = sc_all[rows, best_idx_all] if Nb else np.zeros(0)
        last_col = np.zeros(U, dtype=np.int64)
        for j, nm in enumerate(mono_names):
            last_col[upos[nm]] = j
        alt_all = sc_all[:, last_col]  # name-collapsed [Nb, U] (alt rows)
        if Nb and U > 1:
            masked = alt_all.copy()
            masked[rows, best_upos_all] = -np.inf
            sb_idx_all = masked.argmax(axis=1).astype(np.int32)  # first max
            sb_score_all = masked[rows, sb_idx_all]
        else:
            sb_idx_all = np.full(Nb, -1, dtype=np.int32)
            sb_score_all = np.full(Nb, -1.0)
        if Nb:
            horder = np.argsort(-hsc_all, axis=1, kind="stable")
            hb_idx_all = horder[:, 0].astype(np.int32)
            hb_score_all = hsc_all[rows, hb_idx_all]
            if M > 1:
                hs_idx_all = horder[:, 1].astype(np.int32)
                hs_score_all = hsc_all[rows, hs_idx_all]
            else:
                hs_idx_all = np.full(Nb, -1, dtype=np.int32)
                hs_score_all = np.full(Nb, -1.0)
        else:
            hb_idx_all = hs_idx_all = np.zeros(0, dtype=np.int32)
            hb_score_all = hs_score_all = np.zeros(0)
    else:
        Nb = len(matches)
        with np.errstate(invalid="ignore"):
            best_score_all = np.where(
                totals == 0, 0.0, (matches.astype(np.float64) / totals) * 100.0
            )
        best_idx_all = np.fromiter(
            (name_to_idx[d["m"]] for _, blocks, _ in per_read_blocks for d in blocks),
            dtype=np.int32, count=Nb,
        )
        best_upos_all = np.full(Nb, -1, dtype=np.int32)
        sb_idx_all = hb_idx_all = hs_idx_all = np.full(Nb, -1, dtype=np.int32)
        sb_score_all = hb_score_all = hs_score_all = np.full(Nb, -1.0)
        alt_all = None
    starts_all = np.fromiter(
        (d["start"] for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int64, count=Nb,
    )
    ends_all = np.fromiter(
        (d["end"] for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int64, count=Nb,
    )
    reliable_all = classify(best_score_all, sb_score_all, coef)  # main.py:149
    bi = 0
    for read_name, blocks, _ in per_read_blocks:
        s = slice(bi, bi + len(blocks))
        out.append((read_name, Rows(
            mono_names, uniq_names,
            best_idx_all[s], best_upos_all[s], starts_all[s], ends_all[s],
            best_score_all[s], sb_idx_all[s], sb_score_all[s],
            hb_idx_all[s], hb_score_all[s], hs_idx_all[s], hs_score_all[s],
            reliable_all[s], alt_all[s] if alt_all is not None else None,
        )))
        bi += len(blocks)
    return out


class AsyncFinisher:
    """Bounded-in-flight finishing: submit() encodes one chunk's blocks and
    queues its device work at once (CUDA launches are asynchronous); results
    come back to the host FIFO once more than MAX_INFLIGHT groups wait.

    `identity_fn` (light mode) and `packed_fn` (--second-best) default to the
    kernel wrappers, which run the plain twins on CPU tensors; passing the
    plain functions forces the plain route on the card (for comparisons)."""

    MAX_INFLIGHT = 3  # dispatched groups kept before the oldest is gathered

    def __init__(
        self,
        reads_by_key: dict,
        monomers_interleaved: list[Record],
        state: DeviceState,
        device: torch.device,
        second_best: bool = False,
        identity_fn=nw_identity_batch_cuda,
        packed_fn=nw_identity_packed_both,
        threads: int = 1,
    ):
        self.codes = _CodesCache(reads_by_key)
        self.mono_names = [m.name for m in monomers_interleaved]
        self.name_to_idx = {n: i for i, n in enumerate(self.mono_names)}
        self.mono_codes = [encode(m.seq) for m in monomers_interleaved]
        self.coef = state.coef
        self.device = device
        self.second_best = second_best
        self.identity_fn = identity_fn
        self.packed_fn = packed_fn
        self.ctx = _DeviceFinishCtx(state, device) if second_best else None
        self.pool = None
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self.pool = ThreadPoolExecutor(max_workers=threads)
        self._q: deque = deque()

    def _dispatch(self, group):
        with stage("fin.dispatch"):
            group = [_entry(e) for e in group]
            n = sum(len(blocks) for _, blocks, _ in group)
            pg = {"group": group, "n": n, "second_best": self.second_best}
            if self.second_best:
                pg["pend_packed"] = _dispatch_group_packed(
                    group, self.codes, self.ctx, self.packed_fn)
            else:
                subs, pairs_t = [], []
                for _, blocks, key in group:
                    codes = self.codes.get(key)
                    for d in blocks:
                        subs.append(codes[d["start"] : d["end"] + 1])
                        pairs_t.append(self.mono_codes[self.name_to_idx[d["m"]]])
                pg["pend_light"] = _dispatch_pairs(subs, pairs_t, self.identity_fn, self.device)
            return pg

    def submit_group(self, group: list[tuple]):
        """Queue one group's scoring; returns the groups that became ready
        (in submission order) once the in-flight bound is exceeded."""
        self._q.append(self.pool.submit(self._dispatch, group) if self.pool
                       else self._dispatch(group))
        out = []
        while len(self._q) > self.MAX_INFLIGHT:
            out.extend(self._gather_one())
        return out

    def submit(self, read_name: str, blocks: list[dict], key=None):
        """`key` selects the sequence in reads_by_key when it is not the
        display name (positional keys make duplicate read names safe)."""
        return self.submit_group([(read_name, blocks, read_name if key is None else key)])

    def _gather_one(self):
        pg = self._q.popleft()
        if self.pool is not None:
            pg = pg.result()
        return _gather_finish_group(pg, self.mono_names, self.name_to_idx, self.coef)

    def drain(self):
        """Gather every remaining group, in order; retires the pool."""
        out = []
        while self._q:
            out.extend(self._gather_one())
        self.close()
        return out

    def close(self):
        """Abandon queued groups and stop the pool (idempotent)."""
        self._q.clear()
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


def finish_reads(
    per_read_blocks: list[tuple],  # [(name, [{m,start,end}])] or (name, blocks, key)
    reads_by_key: dict,
    monomers_interleaved: list[Record],
    device: torch.device,
    second_best: bool = False,
    model_file: str | None = None,
    flush_pairs: int = 1 << 20,
    threads: int = 1,
) -> list[tuple[str, Rows]]:
    """Rescore every block; returns finished blocks per read, same order.
    Reads accumulate into one group until `flush_pairs` pairs are pending;
    a read larger than that is split into block chunks and re-merged."""
    state = state_from_numpy(*numpy_state([], monomers_interleaved, model_file), device)
    stride = 2 * len(monomers_interleaved) if second_best else 1
    max_blocks = max(1, flush_pairs // stride)
    out: list = []
    group: list = []
    pending = 0
    fin_ = AsyncFinisher(reads_by_key, monomers_interleaved, state, device,
                         second_best=second_best, threads=threads)
    try:
        for e in per_read_blocks:
            read_name, blocks, key = _entry(e)
            for s in range(0, max(len(blocks), 1), max_blocks):
                chunk = blocks[s : s + max_blocks]
                group.append((read_name, chunk, key))
                pending += len(chunk) * stride
                if pending >= flush_pairs:
                    out.extend(fin_.submit_group(group))
                    group, pending = [], 0
        if group:
            out.extend(fin_.submit_group(group))
        out.extend(fin_.drain())
    finally:
        fin_.close()
    merged = []
    gi = 0
    for e in per_read_blocks:
        read_name, blocks, _ = _entry(e)
        need = max(1, -(-max(len(blocks), 1) // max_blocks))
        merged.append((read_name, Rows.concat([out[gi + k][1] for k in range(need)])))
        gi += need
    return merged


def write_final_rows(fout, falt, finished, identity_th: int = 0) -> None:
    """Final 12-column and alt 6-column rows (main.py:153-165), through the
    native C++ formatter when it is available (byte-identical to Python's
    "{:.2f}"), else the Python emitter below."""
    from stringdecomposer_tpu.runtime.native import format_final_native

    memo: dict[float, str] = {}

    def f2(x) -> str:
        x = float(x)
        s = memo.get(x)
        if s is None:
            s = memo[x] = f"{x:.2f}"
        return s

    for read_name, blocks in finished:
        if isinstance(blocks, Rows) and len(blocks):
            res = format_final_native(
                read_name, blocks.names, blocks.uniq_names, blocks.best_idx,
                blocks.best_upos, blocks.starts, blocks.ends, blocks.score,
                blocks.sb_idx, blocks.sb_score, blocks.hb_idx, blocks.hb_score,
                blocks.hs_idx, blocks.hs_score, blocks.reliable, blocks.alt,
                identity_th,
            )
            if res is not None:
                fout.write(res[0].decode("utf-8"))
                falt.write(res[1].decode("utf-8"))
                continue
        rows: list[str] = []
        alt_rows: list[str] = []
        for b in blocks:
            if b.score >= identity_th:
                se = f"{b.start}\t{b.end}"
                rows.append(
                    f"{read_name}\t{b.monomer_name}\t{se}\t{f2(b.score)}\t"
                    f"{b.second_best}\t{f2(b.second_best_score)}\t"
                    f"{b.homo_best}\t{f2(b.homo_best_score)}\t"
                    f"{b.homo_second_best}\t{f2(b.homo_second_best_score)}\t"
                    f"{'+' if b.reliable else '?'}\n"
                )
                for name, sc in b.alt.items():
                    star = "*" if name == b.monomer_name else "-"
                    alt_rows.append(f"{read_name}\t{name}\t{se}\t{f2(sc)}\t{star}\n")
        fout.write("".join(rows))
        falt.write("".join(alt_rows))
