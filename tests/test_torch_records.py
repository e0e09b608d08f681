"""The DP stream's blocks as int32 records (ops/records.py) on the CPU: the
streaming halo dedup, native and its Python fallback, against the port's
PostprocessStream and the batch postprocess (and the JAX package's); the
native raw rows in chunks seeded with the last end against
format_raw_rows; a batch's replay against blocks_from_device; the chunks
decompose_stream yields against the JAX package's stream, native and
fallback, with and without --ed_thr; and AsyncFinisher fed the column
hand-off against the same finisher fed dict lists."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu import pipeline as jp
from stringdecomposer_tpu.io.fasta import Record, add_rc_interleaved, add_reverse_complement
from stringdecomposer_tpu.ops import oracle as j_oracle
from stringdecomposer_tpu.ops.oracle import Scoring
from stringdecomposer_tpu_torch import finishing, pipeline as tp
from stringdecomposer_tpu_torch.convert import numpy_state, state_from_numpy
from stringdecomposer_tpu_torch.ops import oracle, records
from stringdecomposer_tpu_torch.ops.traceback import blocks_from_device
from stringdecomposer_tpu_torch.report import format_raw_rows
from stringdecomposer_tpu_torch.runtime import native
from stringdecomposer_tpu_torch.utils import stagetimer

torch.set_num_threads(1)

UNIT = "ACGGTCTGAACTTGGCA"


def _records(rng, n, max_m=24):
    """n random overlapping blocks in reading order, as the window merge
    emits them (some duplicates of the halo), as [n, 4] int32 records."""
    out, pos = [], 0
    for _ in range(n):
        ln = int(rng.integers(5, 40))
        start = max(0, pos - int(rng.integers(0, 30)))
        out.append((int(rng.integers(0, max_m)), start, start + ln, int(rng.integers(-20, 180))))
        pos = start + ln + int(rng.integers(0, 5))
    return np.array(out, dtype=np.int32).reshape(-1, 4)


def _tuples(blocks):
    return [(b.monomer, b.start, b.end, int(b.identity)) for b in blocks]


def _rows(recs):
    return [tuple(int(x) for x in r) for r in recs]


def _landing_case():
    """Seven blocks where block 0 covers more than half of block 6 and of
    none before it: pushed as one window, the jump lands exactly one past
    the buffer, and block 7 of the next window is emitted unchecked."""
    first = [(0, 0, 100, 5)] + [(1, 10 * j, 10 * j + 200, 6) for j in range(1, 6)] + \
        [(2, 60, 70, 7)]
    second = [(3, 300, 310, 8), (4, 305, 400, 9), (5, 410, 450, 1)] + \
        [(6, 420 + 10 * k, 480 + 10 * k, 2) for k in range(8)]
    return [np.array(first, dtype=np.int32), np.array(second, dtype=np.int32)]


def _windows(rng, n):
    """A read's records cut into windows of random sizes, some empty."""
    recs = _records(rng, n)
    cuts = np.sort(rng.integers(0, n + 1, int(rng.integers(0, 12))))
    return list(np.split(recs, cuts))


def _want(windows):
    """Each window's chunk from oracle.PostprocessStream pushed a window at
    a time (the last with finish())."""
    ps, out = oracle.PostprocessStream(), []
    for k, w in enumerate(windows):
        got = ps.push(records.to_blocks(w))
        if k == len(windows) - 1:
            got += ps.finish()
        out.append(_tuples(got))
    return out


@pytest.fixture(params=["native", "fallback"])
def mode(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(records, "postprocess_stream_native", lambda *a: None)
    else:
        assert native.load_native() is not None
    return request.param


def _push_runs(windows, rng):
    """Push the windows in runs of random length; each window's chunk."""
    stream, out, k = records.DedupStream(), [], 0
    while k < len(windows):
        e = min(len(windows), k + int(rng.integers(1, 5)))
        out += [_rows(c) for c in stream.push(windows[k:e], final=e == len(windows))]
        k = e
    return out


@pytest.mark.parametrize("seed", range(6))
def test_dedup_stream_matches_postprocess(seed, mode):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.choice([0, 1, 2, 7, 8, int(rng.integers(0, 300))]))
        windows = _windows(rng, n)
        want = _want(windows)
        assert _push_runs(windows, rng) == want
        flat = [t for c in want for t in c]
        allb = records.to_blocks(np.concatenate(windows))
        assert flat == _tuples(oracle.postprocess(allb))
        assert flat == _tuples(j_oracle.postprocess([j_oracle.Block(*t) for t in _tuples(allb)]))


@pytest.mark.parametrize("runs", [[1, 1], [2]])
def test_dedup_stream_landing_one_past_the_buffer(runs, mode):
    """The jump of window 0 lands one past its blocks: pushed a window at a
    time the landing flag carries to the next push; pushed together it
    does not need to. Both give the batch postprocess' blocks."""
    windows = _landing_case()
    ps = oracle.PostprocessStream()
    ps.push(records.to_blocks(windows[0]))
    assert ps._landing  # the case is the one it claims to be
    stream, got, k = records.DedupStream(), [], 0
    for r in runs:
        got += [_rows(c) for c in stream.push(windows[k:k + r], final=k + r == len(windows))]
        k += r
    assert got == _want(windows)
    assert (1, 60, 70, 7) not in got[0] and got[1][0] == (3, 300, 310, 8)


@pytest.mark.parametrize("pushes", [[[]], [[], []], [["one"]], [[], ["one"], []]])
def test_dedup_stream_empty_pushes_and_single_blocks(pushes, mode):
    one = np.array([[3, 10, 50, 7]], dtype=np.int32)
    stream, got = records.DedupStream(), []
    for k, p in enumerate(pushes):
        wins = [one if w == "one" else records.EMPTY for w in p] or [records.EMPTY]
        got += [_rows(c) for c in stream.push(wins, final=k == len(pushes) - 1)]
    n_one = sum(w == "one" for p in pushes for w in p)
    assert [t for c in got for t in c] == [(3, 10, 50, 7)] * n_one


def test_fallback_counts(monkeypatch):
    monkeypatch.setattr(records, "postprocess_stream_native", lambda *a: None)
    stagetimer.enable()
    try:
        with stagetimer.job():
            s = records.DedupStream()
            s.push([records.EMPTY])
            s.push([records.EMPTY], final=True)
    finally:
        stagetimer.disable()
    assert stagetimer.counters()["host.native_fallback"] == 2


@pytest.mark.parametrize("seed", range(4))
def test_chunked_raw_rows_with_prev_end(seed):
    """Raw rows of a read formatted in chunks, each seeded with the last
    end of the chunk before, equal format_raw_rows over the whole read;
    and a table built once serves every chunk."""
    rng = np.random.default_rng(50 + seed)
    recs = _records(rng, int(rng.integers(1, 400)))
    recs[rng.integers(0, len(recs), 3), 3] *= -1  # negative identities print too
    names = [f"m{i}'" if i % 2 else f"mono_{i}" for i in range(24)]
    want = "".join(r + "\n" for r in format_raw_rows("read 7", records.to_blocks(recs), names))
    table = native.NameTable(names)
    got, prev = b"", 0
    for chunk in np.split(recs, np.sort(rng.integers(0, len(recs), 5))):
        piece = native.format_raw_native(chunk, "read 7", table, prev)
        assert piece == "".join(r + "\n" for r in format_raw_rows(
            "read 7", records.to_blocks(chunk), names, prev_end=prev)).encode()
        got += piece
        prev = int(chunk[-1, 2]) if len(chunk) else prev
    assert got == want.encode()
    assert native.format_raw_native(recs, "read 7", names) == want.encode()


@pytest.mark.parametrize("perm", [False, True])
def test_replay_batch_matches_blocks_from_device(perm):
    rng = np.random.default_rng(3)
    B, cap, M = 9, 40, 11
    blocks = rng.integers(0, 500, (B, cap, 4)).astype(np.int32)
    blocks[..., 0] %= M
    counts = rng.integers(0, cap + 1, B).astype(np.int32)
    counts[2] = 0
    offsets = rng.integers(0, 10**6, B - 1)  # a batch row past the tasks is ignored
    pm = np.stack([rng.permutation(M) for _ in range(B)]).astype(np.int64) if perm else None
    recs, bounds = records.replay_batch(blocks, counts, offsets, pm)
    assert recs.dtype == np.int32 and len(bounds) == B
    for i, off in enumerate(offsets):
        want = [(int(pm[i][b.monomer]) if perm else b.monomer, b.start + int(off),
                 b.end + int(off), int(b.identity))
                for b in blocks_from_device(blocks[i], int(counts[i]))]
        assert _rows(recs[bounds[i]:bounds[i + 1]]) == want


def _mutate(rng, seq, rate):
    arr = np.array(list(seq))
    idx = rng.integers(0, len(arr), max(1, int(len(arr) * rate)))
    arr[idx] = rng.choice(list("ACGT"), len(idx))
    return "".join(arr)


@pytest.mark.parametrize("ed_thr", [-1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_stream_chunks_match_jax(seed, ed_thr, mode):
    """(read, blocks, final) in the order the JAX package's stream yields
    them, for reads of 0, 1 and many windows; decompose_reads' Blocks."""
    rng = np.random.default_rng(60 + seed)
    monos = [UNIT, _mutate(rng, UNIT[::-1] + "TG", 0.2)]
    reads = [Record("empty0", "")]
    for i, n in enumerate([30, 64, 700, 1500, 0, 200, 2300]):
        seq = "".join(monos[int(rng.integers(2))] for _ in range(n // 17 + 1))[:n]
        reads.append(Record(f"r{i}", _mutate(rng, seq, 0.05) if n else ""))
    monos = add_reverse_complement([Record(f"m{j}", m) for j, m in enumerate(monos)])
    kw = dict(scoring=Scoring(-1, -1, -1, 1), part_size=64, overlap=8, device_batch=3,
              ed_thr=ed_thr)
    want = [(r, _tuples(b), f) for r, b, f in
            jp.decompose_stream(reads, monos, jp.PipelineConfig(**kw))]
    got = [(r, _rows(b), f) for r, b, f in
           tp.decompose_stream(reads, monos, tp.PipelineConfig(**kw), "cpu")]
    assert got == want
    assert sum(f for _, _, f in got) == len(reads)
    assert {len(b) for r, b, _ in got if reads[r].seq == ""} == {0}
    res = tp.decompose_reads(reads, monos, tp.PipelineConfig(**kw), "cpu")
    assert [(n, _tuples(b)) for n, b in res] == \
        [(n, _tuples(b)) for n, b in jp.decompose_reads(reads, monos, jp.PipelineConfig(**kw))]
    assert all(isinstance(b.identity, float) for _, bl in res for b in bl)


def _finisher_case(dup):
    rng = np.random.default_rng(8)
    names = ["a", "b", "a" if dup else "c", "d"]
    fwd = [Record(nm, _mutate(rng, UNIT, 0.15)) for nm in names]
    fin = add_rc_interleaved(fwd)
    reads = {k: _mutate(rng, UNIT * 12, 0.05) for k in range(3)}
    per_read = []
    for k in range(3):
        n = [0, 5, 23][k]
        starts = np.sort(rng.integers(0, len(reads[k]) - 30, n))
        per_read.append((f"r{k}", [{"m": fin[int(rng.integers(len(fin)))].name,
                                    "start": int(s), "end": int(s) + int(rng.integers(5, 25))}
                                   for s in starts], k))
    return reads, fin, per_read


def _fields(rows):
    return [(rows.names, rows.uniq_names)] + [getattr(rows, a).tolist() if a != "alt" or
                                              rows.alt is not None else None
                                              for a in finishing.Rows.__slots__[2:]]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("second_best", [False, True])
def test_finisher_columns_match_dicts(second_best, dup):
    """Chunks handed over as columns (what _pump_reads builds: the
    finisher's index of the DP row's name) give the Rows the same chunks
    give as dict lists, a chunk a group and all in one group; with a
    duplicated name both take its last row."""
    reads, fin, per_read = _finisher_case(dup)
    dev = torch.device("cpu")
    state = state_from_numpy(*numpy_state([], fin), dev)

    def finish(entries, one_group):
        f = finishing.AsyncFinisher(reads, fin, state, dev, second_best=second_best)
        got = f.submit_group(entries) if one_group else \
            [r for e in entries for r in f.submit_group([e])]
        return [(n, _fields(r)) for n, r in got + f.drain()]

    to_idx = finishing.AsyncFinisher(reads, fin, state, dev).name_to_idx
    cols = [(n, finishing.BlockColumns(
        np.array([to_idx[d["m"]] for d in b], dtype=np.int32),
        np.array([d["start"] for d in b], dtype=np.int64),
        np.array([d["end"] for d in b], dtype=np.int64)), k) for n, b, k in per_read]
    want = finish(per_read, False)
    for one_group in (False, True):
        assert finish(cols, one_group) == want
        assert finish(per_read, one_group) == want
    finished = finishing.finish_reads(per_read, reads, fin, dev, second_best=second_best,
                                      flush_pairs=64)
    assert [(n, _fields(r)) for n, r in finished] == want
    if dup:  # "a" is rows 0 and 4 of the interleaved order: its blocks take 4
        assert to_idx["a"] == 4
        best = dict(want)["r2"][1]
        a_rows = [i for i, d in enumerate(per_read[2][1]) if d["m"] == "a"]
        assert a_rows and {best[i] for i in a_rows} == {4}
