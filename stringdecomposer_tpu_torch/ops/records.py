"""The DP stream's blocks as int32 records on the host.

K1's walk brings back one record a block, (monomer, start, end, identity),
last block first, into a [B, cap, 4] int32 batch in pinned memory. The DP
stream keeps each block a row of such an array from that copy to the raw
TSV and the finisher's intake, with no Python object a block:

  replay_batch   a batch's windows in reading order and read coordinates,
                 one gather for the whole batch
  DedupStream    the halo dedup (oracle.postprocess's rule, with its
                 landing quirk) over records pushed a run of windows at a
                 time, giving each window's newly final records exactly as
                 oracle.PostprocessStream gives them a window at a time
  to_blocks      records -> [Block], for decompose_reads' callers

The dedup runs in the native runtime (runtime/native.py); without it a
Python loop over the same records gives the same result, and each push it
takes is counted as `host.native_fallback`.
"""

from __future__ import annotations

import numpy as np

from ..runtime.native import postprocess_stream_native
from ..utils import stagetimer
from .oracle import Block

EMPTY = np.zeros((0, 4), dtype=np.int32)


def replay_batch(blocks: np.ndarray, counts: np.ndarray, offsets: np.ndarray,
                 perm: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """blocks [B, cap, 4] int32 and counts [B] as K1's walk left them, for
    windows at read `offsets` [n <= B] -> (records [total, 4] int32, bounds
    [n + 1]): window i's blocks are records[bounds[i]:bounds[i + 1]], in
    reading order, start and end shifted by its offset. `perm` [B, M] (under
    --ed_thr) maps a window's filtered DP row to the input monomer index."""
    n = len(offsets)
    counts = counts[:n].astype(np.int64)
    bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    win = np.repeat(np.arange(n), counts)
    # the k-th block of window w in reading order is its record
    # counts[w] - 1 - (k - bounds[w]), that is bounds[w + 1] - 1 - k
    slot = bounds[1:][win] - 1 - np.arange(bounds[-1])
    recs = blocks[win, slot]
    recs[:, 1:3] += np.asarray(offsets, dtype=np.int32)[win, None]
    if perm is not None:
        recs[:, 0] = perm[win, recs[:, 0]]
    return recs, bounds


def _stream_py(recs: np.ndarray, bounds: np.ndarray, final: bool,
               landing: bool) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """runtime/native/sdnative.cpp's sd_postprocess_stream in Python."""
    starts, ends = recs[:, 1].tolist(), recs[:, 2].tolist()
    emit: list[int] = []
    cuts: list[int] = []
    i = 0
    last = len(bounds) - 1
    for k, nb in enumerate(bounds.tolist()):
        for fin in ((False, True) if final and k == last else (False,)):
            if landing and nb > i:
                emit.append(i)
                i += 1
                landing = False
            while i < nb and (fin or i + 7 <= nb):
                jumped = False
                for j in range(i + 1, min(i + 7, nb)):
                    if (ends[i] - starts[j]) * 2 > (ends[j] - starts[j]):
                        emit.append(i)
                        i = j + 1
                        jumped = True
                        break
                if i < nb:
                    emit.append(i)
                elif jumped and not fin:
                    landing = True
                i += 1
            i = min(i, nb)
        cuts.append(len(emit))
    return np.array(emit, dtype=np.int64), np.array(cuts, dtype=np.int64), i, landing


class DedupStream:
    """oracle.PostprocessStream over int32 records, a run of windows a push.

    The rule looks at most 6 blocks ahead, so a block is final once 6
    successors have arrived; the at most 6 undecided blocks, and whether a
    jump landed one past them, carry to the next push. push() returns one
    array a window pushed: the records that window made final (with
    `final`, the last window's array also holds the read's tail, as
    PostprocessStream.finish adds it). Their concatenation over all pushes
    equals postprocess() of all the records pushed."""

    def __init__(self) -> None:
        self._held = EMPTY
        self._landing = False

    def push(self, windows: list[np.ndarray], final: bool = False) -> list[np.ndarray]:
        recs = np.concatenate([self._held, *windows])
        bounds = np.cumsum([len(self._held)] + [len(w) for w in windows])[1:]
        res = postprocess_stream_native(recs, bounds, final, self._landing)
        if res is None:
            stagetimer.count("host.native_fallback")
            res = _stream_py(recs, bounds, final, self._landing)
        emit, cuts, held, self._landing = res
        self._held = recs[held:].copy()
        return np.split(recs[emit], cuts[:-1])


def to_blocks(recs: np.ndarray) -> list[Block]:
    """[n, 4] records -> Blocks (identity a float, as the reference keeps it)."""
    return [Block(m, s, e, float(ident)) for m, s, e, ident in recs.tolist()]
