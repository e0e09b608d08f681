"""NumPy executable specification of the chain DP (monomer string decomposition);
the port's copy of the JAX package's ops/oracle.py.

This module is the ground-truth spec that the kernels are tested against.
It reproduces, bit-for-bit, the observable behavior of the reference C++ core
(reference: src/main.cpp:151-270 `AlignPartClassicDP`), including every
tie-breaking rule of its traceback, but is written as a vectorized
column-sweep (the same formulation the kernels use) rather than a
cell-by-cell triple loop.

DP formulation
--------------
State: dp[i][j][k] = best score of any monomer chain over read[0..i] whose
last (possibly partial) block is monomer j consumed through position k, with
read char i already consumed. A separate chain state chain[i] = best score of
a chain of *complete* monomer blocks ending strictly before read position i
(reference dp[i][M][0], src/main.cpp:185).

Recurrence (src/main.cpp:187-207), for i >= 1:
  chain[i]   = max_j dp[i-1][j][len_j - 1]
  dp[i][j][k] = max( chain[i] + mm(j,k,i) + k*del        # enter monomer j
               ,     dp[i-1][j][k-1] + mm(j,k,i)  (k>0)  # diagonal
               ,     dp[i-1][j][k]   + ins        (k>0)  # read insertion
               ,     dp[i][j][k-1]   + del        (k>0)  # monomer deletion
               )
The same-column deletion chain is folded into a prefix max:
  dp[i][j][k] = k*del + cummax_k( cand[i][j][k] - k*del )
which is exactly equivalent because del is constant per run.

Init column i=0 (src/main.cpp:171-182) uses a different rule:
  dp[0][j][0] = mm(j,0,0)
  dp[0][j][k] = max(dp[0][j][k-1] + del, del*(k-1) + mm(j,k,0))

Traceback (src/main.cpp:217-269) walks backward with this exact priority at
each monomer cell: deletion (k>0), then insertion (checked even at k==0,
unlike the forward pass!), then diagonal, then block-enter, then a
fallthrough that closes the block without chain adjustment (only reachable
at i==0). Chain-state jumps pick the FIRST monomer index whose end cell
equals the chain score (src/main.cpp:230-237). Block score ("identity") is
dp[end] - chain[start] (src/main.cpp:255), except for the first block of the
read, which keeps the raw dp value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import PAD_CODE, encode

INF = -1_000_000  # src/main.cpp:156
NEG_BIG = np.int64(-(1 << 60))  # mask filler for invalid candidates


@dataclass
class Block:
    """One monomer block of the decomposition (reference MonomerAlignment,
    src/main.cpp:37-49)."""

    monomer: int  # index into the monomer list
    start: int
    end: int
    identity: float  # dp score delta, cast to float like the reference


@dataclass
class Scoring:
    ins: int = -1
    dele: int = -1
    mismatch: int = -1
    match: int = 1


def _mm_matrix(mono: np.ndarray, read_char: int, scoring: Scoring) -> np.ndarray:
    """Match/mismatch score of every monomer cell vs one read char."""
    return np.where(mono == read_char, scoring.match, scoring.mismatch).astype(np.int64)


def chain_dp_cube(
    read_codes: np.ndarray,
    mono: np.ndarray,
    mono_lens: np.ndarray,
    scoring: Scoring = Scoring(),
) -> tuple[np.ndarray, np.ndarray]:
    """Compute the full DP cube dp[n, M, L] plus chain[n].

    mono is [M, L] int8 padded with PAD_CODE. Padded cells hold garbage that
    never flows into valid cells (padding sits after the valid prefix along
    k, and the only same-column dependency, the deletion fold, runs toward
    increasing k).
    """
    n = len(read_codes)
    M, L = mono.shape
    k_idx = np.arange(L, dtype=np.int64)
    k_del = k_idx * scoring.dele
    end_mask = k_idx[None, :] == (mono_lens[:, None] - 1)  # [M, L]

    dp = np.empty((n, M, L), dtype=np.int64)
    chain = np.empty(n, dtype=np.int64)
    chain[0] = INF

    # init column (src/main.cpp:171-182)
    mm0 = _mm_matrix(mono, read_codes[0], scoring)
    cand0 = (k_idx[None, :] - 1) * scoring.dele + mm0
    cand0[:, 0] = mm0[:, 0]
    dp[0] = k_del[None, :] + np.maximum.accumulate(cand0 - k_del[None, :], axis=1)

    for i in range(1, n):
        prev = dp[i - 1]
        chain_i = np.max(np.where(end_mask, prev, NEG_BIG))
        chain[i] = chain_i
        mm = _mm_matrix(mono, read_codes[i], scoring)
        enter = chain_i + mm + k_del[None, :]
        diag = np.empty_like(prev)
        diag[:, 1:] = prev[:, :-1] + mm[:, 1:]
        diag[:, 0] = NEG_BIG
        insr = prev + scoring.ins
        insr[:, 0] = NEG_BIG
        cand = np.maximum(enter, np.maximum(diag, insr))
        dp[i] = k_del[None, :] + np.maximum.accumulate(cand - k_del[None, :], axis=1)

    return dp, chain


def traceback_cube(
    read_codes: np.ndarray,
    mono: np.ndarray,
    mono_lens: np.ndarray,
    dp: np.ndarray,
    scoring: Scoring = Scoring(),
) -> list[Block]:
    """Literal transcription of the reference traceback (src/main.cpp:209-269)."""
    n, M, _ = dp.shape
    lens = mono_lens
    ins, dele, match, mismatch = scoring.ins, scoring.dele, scoring.match, scoring.mismatch

    # argmax over end cells, strict > so ties keep the smallest j
    # (src/main.cpp:209-216)
    max_score = INF
    best_m = M
    for j in range(M):
        v = dp[n - 1, j, lens[j] - 1]
        if max_score < v:
            max_score = v
            best_m = j

    ans: list[Block] = []
    i, j = n - 1, best_m
    k = lens[j] - 1 if j != M else 0
    monomer_changed = True
    cur: Block | None = None
    CHAIN = M  # the reference's j == monomers_num chain state

    while i >= 0:
        if j != CHAIN and k == lens[j] - 1 and monomer_changed:
            cur = Block(j, i, i, float(dp[i, j, k]))
            monomer_changed = False
        if j == CHAIN:
            if i != 0:
                # chain value == dp[i][M][0] == max over end cells of column i-1;
                # the reference scans p over all M+1 sub-rows (incl. the chain
                # cell) and takes the first equal (src/main.cpp:230-237).
                chain_val = max(
                    INF, max(dp[i - 1, p, lens[p] - 1] for p in range(M))
                )
                jumped = False
                for p in range(M):
                    if dp[i - 1, p, lens[p] - 1] == chain_val:
                        i -= 1
                        j = p
                        k = lens[p] - 1
                        jumped = True
                        break
                if not jumped:  # pragma: no cover - unreachable for n>=1
                    i -= 1
            else:
                i -= 1
        else:
            v = dp[i, j, k]
            if k != 0 and v == dp[i, j, k - 1] + dele:
                k -= 1
            elif i != 0 and v == dp[i - 1, j, k] + ins:
                # NOTE: no k!=0 guard here, mirroring src/main.cpp:245 — the
                # forward pass never uses ins at k==0, but the traceback can
                # take it when the equality coincidentally holds.
                i -= 1
            else:
                mm = match if mono[j, k] == read_codes[i] else mismatch
                if i != 0 and k != 0 and v == dp[i - 1, j, k - 1] + mm:
                    i -= 1
                    k -= 1
                else:
                    monomer_changed = True
                    chain_val = (
                        max(INF, max(dp[i - 1, p, lens[p] - 1] for p in range(M)))
                        if i != 0
                        else INF
                    )
                    if i != 0 and chain_val + k * dele + mm == v:
                        cur.start = i
                        cur.identity = cur.identity - float(chain_val)
                        ans.append(cur)
                        j = CHAIN
                        k = 0
                    else:
                        cur.start = i
                        ans.append(cur)
                        i -= 1
    ans.reverse()
    return ans


def decompose_window_oracle(
    read_codes: np.ndarray,
    mono: np.ndarray,
    mono_lens: np.ndarray,
    scoring: Scoring = Scoring(),
) -> list[Block]:
    dp, _chain = chain_dp_cube(read_codes, mono, mono_lens, scoring)
    return traceback_cube(read_codes, mono, mono_lens, dp, scoring)


def make_windows(read_len: int, part_size: int, overlap: int) -> list[tuple[int, int]]:
    """Window offsets/lengths for one read (src/main.cpp:73-79): stride
    part_size, window length part_size+overlap (capped at read end), keeping a
    window only if at least `overlap` bases remain or the whole read is
    shorter than `overlap`."""
    out = []
    for i in range(0, read_len, part_size):
        if read_len - i >= overlap or read_len < overlap:
            out.append((i, min(part_size + overlap, read_len - i)))
    return out


def postprocess(blocks: list[Block]) -> list[Block]:
    """Halo-duplicate suppression (src/main.cpp:287-302): within a look-ahead
    of 6 blocks, if block i covers more than half of block j, keep i, skip
    j..j (i jumps to j+1) — exact transcription including the quirk that the
    landing block j+1 is emitted without its own overlap check.

    Centromere-scale block lists take the native C++ path (bit-identical,
    tested in tests/test_torch_host.py); short lists stay in Python."""
    if len(blocks) > 1024:
        from ..runtime.native import postprocess_native

        arr = np.array(
            [[b.monomer, b.start, b.end, int(b.identity)] for b in blocks],
            dtype=np.int32,
        )
        keep = postprocess_native(arr)
        if keep is not None:
            return [b for b, k in zip(blocks, keep) if k]
    res: list[Block] = []
    i = 0
    nb = len(blocks)
    while i < nb:
        for j in range(i + 1, min(i + 7, nb)):
            if (blocks[i].end - blocks[j].start) * 2 > (blocks[j].end - blocks[j].start):
                res.append(blocks[i])
                i = j + 1
                break
        if i < nb:
            res.append(blocks[i])
        i += 1
    return res


class PostprocessStream:
    """Incremental postprocess(): identical output, block-chunk granularity.

    The dedup rule (src/main.cpp:287-302) looks ahead at most 6 blocks, so
    a prefix is FINAL once 6 successors exist — enabling the pipeline to
    emit/rescore a giant read's early blocks while its later windows are
    still decomposing (DP/finishing overlap). push() returns newly
    finalized blocks; finish() flushes the tail. The concatenation of all
    returns equals postprocess(all pushed blocks) byte-for-byte (tested
    against both the Python and native batch implementations)."""

    def __init__(self) -> None:
        self._buf: list[Block] = []
        self._landing = False

    def _drain(self, final: bool) -> list[Block]:
        b = self._buf
        nb = len(b)
        res: list[Block] = []
        i = 0
        # a jump in the previous drain landed exactly one past the buffer:
        # its landing block must be emitted UNCONDITIONALLY (the reference
        # quirk), never re-run through the lookahead
        if self._landing and nb > 0:
            res.append(b[0])
            self._landing = False
            i = 1
        # in non-final mode only process index i when its full 6-block
        # lookahead window already exists — then the decision equals the
        # batch run's min(i+7, nb_total) window
        while i < nb and (final or i + 7 <= nb):
            jumped = False
            for j in range(i + 1, min(i + 7, nb)):
                if (b[i].end - b[j].start) * 2 > (b[j].end - b[j].start):
                    res.append(b[i])
                    i = j + 1
                    jumped = True
                    break
            if i < nb:
                res.append(b[i])
            elif jumped and not final:
                self._landing = True  # landing block arrives with a later push
            i += 1
        self._buf = b[min(i, nb):]
        return res

    def push(self, blocks: list[Block]) -> list[Block]:
        self._buf.extend(blocks)
        return self._drain(final=False)

    def finish(self) -> list[Block]:
        out = self._drain(final=True)
        assert not self._buf
        return out


def align_read_oracle(
    seq: str,
    mono: np.ndarray,
    mono_lens: np.ndarray,
    scoring: Scoring = Scoring(),
    part_size: int = 5000,
    overlap: int = 500,
) -> list[Block]:
    """Full per-read pipeline of the reference core: window, DP+traceback per
    window, shift to global coordinates (src/main.cpp:104-120), dedup."""
    codes = encode(seq)
    merged: list[Block] = []
    for off, ln in make_windows(len(seq), part_size, overlap):
        blocks = decompose_window_oracle(codes[off : off + ln], mono, mono_lens, scoring)
        for b in blocks:
            merged.append(Block(b.monomer, b.start + off, b.end + off, b.identity))
    return postprocess(merged)
