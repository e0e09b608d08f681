"""The chain DP of StringDecomposer, plain: windows, the DP column by
column in PyTorch, the reference's traceback, the halo dedup, raw rows.

Adapted from stringdecomposer_tpu_torch/ops/oracle.py at commit 5ef96e3
(`make_windows`, `chain_dp_cube`, `traceback_cube`, `postprocess`), which
transcribes the reference core (src/main.cpp:73-79, 151-302). Changes: the
DP runs a batch of windows at once in int32 torch tensors on any device
(its scores stay within +-(window + monomer length), far inside int32; the
mask filler is -2^30, not -2^60); the traceback reads the cube in int32
and takes each chain value from the column's end cells at once. The rules
are the reference's, tie for tie.
"""

from __future__ import annotations

import numpy as np
import torch

from .fasta import PAD, encode

INF = -1_000_000  # src/main.cpp:156
NEG = -(1 << 30)  # filler for a candidate that does not exist


def make_windows(read_len: int, part_size: int, overlap: int) -> list[tuple[int, int]]:
    """(offset, length) of each window (src/main.cpp:73-79)."""
    out = []
    for i in range(0, read_len, part_size):
        if read_len - i >= overlap or read_len < overlap:
            out.append((i, min(part_size + overlap, read_len - i)))
    return out


def pad_monomers(seqs: list[str]) -> tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    mono = np.full((len(seqs), int(lens.max())), PAD, dtype=np.int8)
    for j, s in enumerate(seqs):
        mono[j, : len(s)] = encode(s)
    return mono, lens


def dp_cube(windows: list[np.ndarray], mono: np.ndarray, mono_lens: np.ndarray,
            scoring: tuple[int, int, int, int], device) -> torch.Tensor:
    """dp[b, i, j, k] (int32, on `device`) of each window b: the best score
    of a chain over window[0..i] whose last block is monomer j consumed
    through cell k (the recurrence of src/main.cpp:171-207, its deletion
    chain folded into a running max). Columns past a window's length hold
    values no real cell reads."""
    ins, dele, mismatch, match = scoring
    B, W = len(windows), max(len(w) for w in windows)
    M, L = mono.shape
    codes = np.full((B, W), PAD, dtype=np.int64)
    for b, w in enumerate(windows):
        codes[b, : len(w)] = w
    codes_t = torch.from_numpy(codes).to(device)
    mono_t = torch.from_numpy(mono.astype(np.int64)).to(device)
    # mm[c] = match / mismatch score of every monomer cell against code c
    mm_tab = torch.where(mono_t[None] == torch.arange(PAD + 1, device=device)[:, None, None],
                         match, mismatch).to(torch.int32)
    k = torch.arange(L, device=device, dtype=torch.int32)
    kdel = (k * dele)[None, None]
    end_mask = (k[None, :] == torch.from_numpy(mono_lens - 1).to(device)[:, None])[None]
    cube = torch.empty((B, W, M, L), dtype=torch.int32, device=device)
    mm = mm_tab[codes_t[:, 0]]
    cand = (k - 1) * dele + mm
    cand[..., 0] = mm[..., 0]
    prev = kdel + torch.cummax(cand - kdel, dim=-1).values
    cube[:, 0] = prev
    neg_col = torch.full((B, M, 1), NEG, dtype=torch.int32, device=device)
    for i in range(1, W):
        chain = torch.where(end_mask, prev, NEG).amax(dim=(1, 2))
        mm = mm_tab[codes_t[:, i]]
        enter = chain[:, None, None] + mm + kdel
        diag = torch.cat([neg_col, prev[..., :-1] + mm[..., 1:]], dim=-1)
        insr = torch.cat([neg_col, prev[..., 1:] + ins], dim=-1)
        cand = torch.maximum(enter, torch.maximum(diag, insr))
        prev = kdel + torch.cummax(cand - kdel, dim=-1).values
        cube[:, i] = prev
    return cube


def traceback(codes: np.ndarray, mono: np.ndarray, mono_lens: np.ndarray, dp: np.ndarray,
              scoring: tuple[int, int, int, int], ties: str = "first") -> list[list]:
    """Blocks [monomer, start, end, identity] of one window, by the
    reference's traceback (src/main.cpp:209-269): at a monomer cell
    deletion, then insertion (also at k == 0), then diagonal, then block
    entry, then a close without chain adjustment; a chain jump takes the
    first monomer whose end cell equals the chain value; a block's
    identity is dp[end] - chain[start], the window's first block keeps its
    raw value. `ties="last"` takes the last monomer of equal score instead
    (at the end and at each chain jump): the benchmark's control."""
    ins, dele, mismatch, match = scoring
    n, M, _ = dp.shape
    lens = [int(x) for x in mono_lens]
    ends = dp[:, np.arange(M), np.asarray(mono_lens) - 1]  # [n, M] end cells

    def chain_val(i: int) -> int:  # the chain value of column i (i >= 1)
        return max(INF, int(ends[i - 1].max()))

    best_m, max_score = M, INF
    for j in range(M):  # strict >: ties keep the smallest j
        if max_score < int(ends[n - 1, j]) or (ties == "last" and max_score == int(ends[n - 1, j])):
            max_score, best_m = int(ends[n - 1, j]), j
    ans: list[list] = []
    i, j = n - 1, best_m
    k = lens[j] - 1 if j != M else 0
    changed = True
    cur = None
    while i >= 0:
        if j != M and k == lens[j] - 1 and changed:
            cur = [j, i, i, float(dp[i, j, k])]
            changed = False
        if j == M:
            if i != 0:
                cv = chain_val(i)
                hits = np.flatnonzero(ends[i - 1] == cv)
                i -= 1
                if len(hits):
                    j = int(hits[0] if ties == "first" else hits[-1])
                    k = lens[j] - 1
            else:
                i -= 1
            continue
        v = int(dp[i, j, k])
        if k != 0 and v == int(dp[i, j, k - 1]) + dele:
            k -= 1
        elif i != 0 and v == int(dp[i - 1, j, k]) + ins:
            i -= 1
        else:
            mm = match if mono[j, k] == codes[i] else mismatch
            if i != 0 and k != 0 and v == int(dp[i - 1, j, k - 1]) + mm:
                i -= 1
                k -= 1
            else:
                changed = True
                cv = chain_val(i) if i != 0 else INF
                cur[1] = i
                if i != 0 and cv + k * dele + mm == v:
                    cur[3] -= float(cv)
                    ans.append(cur)
                    j, k = M, 0
                else:
                    ans.append(cur)
                    i -= 1
    ans.reverse()
    return ans


def postprocess(blocks: list[list]) -> list[list]:
    """Halo-duplicate suppression (src/main.cpp:287-302): within a look-ahead
    of 6 blocks, if block i covers more than half of block j, keep i and
    resume at j + 1, which is kept without its own check."""
    res = []
    i, nb = 0, len(blocks)
    while i < nb:
        for j in range(i + 1, min(i + 7, nb)):
            if (blocks[i][2] - blocks[j][1]) * 2 > (blocks[j][2] - blocks[j][1]):
                res.append(blocks[i])
                i = j + 1
                break
        if i < nb:
            res.append(blocks[i])
        i += 1
    return res


def raw_rows(read_name: str, blocks: list[list], names: list[str], prev_end: int = 0) -> list[str]:
    """Raw TSV rows (src/main.cpp:272-285): the identity as C++
    std::to_string(float) prints it, the gap to the previous block's end,
    the block's span."""
    rows = []
    for m, s, e, ident in blocks:
        rows.append(f"{read_name}\t{names[m]}\t{s}\t{e}\t{ident:.6f}\t{s - prev_end}\t{e - s}")
        prev_end = e
    return rows
