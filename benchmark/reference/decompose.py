"""The plain reference over regions of sequences: the raw, final and alt rows
of StringDecomposer whose block starts in [lo, hi).

A region is consecutive windows w0..w1 of a read. Blocks of one window
never overlap each other, so the halo dedup decides only between the last
few blocks of a window and the first few of the next: the rows from the
middle of w0 (its start, for the read's first window) to the middle of w1
(the read's end, for its last window) depend on these windows alone.
"""

from __future__ import annotations

import torch

from .chain_dp import dp_cube, make_windows, pad_monomers, postprocess, raw_rows, traceback
from .fasta import dp_order, encode, finishing_order
from .finish import final_rows

# the most bytes of DP cube computed at once (int32 on the device)
CUBE_BYTES = 2.5e9


def region_bounds(read_len: int, w0: int, n_win: int, part_size: int,
                  overlap: int) -> tuple[int, int, int, int]:
    """(w0, w1, lo, hi) of the region of up to n_win windows from w0."""
    wins = make_windows(read_len, part_size, overlap)
    w1 = min(w0 + n_win - 1, len(wins) - 1)
    lo = 0 if w0 == 0 else wins[w0][0] + part_size // 2
    hi = read_len + 1 if w1 == len(wins) - 1 else wins[w1][0] + part_size // 2
    return w0, w1, lo, hi


def window_blocks(windows: list, mono, mono_lens, scoring, device, ties: str) -> list[list]:
    """The traceback's blocks of each window (codes), as many windows a DP
    call as CUBE_BYTES holds; each cube comes to the host in int16 when its
    values fit."""
    out = []
    per = 4 * max(len(w) for w in windows) * mono.size if windows else 1
    step = max(1, int(CUBE_BYTES // per))
    for b0 in range(0, len(windows), step):
        part = windows[b0 : b0 + step]
        cube = dp_cube(part, mono, mono_lens, scoring, device)
        lo, hi = int(cube.amin()), int(cube.amax())
        if -(1 << 15) <= lo and hi < (1 << 15):
            cube = cube.to(torch.int16)
        for b, w in enumerate(part):
            dp = cube[b, : len(w)].cpu().numpy()
            out.append(traceback(w, mono, mono_lens, dp, scoring, ties))
        del cube
    return out


def regions_rows(items: list[tuple[str, str, tuple[int, int, int, int]]],
                 monomers: list[tuple[str, str]], cfg: dict, device,
                 ties: str = "first", prefer: str = "up") -> list[dict[str, list[str]]]:
    """For each (read name, read, region): {"raw", "final", "alt"}, the
    rows (without newlines) whose block starts in [lo, hi). `cfg` holds
    batch_size, overlap, scoring ("ins,del,mismatch,match") and
    second_best. `ties` and `prefer` as in chain_dp.traceback and
    nw_identity.nw_counts."""
    scoring = tuple(int(x) for x in cfg["scoring"].split(","))
    dp_set = dp_order(monomers)
    names = [n for n, _ in dp_set]
    mono, mono_lens = pad_monomers([s for _, s in dp_set])
    wins, owner = [], []
    for r, (_, read, (w0, w1, _, _)) in enumerate(items):
        codes = encode(read)
        for off, n in make_windows(len(read), cfg["batch_size"], cfg["overlap"])[w0 : w1 + 1]:
            wins.append(codes[off : off + n])
            owner.append((r, off))
    blocks_of = window_blocks(wins, mono, mono_lens, scoring, device, ties)
    merged: list[list[list]] = [[] for _ in items]
    for (r, off), blocks in zip(owner, blocks_of):
        merged[r] += [[m, s + off, e + off, ident] for m, s, e, ident in blocks]
    raws, fins = [], []
    for (name, read, (_, _, lo, hi)), blocks in zip(items, merged):
        blocks = postprocess(blocks)
        keep = [i for i, blk in enumerate(blocks) if lo <= blk[1] < hi]
        rows = raw_rows(name, blocks, names)
        raws.append([rows[i] for i in keep])
        fins.append((name, read, [(names[blocks[i][0]], blocks[i][1], blocks[i][2]) for i in keep]))
    finished = final_rows(fins, finishing_order(monomers), cfg["second_best"], device, prefer)
    return [{"raw": raw, "final": [r.rstrip("\n") for r in final],
             "alt": [r.rstrip("\n") for r in alt]} for raw, (final, alt) in zip(raws, finished)]


def rows_in(path: str, read_name: str, lo: int, hi: int) -> list[str]:
    """The rows of a TSV of the program for `read_name` whose start (the
    third column) lies in [lo, hi), in file order."""
    out = []
    with open(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if cols[0] == read_name and lo <= int(cols[2]) < hi:
                out.append(line.rstrip("\n"))
    return out


def rows_differ(got: list[str], want: list[str]) -> int:
    """Rows that differ at the same place, and rows one side lacks."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
