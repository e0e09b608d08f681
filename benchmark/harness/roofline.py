"""The card's peaks and the least time K1 and K2 could take for the work
of a run.

The peaks and `bound` are copied from chip_smoke.py at commit 5ef96e3
(HBM_BYTES_PER_S, INT32_OPS_PER_S, OPS_PER_CELL["k1"] and ["k2"], bound):
HBM at 3.35 TB/s; int32 at 64 INT32 lanes a SM a clock (half the 128
FP32 lanes behind the datasheet's 67 TFLOP/s float32, which counts an FMA
as 2) x 132 SMs x 1.98 GHz = 16.73 T ops/s (H100 SXM datasheet, 700 W).
Operations a DP cell, from each recurrence itself:
  K1, 15: match test and select 2; the diagonal, insertion, deletion and
    entry adds 4; three maxima 3; the start pointer's three compares and
    three selects 6;
  K2, 11: match test 1, three candidates 3, two minima 2, the column
    count's preference 2 compares + 2 selects + 1 add.
Corrected from chip_smoke: K1 counts each window's real positions times
the real lengths of the monomer rows it runs against (no padded width);
bytes are each call's inputs read once and its outputs (block records and
counts; (D, columns) pairs) written once, no intermediate of a route.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
OPS_PER_CELL = {"k1": 15, "k2": 11}


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the int32 operations over the int32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def k1_job(window_lens: list[int], mono_lens: list[int]) -> dict:
    """K1's work for one job from its inputs: every window's real
    positions against every DP row's real length. The block records'
    bytes are added from the run's outputs (k1_records)."""
    pos = int(sum(window_lens))
    cells = pos * int(sum(mono_lens))
    return {"ops": OPS_PER_CELL["k1"] * cells,
            "bytes": pos + len(mono_lens) * (max(mono_lens) + 4) + 4 * len(window_lens)}


def homo_prefix(codes: np.ndarray) -> np.ndarray:
    """P[i] = runs started in codes[1..i]: a block [s, s + n) collapses to
    1 + P[s + n - 1] - P[s] bases."""
    change = np.concatenate(([0], (codes[1:] != codes[:-1]).astype(np.int64)))
    return np.cumsum(change)


def k2_packed(starts: np.ndarray, lens: np.ndarray, prefix: np.ndarray, raw_sum: int,
              homo_sum: int, M: int, mono_bytes: int) -> dict:
    """K2's work for one packed call (--second-best): each block, raw and
    homopolymer-compressed, against every monomer in the same form."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    hlens = 1 + prefix[starts + lens - 1] - prefix[starts]
    cells = int(lens.sum()) * raw_sum + int(hlens.sum()) * homo_sum
    return {"ops": OPS_PER_CELL["k2"] * cells,
            "bytes": int(lens.sum() + hlens.sum()) + mono_bytes + 2 * len(lens) * M * 2 * 4}


def k2_pairs(cells: int, q_bases: int, t_bases: int, pairs: int) -> dict:
    """K2's work for one pairwise call (light mode): each block against
    its own monomer; (matches, columns, distance) written a pair."""
    return {"ops": OPS_PER_CELL["k2"] * cells, "bytes": q_bases + t_bases + 8 * pairs + 12 * pairs}
