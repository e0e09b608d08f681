#!/usr/bin/env python3
"""Randomized stress of K1 and the walk on the card against the NumPy
oracle, the counterpart of scripts/stress_kernel.py.

The CPU twins cannot catch a kernel's indexing or synchronization fault,
and K1 has many more bodies on the card than the one Pallas kernel had:
`ops/chain_dp_cuda.body` routes a set to the lanes, tiled, cluster,
cluster_tiled, grid, grid_tiled or split body (and `force_body=` reaches
the chunked body and the large route's chunked body, "large"), each in
int32 and int16 state, through `cluster_plan`, `grid_plan`, `tiled_layout`
and `split_layout`. So each case first draws a stratum (a body and a state
type), then M, L, W and B inside the range where `body(M, L, state bytes)`
names that body, favouring its boundaries: L at 256/257 and 512/513, M at
the shared route's limit, at the last set one cluster of 16 blocks holds
and just past it, a row at one block's limit. Inside a case, as the JAX
script draws them: one of its four scorings, window lengths from 1 to W,
half the windows tandem copies of a drawn monomer with 10 % substitutions
and half uniform random; sometimes the per-window [B, M, L] monomer form
with rows masked to length 0, sometimes max_blocks=1. int16 draws only
scorings and sizes the int16 range checks admit; each run also checks that
an inadmissible one is refused.

Each window's blocks (ops/traceback.blocks_from_device) must equal
ops/oracle.decompose_window_oracle on that window and its monomers (the
masked rows left out, the indices mapped back). An overflow case
(max_blocks=1) is held to K1's plain twin instead, since the oracle has no
cap. On a mismatch the plain twin also runs, and the case says which of
kernel, twin and oracle disagrees. A launch error, a grid route's fault
word or the spin bound fails the case and is printed. On the card the case
also checks that the stratum's launch counter, and no other K1 body's,
moved.

Usage: python -m stringdecomposer_tpu_torch.scripts.stress_kernel [n_cases] [seed]
           [--device cpu] [--body NAME ...]
It runs on the card unless --device cpu is given (then the wrappers run
their plain twins, which are still held to the oracle); with cuda and no
card it exits 2. Prints one line a case, the cases per stratum and
"STRESS DONE: <n> failures in <s>s"; exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from ..io.fasta import RC_CODE
from ..ops import chain_dp as plain
from ..ops import chain_dp_cuda as k1
from ..ops.oracle import Scoring, decompose_window_oracle
from ..ops.traceback import blocks_from_device

# the JAX script's four scorings (ins, del, mismatch, match)
SCORINGS = ((-1, -1, -1, 1), (-2, -1, -3, 2), (-1, -2, -1, 3), (0, -1, -1, 1))
BODIES = ("lanes", "tiled", "chunked", "cluster", "cluster_tiled", "grid", "grid_tiled", "split",
          "large")
# (body, state bytes); a case draws them in this order, cycling
STRATA = tuple((b, sb) for b in BODIES for sb in (4, 2))
# the strata `body` never names: the chunked bodies (force_body=) and the
# split form in int16 (no set the int16 range check admits is past one
# block's row: forced through grid=(K, cs, S))
FORCED = {("chunked", 4), ("chunked", 2), ("large", 4), ("large", 2), ("split", 2)}
# the order of the bodies in M at a fixed L: shared, one cluster, grid, past the card
_RANK = {"lanes": 0, "tiled": 0, "cluster": 1, "cluster_tiled": 1, "grid": 2, "grid_tiled": 2,
         "split": 2, "large": 3, "chunked": 3}
# the oracle keeps a [W, M, L] int64 cube a window: at most this many bytes
ORACLE_BYTES = 512 << 20
# sets of more cells than this are "large": 1-3 windows of 48-128 positions
BIG_CELLS = 60_000
# a small set's oracle work a window: at most this many cell-positions
SMALL_WORK = 12_000_000


@dataclass
class Case:
    body: str
    sb: int
    M: int
    L: int
    W: int
    sc: tuple
    wins: list  # the windows' codes, true lengths
    mono: np.ndarray  # [M, L] or [B, M, L] int8
    lens: np.ndarray  # [M] or [B, M] int32
    max_blocks: int = 0
    grid: tuple | None = None
    note: str = ""

    @property
    def per_window(self) -> bool:
        return self.mono.ndim == 3

    @property
    def stratum(self) -> str:
        return f"{self.body}/{'int16' if self.sb == 2 else 'int32'}"

    def describe(self) -> str:
        extra = [f"grid={self.grid}"] if self.grid else []
        extra += ["per-window"] if self.per_window else []
        extra += [f"max_blocks={self.max_blocks}"] if self.max_blocks else []
        extra += [self.note] if self.note else []
        return (f"[{self.stratum}] M={self.M} L={self.L} W={self.W} B={len(self.wins)} "
                f"sc={self.sc}" + "".join(f" {e}" for e in extra))


def _first_m(L: int, sb: int, rank: int, hi: int) -> int:
    """The smallest M in [1, hi + 1] whose body's rank at (M, L) is at least
    `rank` (hi + 1: none up to hi); the ranks rise with M at a fixed L."""
    lo, top = 1, hi + 1
    while lo < top:
        mid = (lo + top) // 2
        if _RANK[k1.body(mid, L, sb)] >= rank:
            top = mid
        else:
            lo = mid + 1
    return lo


def m_range(body: str, L: int, sb: int, cap: int) -> tuple[int, int] | None:
    """[lo, hi] of the M up to `cap` whose set at L runs `body` (by its
    rank in M), or None where there is none."""
    r = _RANK[body]
    lo = _first_m(L, sb, r, cap)
    hi = _first_m(L, sb, r + 1, cap) - 1
    return (lo, hi) if lo <= hi else None


def split_start(sb: int, M: int = 1) -> int:
    """The shortest padded row L at which M rows run the split form (a row
    past one block's tiled form) at `sb` state bytes."""
    lo, hi = 513, 1 << 17
    while lo < hi:
        mid = (lo + hi) // 2
        if k1.body(M, mid, sb) == "split":
            hi = mid
        else:
            lo = mid + 1
    return lo


def _pick(rng, lo: int, hi: int, edges=()) -> int:
    """An int in [lo, hi]: half the time one of `edges` that lies there,
    else uniform."""
    edges = [e for e in edges if lo <= e <= hi]
    if edges and rng.random() < 0.5:
        return int(edges[int(rng.integers(len(edges)))])
    return int(rng.integers(lo, hi + 1))


def _admissible(W: int, L: int, sb: int) -> list:
    """The scorings the state type admits at window W and row L."""
    if sb == 4:
        return list(SCORINGS)
    return [sc for sc in SCORINGS if plain.int16_bounds_ok(W, L, *sc)
            and plain.int16_sentinel_ok(W, L, *sc)]


def _int16_max_l(W: int) -> int:
    """The longest row the int16 state admits at window W (unit scores)."""
    return (1 << 13) - 2 - W


def draw_shape(rng, body: str, sb: int, small: bool = False):
    """(M, L, note, grid) of a set that runs `body` at `sb` state bytes (the
    chunked bodies and the int16 split form: a set their forced launch
    takes). `small` (the lanes body only): M <= 12 rows of L <= 64."""
    lmax16 = _int16_max_l(128)
    if small:
        if body != "lanes":
            raise ValueError(f"small cases are the lanes body's, not {body}'s")
        L = _pick(rng, 1, 64, (8, 31, 32, 33))
        return _pick(rng, 1, 12, (1, 12)), L, "", None
    if body == "lanes" and rng.random() < 0.25:  # the shared route's last set at L = 192
        return m_range("lanes", 192, sb, 600)[1], 192, "shared route's limit", None
    if body in ("lanes", "cluster", "grid"):
        L = _pick(rng, 1, 512, (8, 32, 33, 192, 256, 257, 511, 512))
        cap = {"lanes": 600, "cluster": 6000, "grid": 8000}[body]
        rng_m = m_range(body, L, sb, cap)
        while rng_m is None:  # short rows reach no grid below the cap
            L = int(rng.integers(64, 513))
            rng_m = m_range(body, L, sb, cap)
        lo, hi = rng_m
        if body == "grid":  # past 16 blocks: keep the oracle's sets small
            hi = min(hi, lo + 400)
            M = _pick(rng, lo, hi, (lo, lo + 1))
            return M, L, "just past one cluster" if M == lo else "", None
        edges = (lo, hi, hi - 1, 32, 33)
        M = _pick(rng, lo, hi, edges)
        note = ("shared route's limit" if body == "lanes" and M == hi else
                "one cluster's last set" if body == "cluster" and M == hi else "")
        return M, L, note, None
    if body in ("tiled", "cluster_tiled", "grid_tiled"):
        L = _pick(rng, 513, 2100, (513, 514, 528, 544, 1024, 1025, 1040, 2056))
        cap = {"tiled": 200, "cluster_tiled": 3000, "grid_tiled": 4000}[body]
        if body == "tiled" and sb == 4 and rng.random() < 0.2:
            # a row at one block's limit: the longest row that is not split
            return 1, split_start(sb) - 1, "a row at one block's limit", None
        if body == "tiled" and rng.random() < 0.15:
            L = _pick(rng, 2100, 6000 if sb == 4 else lmax16)
        lo, hi = m_range(body, L, sb, cap)
        if body == "grid_tiled":
            hi = min(hi, lo + 300)
            M = _pick(rng, lo, hi, (lo, lo + 1))
            return M, L, "just past one cluster" if M == lo else "", None
        M = _pick(rng, lo, hi, (lo, hi))
        return M, L, "", None
    if body == "split" and sb == 4:
        start = split_start(sb)
        L = _pick(rng, start, start + 8000, (start, start + 1))
        lo, hi = m_range("split", L, sb, 3)
        note = "just past one block's row" if L == start else ""
        return _pick(rng, lo, hi), L, note, None
    if body == "split":  # int16: forced, a row over S blocks of a cluster
        M = int(rng.integers(1, 3))
        while True:
            L = int(rng.integers(513, lmax16 + 1))
            S = int(rng.integers(2, 5))
            if k1.grid_shape(M, L, sb, M, S, S) is not None:
                return M, L, "forced", (M, S, S)
    if body == "chunked":  # force_body="chunked": any set of the shared route
        L = _pick(rng, 1, 2100, (256, 257, 512, 513))
        hi = m_range("lanes" if L <= k1.LANES_MAX_L else "tiled", L, sb, 400)[1]
        return _pick(rng, 1, hi, (1, hi)), L, "forced", None
    # "large": force_body="large", the large route's chunked body
    L = _pick(rng, 1, 2100, (192, 512, 513))
    M = int(rng.integers(1, max(2, min(600, 400_000 // L)) + 1))
    return M, L, "forced", None


def _monomers(rng, M: int, L: int) -> tuple[np.ndarray, np.ndarray]:
    """M monomer rows padded to L: ceil(M / 2) random forward rows and their
    reverse complements after them, cut to M; the first row L long, the
    others of lengths near L or anywhere in [1, L]."""
    f = -(-M // 2)
    lens = np.where(rng.random(f) < 0.5, rng.integers(1, L + 1, f),
                    rng.integers(max(1, (4 * L) // 5), L + 1, f)).astype(np.int32)
    lens[0] = L
    fwd = np.full((f, L), 5, dtype=np.int8)
    rc = np.full((f, L), 5, dtype=np.int8)
    for j in range(f):
        row = rng.integers(0, 4, lens[j]).astype(np.int8)
        fwd[j, : lens[j]] = row
        rc[j, : lens[j]] = RC_CODE[row[::-1]]
    return np.concatenate([fwd, rc])[:M], np.concatenate([lens, lens])[:M]


def _window(rng, wl: int, unit: np.ndarray) -> np.ndarray:
    """A window of wl codes: tandem copies of `unit` with 10 % of positions
    redrawn, or (half the time) uniform random."""
    if rng.random() < 0.5 and len(unit):
        arr = np.tile(unit, wl // len(unit) + 2)[:wl].copy()
        idx = rng.integers(0, wl, max(1, wl // 10))
        arr[idx] = rng.integers(0, 4, len(idx))
        return arr.astype(np.int8)
    return rng.integers(0, 4, wl).astype(np.int8)


def draw_case(rng, body: str, sb: int, small: bool = False) -> Case:
    """One case of the stratum (body, state bytes); `small`: a lanes-body
    case of at most 12 rows of 64 cells, 3 windows of 48 positions (for the
    CPU tests against JAX). Asserts that `body` names the stratum for the
    drawn set (the forced strata aside)."""
    M, L, note, grid = draw_shape(rng, body, sb, small)
    if (body, sb) not in FORCED and k1.body(M, L, sb) != body:
        raise AssertionError(f"the generator drew M={M}, L={L} for {body}, which runs "
                             f"{k1.body(M, L, sb)}")
    cells = M * L
    if small:
        B, W = int(rng.integers(1, 4)), int(rng.integers(8, 49))
    elif cells > BIG_CELLS:
        B, W = int(rng.integers(1, 4)), int(rng.integers(48, 129))
    else:
        B = int(rng.integers(1, 9))
        W = int(rng.integers(16, max(17, min(260, SMALL_WORK // cells)) + 1))
    W = max(1, min(W, ORACLE_BYTES // (8 * cells)))
    if sb == 2:
        W = min(W, _int16_max_l(0) - L)
    scs = _admissible(W, L, sb)
    sc = scs[int(rng.integers(len(scs)))]
    mono, lens = _monomers(rng, M, L)
    per_window = rng.random() < 0.3
    if per_window:  # a row order of its own a window, some rows masked to length 0
        perm = np.stack([rng.permutation(M) for _ in range(B)])
        mono, full = mono[perm], lens[perm]
        lens = full.copy()
        for b in range(B):
            if M > 1:
                lens[b, rng.random(M) < rng.random() * 0.5] = 0
            if not lens[b].any():  # one row stays real
                j = int(rng.integers(M))
                lens[b, j] = full[b, j]
    wins = []
    for b in range(B):
        ln = lens[b] if per_window else lens
        row = int(rng.choice(np.flatnonzero(ln > 0)))
        unit = (mono[b] if per_window else mono)[row, : ln[row]]
        wl = W if b == 0 else int(rng.integers(1, W + 1))
        wins.append(_window(rng, wl, unit))
    max_blocks = 1 if rng.random() < 0.15 else 0
    return Case(body, sb, M, L, W, sc, wins, mono, lens, max_blocks, grid, note)


def plan_text(case: Case, dev) -> str:
    """The launch shape the case's body takes: C cells a lane (lanes), G
    warps x C cells a row (tiled), or the plan of `cluster_plan` /
    `grid_plan` (with the card's occupancy for the case's windows on a
    CUDA device; the int16 split form's forced grid) with its
    `tiled_layout` / `split_layout`."""
    M, L, sb, B = case.M, case.L, case.sb, len(case.wins)
    on_card = B if dev.type == "cuda" else None
    if case.body == "lanes":
        return f"C={-(-L // 32)}"
    if case.body == "tiled":
        return "G={} C={}".format(*k1.tiled_layout(M, L)[:2])
    if case.body in ("cluster", "cluster_tiled"):
        cs, R, form, threads, _ = k1._cluster_launch(M, L, sb, None, on_card)
        tiled = " G={} C={}".format(*k1.tiled_layout(R, L)[:2]) if form == "tiled" else ""
        return f"cs={cs} R={R} {form}{tiled}"
    if case.body in k1.GRID_BODIES:
        K, cs, S, R, form, threads, _ = k1._grid_launch(M, L, sb, case.body, case.grid, on_card)
        G, C, _ = k1.tiled_layout(R, L) if S == 1 else k1.split_layout(L, S)
        return f"K={K} cs={cs} S={S} R={R} {form}" + ("" if case.body == "grid" else f" G={G} C={C}")
    return ""


def _counters() -> dict:
    return {(fn.__name__, a): getattr(fn, a)
            for fn in (k1.chain_dp_forward_cuda, k1.chain_dp_large_cuda)
            for a in vars(fn) if a.startswith("launches")}


def expected_counter(case: Case) -> tuple[str, str]:
    """(wrapper, launch counter) of the case's body on the card."""
    dt = torch.int16 if case.sb == 2 else torch.int32
    if case.body in k1.SHARED_BODIES:
        kind = "" if case.body == "chunked" else case.body
        return "chain_dp_forward_cuda", k1._counter(dt, kind, case.L)
    kind = "" if case.body == "large" else case.body
    return "chain_dp_large_cuda", k1._counter(dt, kind, case.L)


def _inputs(case: Case, dev):
    wb, wl = plain.build_window_batch(case.wins, case.W)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (wb, wl, case.mono, case.lens)]


def _kw(case: Case) -> dict:
    ins, dele, mismatch, match = case.sc
    return dict(ins=ins, dele=dele, mismatch=mismatch, match=match, max_blocks=case.max_blocks,
                state_dtype="int16" if case.sb == 2 else "int32")


def run_kernel(case: Case, args):
    """K1 + walk on the case's body: (blocks, counts) as numpy."""
    kw = _kw(case)
    if case.body == "split" and case.sb == 2:
        out = k1.chain_dp_large_cuda(*args, grid=case.grid, **kw)
    elif (case.body, case.sb) in FORCED:
        out = k1.chain_dp_forward_cuda(*args, force_body=case.body, **kw)
    else:
        out = k1.chain_dp_forward_cuda(*args, **kw)
    return out[0].cpu().numpy(), out[1].cpu().numpy()


def run_twin(case: Case, args):
    out = plain.chain_dp_forward(*args, **_kw(case))
    return out[0].cpu().numpy(), out[1].cpu().numpy()


def oracle(case: Case, b: int) -> list[tuple]:
    """The oracle's (monomer, start, end, identity) of window b, over the
    window's rows of nonzero length, indices mapped back to the set's."""
    mono = case.mono[b] if case.per_window else case.mono
    lens = case.lens[b] if case.per_window else case.lens
    keep = np.flatnonzero(lens > 0)
    got = decompose_window_oracle(case.wins[b], mono[keep], lens[keep], Scoring(*case.sc))
    return [(int(keep[k.monomer]), k.start, k.end, k.identity) for k in got]


def _records(blocks, counts, b) -> list[tuple]:
    return [(g.monomer, g.start, g.end, g.identity)
            for g in blocks_from_device(blocks[b], int(counts[b]))]


def check_case(case: Case, dev) -> list[str]:
    """The case's mismatches (empty: it passed)."""
    args = _inputs(case, dev)
    before = _counters() if dev.type == "cuda" else None
    blocks, counts = run_kernel(case, args)
    bad = []
    if before is not None:
        after = _counters()
        moved = {k for k in after if after[k] != before[k]}
        want = expected_counter(case)
        if moved != {want}:
            bad.append(f"launch counters moved {sorted(moved)}, expected only {want}")
    if case.max_blocks:  # the oracle has no cap: the twin holds the overflow
        tb, tc = run_twin(case, args)
        if not (np.array_equal(blocks, tb) and np.array_equal(counts, tc)):
            rows = np.flatnonzero((blocks != tb).any(axis=(1, 2)) | (counts != tc))
            bad.append(f"max_blocks={case.max_blocks}: kernel != twin at windows "
                       f"{rows.tolist()[:8]}: counts {counts[rows[:4]].tolist()} vs "
                       f"{tc[rows[:4]].tolist()}")
        return bad
    twin = None
    for b in range(len(case.wins)):
        want, got = oracle(case, b), _records(blocks, counts, b)
        if got == want:
            continue
        if twin is None:
            twin = run_twin(case, args)
        tw = _records(*twin, b)
        who = ("the kernel (twin == oracle)" if tw == want else
               "the twin and kernel agree, the oracle differs" if tw == got else
               "all three differ")
        bad.append(f"window {b} (length {len(case.wins[b])}): {who}\n"
                   f"    kernel {got[:6]}\n    twin   {tw[:6]}\n    oracle {want[:6]}")
    return bad


def check_int16_refusal(rng, dev) -> list[str]:
    """An int16 run the range checks refuse must raise the 'unsafe'
    ValueError, before anything launches."""
    W, L = 300, _int16_max_l(300) + int(rng.integers(1, 200))
    mono, lens = _monomers(rng, 2, L)
    case = Case("lanes", 2, 2, L, W, SCORINGS[0], [rng.integers(0, 4, W).astype(np.int8)],
                mono, lens)
    try:
        run_kernel(case, _inputs(case, dev))
    except ValueError as e:
        return [] if "unsafe" in str(e) else [f"int16 refusal: wrong error {e}"]
    return [f"int16 at W={W}, L={L} was not refused"]


def main(argv: list[str] | None = None, counts: dict | None = None) -> int:
    """Runs the stress; `counts`, where given, is filled with the cases run
    per stratum ("body/int32" ...) and "failures"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_cases", nargs="?", type=int, default=40)
    ap.add_argument("seed", nargs="?", type=int, default=42)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--body", nargs="+", choices=BODIES, default=None)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("stress_kernel: torch.cuda.is_available() is False; this needs a GPU "
              "(or --device cpu)", file=sys.stderr)
        return 2
    dev = torch.device(a.device)
    rng = np.random.default_rng(a.seed)
    strata = [s for s in STRATA if not a.body or s[0] in a.body]
    per = {f"{b}/{'int16' if sb == 2 else 'int32'}": 0 for b, sb in strata}
    fails = 0
    t0 = time.perf_counter()
    if any(sb == 2 for _, sb in strata):
        bad = check_int16_refusal(rng, dev)
        fails += bool(bad)
        print("int16 refusal: " + ("; ".join(bad) if bad else "ok (ValueError 'unsafe')"),
              flush=True)
    for i in range(a.n_cases):
        body, sb = strata[i % len(strata)]
        case = draw_case(rng, body, sb)
        t = time.perf_counter()
        try:
            bad = check_case(case, dev)
        except Exception:  # noqa: BLE001 - a launch error or fault word fails the case
            bad = ["raised:\n" + traceback.format_exc()]
        per[case.stratum] += 1
        fails += bool(bad)
        state = "MISMATCH" if bad else "ok"
        print(f"case {i} {case.describe()} {plan_text(case, dev)}: {state} "
              f"({time.perf_counter() - t:.2f} s)", flush=True)
        for line in bad:
            print("  " + line, flush=True)
    print("cases per stratum: " + ", ".join(f"{k} {v}" for k, v in per.items()))
    print(f"STRESS DONE: {fails} failures in {time.perf_counter() - t0:.0f}s", flush=True)
    if counts is not None:
        counts.update(per, failures=fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
