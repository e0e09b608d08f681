#!/usr/bin/env python3
"""Randomized stress of K2 (NW identity) and K3 (the --ed_thr pre-filter's
HW distance) on the card against their plain twins and the O(n^2) spec,
the counterpart of scripts/stress_rescoring.py.

K2 (ops/identity_cuda.py) runs a warp a pair with C = ceil(Lq / 32) query
rows a lane, one instance for each C from 1 to 16, and strips of 512 rows
past that; it has a pairwise entry and a cross entry (every query row
against every target row). Each case draws its Lq so that the cases cycle
through every C and the strip form, and holds both entries to the twins
ops/identity.nw_identity_batch and nw_identity_cross; three pairs a case
also go to ops/identity.nw_path_spec. Target lengths of 0 are drawn, as
in the JAX script.

K3 (ops/hw_filter_cuda.py) has three routes by the monomers' padded L
(thread to 512, warp to 16,384, wide past it) and cuts the windows into
segments on the thread and warp routes (hw_segment_plan, or seg_cols=).
Each case draws a route and, on those two, one segment or several (the
card's own plan where it takes that many, else seg_cols forced), with L at
the routes' edges 512/513 and 16,384/16,385 half the time, and holds the
kernel to the cell-DP twin ops/hw_filter.hw_distance_batch (not the Myers
mirror, so the check stays independent of the kernel's formulation).

On the card each launch must move its own counter. A launch error fails
the case and is printed.

Usage: python -m stringdecomposer_tpu_torch.scripts.stress_rescoring [n_cases] [seed]
           [--device cpu]
It runs on the card unless --device cpu is given (the wrappers then run
their twins; the spec check still holds); with cuda and no card it exits
2. Prints one line a case, the cases per K2 C and entry and per K3 route
and segment count, and "STRESS DONE: <n> failures in <s>s"; exits 1 on any
failure.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch

from ..ops import hw_filter as k3_plain
from ..ops import hw_filter_cuda as k3
from ..ops import identity as k2_plain
from ..ops import identity_cuda as k2

# K2's strata: C = 1..16 rows a lane, then the strip form past 512 rows
K2_STRATA = tuple(f"C={c}" for c in range(1, k2.C_MAX + 1)) + ("strips",)
# K3's strata: (route, segments) on the thread and warp routes; the wide
# route takes no segments
K3_STRATA = (("thread", "one"), ("thread", "several"), ("warp", "one"), ("warp", "several"),
             ("wide", "one"))
K3_EDGES = {"thread": (1, 4, 31, 32, 33, 511, 512), "warp": (513, 514, 16383, 16384),
            "wide": (16385, 16386)}
K3_SPAN = {"thread": (1, 512), "warp": (513, 16384), "wide": (16385, 20000)}


def k2_lq(rng, stratum: str) -> int:
    """A padded query width that gives the stratum's C (or the strips)."""
    if stratum == "strips":
        return int(rng.integers(32 * k2.C_MAX + 1, 1100))
    c = int(stratum[2:])
    return int(rng.integers(max(1, 32 * (c - 1) + 1), 32 * c + 1))


def draw_k2(rng, stratum: str):
    """(q, q_lens, t, t_lens) numpy arrays of a pairwise case: P pairs of
    random codes (the padding random too), query lengths 1..Lq, target
    lengths 0..Lt."""
    P = int(rng.integers(3, 40)) * 8
    Lq, Lt = k2_lq(rng, stratum), int(rng.integers(2, 220))
    q = rng.integers(0, 4, size=(P, Lq), dtype=np.int8)
    t = rng.integers(0, 4, size=(P, Lt), dtype=np.int8)
    ql = rng.integers(1, Lq + 1, size=P).astype(np.int32)
    tl = rng.integers(0, Lt + 1, size=P).astype(np.int32)
    ql[0] = Lq
    return q, ql, t, tl


def draw_k3(rng, route: str, segs: str):
    """(windows, window_lens, mono, mono_lens) of a K3 case on `route`; its
    segments are chosen by `k3_segments`, where the card's plan is known."""
    lo, hi = K3_SPAN[route]
    L = int(rng.choice(K3_EDGES[route])) if rng.random() < 0.5 else int(rng.integers(lo, hi + 1))
    if route == "wide" and rng.random() < 0.1:  # past 131,072 rows: two bands of stages
        L = 131_073
    big = L > 2048
    B, M = (int(rng.integers(1, 3)), int(rng.integers(1, 4))) if big else \
        (int(rng.integers(1, 5)), int(rng.integers(1, 6)))
    W = int(rng.integers(40 if segs == "several" else 4, 300))
    wins = rng.integers(0, 4, size=(B, W), dtype=np.int8)
    wl = rng.integers(1, W + 1, size=B).astype(np.int32)
    wl[0] = W
    mono = np.full((M, L), 5, dtype=np.int8)
    lens = rng.integers(1, L + 1, size=M).astype(np.int32)
    lens[0] = L
    for j in range(M):
        mono[j, : lens[j]] = rng.integers(0, 4, size=lens[j], dtype=np.int8)
    return wins, wl, mono, lens


def k3_segments(rng, dev, route, segs, B, M, L, W):
    """(seg_cols, segments a pair) for a K3 case: the card's own plan
    (seg_cols None) half the time where it takes the stratum's count, else
    seg_cols forced: 0 (one) or a multiple of 16 below W (several)."""
    if route == "wide":
        return None, 1
    if dev.type == "cuda" and rng.random() < 0.5:
        card = torch.cuda.current_device() if dev.index is None else dev.index
        _, nseg, _ = k3.plan(B, M, L, W, card, route)
        if (nseg > 1) == (segs == "several"):
            return None, nseg
    if segs == "one":
        return 0, 1
    S = 16 * int(rng.integers(1, (W - 1) // 16 + 1))
    return S, k3_plain.segments(W, S)[0]


def _same(*pairs) -> bool:
    return all(torch.equal(a.cpu(), b.cpu()) for a, b in pairs)


def check_k2(rng, stratum: str, dev) -> tuple[list[str], str]:
    q, ql, t, tl = draw_k2(rng, stratum)
    args = [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)]
    bad = []
    before = (k2.nw_identity_batch_cuda.launches, k2.nw_identity_cross_cuda.launches)
    got = k2.nw_identity_batch_cuda(*args)
    want = k2_plain.nw_identity_batch(*args)
    if not _same(*zip(got, want)):
        d1, m1, l1 = (x.cpu().numpy() for x in got)
        d0, m0, l0 = (x.cpu().numpy() for x in want)
        p = int(np.flatnonzero((d0 != d1) | (m0 != m1) | (l0 != l1))[0])
        bad.append(f"pairwise entry pair {p} (ql {ql[p]}, tl {tl[p]}): got "
                   f"{d1[p], m1[p], l1[p]} want {d0[p], m0[p], l0[p]}")
    d0, m0, l0 = (x.cpu().numpy() for x in want)
    for p in rng.integers(0, len(q), 3):
        spec = k2_plain.nw_path_spec(q[p, : ql[p]], t[p, : tl[p]])
        if spec != (int(d0[p]), int(m0[p]), int(l0[p])):
            bad.append(f"spec pair {p}: {spec} vs the twin {d0[p], m0[p], l0[p]}")
    # the cross entry: the first Nb queries against the first Mt targets
    Nb, Mt = int(rng.integers(1, 9)), int(rng.integers(1, 7))
    cross = [args[0][:Nb], args[1][:Nb], args[2][:Mt], args[3][:Mt]]
    got_x = k2.nw_identity_cross_cuda(*cross)
    if not _same((got_x, k2_plain.nw_identity_cross(*cross))):
        bad.append(f"cross entry {Nb} x {Mt}: differs from the twin")
    if dev.type == "cuda":
        after = (k2.nw_identity_batch_cuda.launches, k2.nw_identity_cross_cuda.launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 1):
            bad.append(f"K2 launches {before} -> {after}, expected one of each entry")
    form = "strips" if q.shape[1] > 32 * k2.C_MAX else f"C={k2.cells_per_lane(q.shape[1])}"
    return bad, f"P={len(q)} Lq={q.shape[1]} Lt={t.shape[1]} {form} cross {Nb}x{Mt}"


def check_k3(rng, route: str, segs: str, dev) -> tuple[list[str], str, int]:
    wins, wl, mono, lens = draw_k3(rng, route, segs)
    (B, W), (M, L) = wins.shape, mono.shape
    seg_cols, nseg = k3_segments(rng, dev, route, segs, B, M, L, W)
    args = [torch.from_numpy(a).to(dev) for a in (wins, wl, mono, lens)]
    counter = k3._COUNTER[route]
    before = getattr(k3.hw_distance_batch_cuda, counter)
    got = k3.hw_distance_batch_cuda(*args, route=route, seg_cols=seg_cols)
    want = k3_plain.hw_distance_batch(*args)
    bad = []
    if not _same((got, want)):
        bad.append(f"route {route}: got\n    {got.cpu().tolist()}\n  want\n    "
                   f"{want.cpu().tolist()}")
    if dev.type == "cuda" and getattr(k3.hw_distance_batch_cuda, counter) - before != 1:
        bad.append(f"the {route} route's counter {counter} did not move by one")
    what = (f"B={B} M={M} L={L} W={W} {route}"
            + ("" if route == "wide" else f" seg_cols={seg_cols} ({nseg} segments)"))
    return bad, what, nseg


def main(argv: list[str] | None = None, counts: dict | None = None) -> int:
    """Runs the stress; `counts`, where given, is filled with the cases run
    per K2 stratum ("k2 C=1" ... "k2 strips"), per entry ("k2 batch", "k2
    cross"), per K3 stratum ("k3 thread/one" ...) and "failures"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_cases", nargs="?", type=int, default=12)
    ap.add_argument("seed", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("stress_rescoring: torch.cuda.is_available() is False; this needs a GPU "
              "(or --device cpu)", file=sys.stderr)
        return 2
    dev = torch.device(a.device)
    rng = np.random.default_rng(a.seed)
    per = {f"k2 {s}": 0 for s in K2_STRATA}
    per.update({"k2 batch": 0, "k2 cross": 0})
    per.update({f"k3 {r}/{s}": 0 for r, s in K3_STRATA})
    fails = 0
    t0 = time.perf_counter()
    for case in range(a.n_cases):
        k2_s = K2_STRATA[case % len(K2_STRATA)]
        route, segs = K3_STRATA[case % len(K3_STRATA)]
        t = time.perf_counter()
        bad, what2, what3 = [], "?", "?"
        try:
            b2, what2 = check_k2(rng, k2_s, dev)
            bad += ["K2 " + x for x in b2]
            per[f"k2 {k2_s}"] += 1
            per["k2 batch"] += 1
            per["k2 cross"] += 1
            b3, what3, nseg = check_k3(rng, route, segs, dev)
            bad += ["K3 " + x for x in b3]
            per[f"k3 {route}/{'several' if nseg > 1 else 'one'}"] += 1
        except Exception:  # noqa: BLE001 - a launch error fails the case
            bad.append("raised:\n" + traceback.format_exc())
        fails += bool(bad)
        print(f"case {case}: {'MISMATCH' if bad else 'done'} (K2 {what2} | K3 {what3}) "
              f"({time.perf_counter() - t:.2f} s)", flush=True)
        for line in bad:
            print("  " + line, flush=True)
    print("K2 cases per C: " + ", ".join(f"{s} {per['k2 ' + s]}" for s in K2_STRATA)
          + f"; per entry: batch {per['k2 batch']}, cross {per['k2 cross']}")
    print("K3 cases per route: " + ", ".join(f"{r}/{s} {per[f'k3 {r}/{s}']}"
                                              for r, s in K3_STRATA))
    print(f"STRESS DONE: {fails} failures in {time.perf_counter() - t0:.0f}s", flush=True)
    if counts is not None:
        counts.update(per, failures=fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
