#!/usr/bin/env python3
"""Large monomer libraries (M >> 24) through K1 on the card: correctness
against the NumPy oracle at M = 128 and 256, then throughput against M,
the counterpart of scripts/stress_m_scale.py (real HOR sets run hundreds
of monomers).

Correctness: forward sets of 64 and 128 random monomers of 160-185 bp
(--quick: 64), with their reverse complements, against four tandem windows
of up to W = 320 each, every window's blocks equal to
ops/oracle.decompose_window_oracle. Throughput, on the card only: M = 24,
128, 256 and 512 (forward 12, 64, 128, 256; L = 192), B = max(24, 2048 //
M x 8) windows of W = 5,504 positions, tandem copies of the first monomer
with 5 % of positions redrawn, as the JAX script draws them. Each line
names the K1 body and plan the set takes, and gives K1 + walk's time from
CUDA events (one warm-up call, then min / median / max of 3), the
assignments (block records) a second and the DP cells a second. The header
gives the card's name and power limit.

Usage: python -m stringdecomposer_tpu_torch.scripts.stress_m_scale [--quick] [--device cpu]
It runs on the card unless --device cpu is given (correctness only, on the
plain twin); with cuda and no card it exits 2.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from ..io.fasta import Record, add_reverse_complement, encode, pad_monomers
from ..ops import chain_dp as plain
from ..ops import chain_dp_cuda as k1
from ..ops.oracle import Scoring, decompose_window_oracle
from ..ops.traceback import blocks_from_device
from .ab_common import gpu_header

ALPHA = np.array(list("ACGT"))
L = 192


def synth_monomers(m_fwd: int, rng, lo: int = 160, hi: int = 185) -> list[Record]:
    return [Record(f"m{j}", "".join(rng.choice(ALPHA, int(rng.integers(lo, hi)))))
            for j in range(m_fwd)]


def plan_of(M: int, B: int, dev) -> str:
    """The K1 body a set of M rows at L takes, with its cluster or grid plan
    for B windows on the card."""
    kind = k1.body(M, L, 4)
    if dev.type != "cuda":
        return kind
    if kind == "cluster":
        cs, R, form, threads, _ = k1._cluster_launch(M, L, 4, None, B)
        return f"{kind} (cs = {cs}, R = {R}, {form}, {threads} threads)"
    if kind in k1.GRID_BODIES:
        K, cs, S, R, form, threads, _ = k1._grid_launch(M, L, 4, kind, None, B)
        return f"{kind} (K = {K}, cs = {cs}, S = {S}, R = {R}, {form}, {threads} threads)"
    return kind


def correctness(rng, m_fwd: int, dev) -> int:
    monomers = add_reverse_complement(synth_monomers(m_fwd, rng))
    M = len(monomers)
    mono, lens = pad_monomers(monomers, pad_to=L)
    W = 320
    wins = []
    for _ in range(4):
        unit = monomers[int(rng.integers(m_fwd))].seq
        arr = np.array(list((unit * (W // len(unit) + 2))[: int(rng.integers(W // 2, W))]))
        idx = rng.integers(0, len(arr), max(1, len(arr) // 12))
        arr[idx] = rng.choice(ALPHA, len(idx))
        wins.append(encode("".join(arr)))
    wb, wl = plain.build_window_batch(wins, W)
    args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
    bl, ct = (x.cpu().numpy() for x in k1.chain_dp_forward_cuda(*args))
    fails = 0
    for b in range(len(wins)):
        want = [(k.monomer, k.start, k.end, k.identity)
                for k in decompose_window_oracle(wins[b], mono, lens, Scoring())]
        got = [(g.monomer, g.start, g.end, g.identity) for g in blocks_from_device(bl[b], ct[b])]
        if got != want:
            fails += 1
            print(f"M={M} window {b}: MISMATCH\n  got  {got[:5]}\n  want {want[:5]}")
    print(f"M={M} ({plan_of(M, len(wins), dev)}): correctness vs oracle "
          f"{'ok' if not fails else 'FAILED'} ({len(wins)} windows)", flush=True)
    return fails


def throughput(rng, m_fwd: int) -> None:
    monomers = add_reverse_complement(synth_monomers(m_fwd, rng))
    M = len(monomers)
    mono, lens = pad_monomers(monomers, pad_to=L)
    W = 5504
    B = max(24, 2048 // M * 8)
    unit = monomers[0].seq
    base = np.array(list((unit * (W // len(unit) + 2))[:W]))
    wins = []
    for _ in range(B):
        arr = base.copy()
        idx = rng.integers(0, W, W // 20)
        arr[idx] = rng.choice(ALPHA, len(idx))
        wins.append(encode("".join(arr)))
    wb, wl = plain.build_window_batch(wins, W)
    args = [torch.from_numpy(a).cuda() for a in (wb, wl, mono, lens)]
    cap = W // 8
    out = k1.chain_dp_forward_cuda(*args, max_blocks=cap)  # warm-up
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = k1.chain_dp_forward_cuda(*args, max_blocks=cap)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    n_blocks = int(out[1].sum())
    med = statistics.median(ms)
    cells = B * (W - 1) * M * float(np.mean([len(m.seq) for m in monomers]))
    print(f"M={M:4d} {plan_of(M, B, torch.device('cuda'))}: B={B} x W={W}, {n_blocks} "
          f"assignments; K1 + walk min {min(ms):.3f} / median {med:.3f} / max {max(ms):.3f} ms "
          f"= {n_blocks / med * 1e3:.0f} assignments/s, {cells / med / 1e6:.2f} Gcells/s",
          flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("stress_m_scale: torch.cuda.is_available() is False; this needs a GPU "
              "(or --device cpu)", file=sys.stderr)
        return 2
    dev = torch.device(a.device)
    if dev.type == "cuda":
        print(gpu_header())
    rng = np.random.default_rng(17)
    t_all = time.perf_counter()
    fails = sum(correctness(rng, m_fwd, dev) for m_fwd in ([64] if a.quick else [64, 128]))
    if dev.type == "cuda" and not a.quick:
        for m_fwd in (12, 64, 128, 256):
            throughput(rng, m_fwd)
    print(f"M-SCALE DONE: {fails} failures in {time.perf_counter() - t_all:.0f}s")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
