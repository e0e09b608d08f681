#!/usr/bin/env python3
"""Ablation bench of K1 on the card, the counterpart of scripts/ablate_chain.py.

The JAX bench takes K1's production kernel apart by dropping one cost
centre at a time. Here the two bodies that carry K1's main path are taken
apart the same way (csrc/chain_dp_ablate.cu; ops/chain_dp.VARIANTS): the
lanes body (csrc/chain_dp_lanes.cuh, the shared route: the golden run's
`chain_dp_lanes_kernel<int, 6, kRegRows>`, M = 24) and the cluster body
(csrc/chain_dp_cluster.cuh, the large route: the library runs'
`chain_dp_cluster_kernel<int, 6, kRowsDense>`, M = 264, over clusters of
`cluster_plan`'s size for the batch). Each variant removes one cost centre
at compile time: the chain max with its barrier and exchange (nochain),
the depth of the pair scan over the 32 lane totals (ladder4, ladder2), the
per-position emit (noemit), the diagonal shift (noshift). `base` is K1's
own launch of the body. The outputs of every variant but base are
knowingly wrong: the times are what the bench is for. Before any time is
printed, each variant's kernel is checked bit-equal to its plain PyTorch
version on both bodies, at their bench forms and a small B and W (`check`).

The inputs mirror the JAX bench's main(): seeded random codes, monomers of
length 180 padded to L = 192 (shared by all windows), a random int32
column 0 in [-200, 0), start pointers 0, scoring (-1, -1, -1, 1); B = 168
windows x W = 5,504 positions. For each body the bench prints the card's
name and power limit, then per variant the wall of one call (CUDA events
around the launch alone; the variants timed in turn, a round at a time) as
min / median / max ms, the median in us a position (wall / (W - 1)), and
base - variant in ms and as a % of base (medians): the share of the body's
time that cost centre takes.

Usage: python -m stringdecomposer_tpu_torch.scripts.ablate_chain [variant ...]
Variants: base nochain ladder4 ladder2 noemit noshift (default: all)
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from ..ops import chain_dp as plain
from ..ops import chain_dp_cuda as k1
from ..ops.chain_dp_cuda import chain_dp_ablate_cuda
from .ab_common import gpu_header

# JAX variants that are TPU formulations of base's own function
TPU_ONLY = {
    "subroll": "a sublane-roll form of the chain group max",
    "unroll8": "an 8x unroll of the position loop",
    "hoist": "the diag roll hoisted across unrolled substeps",
    "chain3d": "named in the JAX bench's usage, where it runs base's kernel unchanged",
}
SCORING = dict(ins=-1, dele=-1, mismatch=-1, match=1)
MONO_LEN, L = 180, 192
B_BENCH, W_BENCH = 168, 5504
# (name, M, large): the body and its rows at the bench's form
BODIES = (("lanes body", 24, False), ("cluster body", 264, True))
SHAPES = tuple((name, B_BENCH, W_BENCH, M, large) for name, M, large in BODIES)


def make_inputs(B: int, W: int, M: int, seed: int, device) -> tuple:
    """(windows [B, W] int8, mono [M, L] int8, mono_lens [M] int32, dp0
    [B, M, L] int32) from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, 4, (B, W), dtype=np.int8)
    mono = rng.integers(0, 4, (M, L), dtype=np.int8)
    mono[:, MONO_LEN:] = 5  # the monomer pad code
    lens = np.full(M, MONO_LEN, dtype=np.int32)
    dp0 = rng.integers(-200, 0, (B, M, L), dtype=np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (windows, mono, lens, dp0))


def cluster_size(M: int, B: int, device) -> int:
    """The cluster body's cs for B windows of M rows: on the card the
    production plan's (`cluster_plan` with cudaOccupancyMaxActiveClusters);
    on the CPU the same rule with one block an SM (132 SMs), which is what
    the card schedules of the rows-in-shared-memory form (1,024 threads a
    block at up to 64 registers each)."""
    if torch.device(device).type == "cuda":
        return k1.cluster_plan(M, L, 4, B, lambda cs: k1.cluster_occupancy(M, L, 4, cs, B))[0]
    return k1.cluster_plan(M, L, 4, B, lambda cs: k1.SM_COUNT // cs)[0]


def parse_variants(names: list[str]) -> list[str]:
    """The variants to run; refuses the JAX bench's TPU-only variants and
    unknown names with a ValueError that says why."""
    for v in names:
        if v in TPU_ONLY:
            raise ValueError(
                f"variant {v!r} is {TPU_ONLY[v]}: a TPU formulation of base's own function, "
                "which has no separate form on the card (run 'base')")
        if v not in plain.VARIANTS:
            raise ValueError(f"unknown variant {v!r}; known: {', '.join(plain.VARIANTS)}")
    return list(names) or list(plain.VARIANTS)


def check(variants, device, B=2, W=64, seed=1) -> dict:
    """Each variant on both bodies against its plain version, at the bodies'
    bench forms (M = 24; M = 264 over the bench batch's cs) and B windows x
    W positions. Returns the largest absolute difference per (variant,
    large) (integers: the tolerance is 0); raises on any difference."""
    err = {}
    for name, M, large in BODIES:
        windows, mono, lens, dp0 = make_inputs(B, W, M, seed, device)
        cs = cluster_size(M, B_BENCH, device) if large else None
        for v in variants:
            want = plain.chain_dp_ablate(windows, mono, lens, dp0, v, **SCORING, cluster_size=cs)
            got = chain_dp_ablate_cuda(windows, mono, lens, dp0, v, large, **SCORING,
                                       cluster_size=cs)
            e = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            err[(v, large)] = e
            if e:
                raise AssertionError(f"ablation {v} ({name}): max abs error {e} (tolerance 0)")
    return err


def time_variants(variants, inputs, large: bool, reps: int, cs: int | None) -> dict:
    """{variant: milliseconds per call} of each variant's kernel (CUDA events
    around the launch; the output buffers are made outside them): one
    warm-up call each, then `reps` rounds that each time every variant once,
    in turn, so that a drift of the card's clock within a run falls on all
    of them alike."""
    windows, mono, lens, dp0 = inputs
    B, W = windows.shape
    outs = {v: tuple(torch.zeros((B, W, mono.shape[0]), dtype=torch.int32,
                                 device=windows.device) for _ in range(2)) for v in variants}
    ms = {v: [] for v in variants}
    for r in range(reps + 1):
        for v in variants:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            chain_dp_ablate_cuda(windows, mono, lens, dp0, v, large, out=outs[v],
                                 cluster_size=cs, **SCORING)
            b.record()
            torch.cuda.synchronize()
            if r:
                ms[v].append(a.elapsed_time(b))
    return ms


def bench(variants, reps: int = 5, seed: int = 0, out=print, shapes=SHAPES) -> dict:
    """The timing table: {(shape name, variant): [ms, ...]} at `shapes`
    (SHAPES, the JAX bench's, unless a caller cuts them), base first where
    it runs, so that each variant's share of it can be printed."""
    res = {}
    variants = sorted(variants, key=lambda v: v != "base")
    for name, B, W, M, large in shapes:
        cs = cluster_size(M, B, "cuda") if large else None
        out(gpu_header())
        out(f"{name}: B = {B} windows x W = {W} positions, M = {M}, L = {L}, monomer length "
            f"{MONO_LEN}{f', clusters of {cs} blocks' if large else ''}, {reps} timed calls "
            "after a warm-up, in rounds over the variants")
        inputs = make_inputs(B, W, M, seed, "cuda")
        for v, ms in time_variants(variants, inputs, large, reps, cs).items():
            res[(name, v)] = ms
            med = statistics.median(ms)
            line = (f"  {v:8s} {min(ms):9.3f} / {med:9.3f} / {max(ms):9.3f} ms  "
                    f"{med * 1e3 / (W - 1):7.3f} us/position")
            if (name, "base") in res and v != "base":
                base = statistics.median(res[(name, "base")])
                line += (f"  base - {v} {base - med:8.3f} ms "
                         f"({100 * (base - med) / base:6.2f} % of base)")
            out(line)
    return res


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        variants = parse_variants(argv)
    except ValueError as e:
        print(f"ablate_chain: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ablate_chain: needs a CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    err = check(variants, "cuda")
    print(f"check: every variant bit-equal to its plain version on both bodies "
          f"(max abs errors {err})")
    bench(variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
