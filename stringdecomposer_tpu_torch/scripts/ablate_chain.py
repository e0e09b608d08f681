#!/usr/bin/env python3
"""Ablation bench of K1 on the card, the counterpart of scripts/ablate_chain.py.

Each variant is K1's chunked kernel body (csrc/chain_dp.cuh) with one
cost centre removed at compile time (csrc/chain_dp_ablate.cu;
ops/chain_dp.VARIANTS): the chain max and its barriers (nochain), the warp
scans' depth and chunk carry (ladder4, ladder2), the per-position emit
(noemit), the diagonal shift (noshift). `base` is the chunked body itself,
which K1 runs on the large route and on the shared route at L > 256 (the
shared route at L <= 256 runs the lanes body, csrc/chain_dp_lanes.cuh,
which the bench does not take apart). The outputs of every variant but
base are knowingly wrong: the times are what the bench is for. Each variant's
kernel is checked bit-equal to its plain PyTorch version first (`check`).

The inputs mirror the JAX bench's main(): seeded random codes, monomers of
length 180 padded to L = 192 (shared by all windows), a random int32
column 0 in [-200, 0), start pointers 0, scoring (-1, -1, -1, 1). Shapes:
B = 168 windows x W = 5,504 positions at M = 24 (K1's shared route) and at
M = 264 (the large route). For each shape the bench prints the card's name
and power limit, then per variant the wall of one call (CUDA events around
the kernel launches alone) and us per position step = wall / (W - 1), as
min / median / max.

Usage: python -m stringdecomposer_tpu_torch.scripts.ablate_chain [variant ...]
Variants: base nochain ladder4 ladder2 noemit noshift (default: all)
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import chain_dp as plain
from ..ops.chain_dp_cuda import chain_dp_ablate_cuda

# JAX variants that are TPU formulations of base's own function
TPU_ONLY = {
    "subroll": "a sublane-roll form of the chain group max",
    "unroll8": "an 8x unroll of the position loop",
    "hoist": "the diag roll hoisted across unrolled substeps",
    "chain3d": "named in the JAX bench's usage, where it runs base's kernel unchanged",
}
SCORING = dict(ins=-1, dele=-1, mismatch=-1, match=1)
MONO_LEN, L = 180, 192
SHAPES = (("shared route", 168, 5504, 24, False), ("large route", 168, 5504, 264, True))


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


def check(variants, device, B=5, W=300, M=40, seed=1) -> dict[str, int]:
    """Each variant on both routes against its plain version at a small
    shape (M = 40 fits the shared route; the large route runs the same
    inputs). Returns the largest absolute difference per variant (integers:
    the tolerance is 0); raises on any difference."""
    windows, mono, lens, dp0 = make_inputs(B, W, M, seed, device)
    err = {}
    for v in variants:
        want = plain.chain_dp_ablate(windows, mono, lens, dp0, v, **SCORING)
        for large in (False, True):
            got = chain_dp_ablate_cuda(windows, mono, lens, dp0.clone(), v, large, **SCORING)
            e = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            err[v] = max(err.get(v, 0), e)
            if e:
                raise AssertionError(f"ablation {v} ({'large' if large else 'shared'} route): "
                                     f"max abs error {e} (tolerance 0)")
    return err


def time_variant(v: str, inputs, large: bool, reps: int) -> list[float]:
    """Milliseconds per call of variant v's kernels (CUDA events around the
    launches; the column 0 copy the large route consumes and the output
    buffers are prepared outside them), after one warm-up call."""
    windows, mono, lens, dp0 = inputs
    B, W = windows.shape
    out = tuple(torch.zeros((B, W, mono.shape[0]), dtype=torch.int32, device=windows.device)
                for _ in range(2))
    col0 = dp0.clone()
    ms = []
    for r in range(reps + 1):
        col0.copy_(dp0)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        chain_dp_ablate_cuda(windows, mono, lens, col0, v, large, out=out, **SCORING)
        b.record()
        torch.cuda.synchronize()
        if r:
            ms.append(a.elapsed_time(b))
    return ms


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def bench(variants, reps: int = 5, seed: int = 0, out=print, shapes=SHAPES) -> dict:
    """The timing table: {(shape name, variant): [ms, ...]} at `shapes`
    (SHAPES, the JAX bench's, unless a caller cuts them)."""
    res = {}
    for name, B, W, M, large in shapes:
        out(card())
        out(f"{name}: B = {B} windows x W = {W} positions, M = {M}, L = {L}, "
            f"monomer length {MONO_LEN}, {reps} timed calls after a warm-up")
        inputs = make_inputs(B, W, M, seed, "cuda")
        for v in variants:
            ms = time_variant(v, inputs, large, reps)
            res[(name, v)] = ms
            us = [x * 1e3 / (W - 1) for x in ms]
            out(f"  {v:8s} wall {min(ms):9.3f} / {statistics.median(ms):9.3f} / {max(ms):9.3f} ms"
                f"   {min(us):7.3f} / {statistics.median(us):7.3f} / {max(us):7.3f} us/step")
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
    print(f"check: every variant bit-equal to its plain version on both routes {err}")
    bench(variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
