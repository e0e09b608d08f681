#!/usr/bin/env python3
"""K1 + walk (`chain_dp_forward_cuda`) of one checkout of this repo, timed
on the card, for an A/B of two commits on one card.

Unpack the other commit's port into a directory that .gitignore lists
(`mkdir -p build/parent && git archive <commit> stringdecomposer_tpu_torch |
tar -x -C build/parent`), then, in one chip call, run this script once per
turn, parent, change, change, parent, each in a fresh process:

    python3 stringdecomposer_tpu_torch/scripts/k1_ab.py build/parent
    python3 stringdecomposer_tpu_torch/scripts/k1_ab.py .

ROOT is the directory that holds the checkout's `stringdecomposer_tpu_torch`;
that package, with the kernels its own runtime/build.py builds, is what
runs. Inputs: the golden read's 19 windows (5,000 bp with a 500 bp overlap,
padded to 5,500) against DXZ1 with RC (M = 24, L = 192), and against
M = 64 and M = 128 rows of DXZ1 variants (monomer j % 12 with 5 % random
substitutions, numpy.random.default_rng(0), with RC; L = 192), int32 state.
Per shape: one warm-up call, then REPS calls timed with CUDA events (ms)
and a digest of the blocks and counts, so that the turns can be held equal.
With `--scaling`, the shapes are instead the same windows against the first
M = 1, 2, 4, 8, 16, 24 rows of the DXZ1 set and against it and its first 8
rows again (M = 32; L = 192): how the time grows with the warps of a block.
With `--e2e`, the script instead runs the port end to end on the golden
read against DXZ1 (`pipeline.run`, `--second-best`, on the card), plain and
with `ed_thr=10` (run (i)): one warm-up run, then E2E_REPS runs timed on the
host clock up to a synchronize, then one run with the stage timer on for
its spans (`dp.gather` waits on K1).
Prints one JSON line: the checkout, the card's name and power limit, the
ptxas register and spill lines of its chain-DP kernels (from its build.log)
and the times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

from ab_common import DATA, checkout, e2e, ms

REPS = 10
E2E_REPS = 5


def shapes(fasta, oracle, chain_dp, scaling=False):
    """(name, windows, window lens, mono, mono lens) as numpy arrays."""
    import numpy as np

    codes = fasta.encode(fasta.load_fasta(str(DATA / "read.fa"))[0].seq)
    wins = [codes[o : o + n] for o, n in oracle.make_windows(len(codes), 5000, 500)]
    wb, wl = chain_dp.build_window_batch(wins, 5500)
    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    out = [("M=24", wb, wl, *fasta.pad_monomers(fasta.add_reverse_complement(dxz1), pad_to=192))]
    if scaling:
        mono, lens = out[0][3:]
        return [(f"M={M}", wb, wl, *_rows(mono, lens, M)) for M in (1, 2, 4, 8, 16, 24, 32)]
    rng = np.random.default_rng(0)
    for M in (64, 128):
        fwd = []
        for j in range(M // 2):
            seq = list(dxz1[j % len(dxz1)].seq)
            for p in rng.choice(len(seq), len(seq) // 20, replace=False):
                seq[p] = "ACGT".replace(seq[p], "")[int(rng.integers(3))]
            fwd.append(fasta.Record(f"v{j}", "".join(seq)))
        out.append((f"M={M}", wb, wl,
                    *fasta.pad_monomers(fasta.add_reverse_complement(fwd), pad_to=192)))
    return out


def _rows(mono, lens, M):
    """The set's first M rows, repeated past its end (DXZ1 with RC has 24)."""
    import numpy as np

    idx = np.arange(M) % len(lens)
    return mono[idx], lens[idx]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="directory holding the checkout's stringdecomposer_tpu_torch")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--scaling", action="store_true",
                      help="time M = 1 .. 32 rows of one set instead of the A/B shapes")
    what.add_argument("--e2e", action="store_true",
                      help="time the golden run and run (i) end to end instead")
    args = ap.parse_args()
    torch, res = checkout(args.root, "chain_dp", "k1_ab")
    from stringdecomposer_tpu_torch.io import fasta
    from stringdecomposer_tpu_torch.ops import chain_dp, oracle
    from stringdecomposer_tpu_torch.ops.chain_dp_cuda import chain_dp_forward_cuda

    if args.e2e:
        read, dxz1 = str(DATA / "read.fa"), str(DATA / "DXZ1_star_monomers.fa")
        res["e2e"] = e2e(torch, [("golden", read, dxz1, E2E_REPS, {}),
                                 ("run (i) ed_thr 10", read, dxz1, E2E_REPS, {"ed_thr": 10})])
        print(json.dumps(res))
        return 0
    dev = torch.device("cuda")
    cap = 5500 // 8
    res["shapes"] = {}
    for name, *arrays in shapes(fasta, oracle, chain_dp, args.scaling):
        a = [torch.from_numpy(x).to(dev) for x in arrays]
        blocks, counts = chain_dp_forward_cuda(*a, max_blocks=cap)
        digest = hashlib.sha256(blocks.cpu().numpy().tobytes() + counts.cpu().numpy().tobytes())
        res["shapes"][name] = {"M": int(a[2].shape[0]), "L": int(a[2].shape[1]),
                               "B": int(a[0].shape[0]), "W": int(a[0].shape[1]),
                               "ms": ms(torch, lambda: chain_dp_forward_cuda(*a, max_blocks=cap),
                                        REPS),
                               "digest": digest.hexdigest()[:16]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
