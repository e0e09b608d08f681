#!/usr/bin/env python3
"""K2 (NW identity) of one checkout of this repo, timed on the card, for an
A/B of two commits on one card.

Unpack the other commit's port into a directory that .gitignore lists
(`mkdir -p build/parent && git archive <commit> stringdecomposer_tpu_torch |
tar -x -C build/parent`), then, in one chip call, run this script once per
turn, parent, change, change, parent, each in a fresh process:

    python3 stringdecomposer_tpu_torch/scripts/k2_ab.py build/parent
    python3 stringdecomposer_tpu_torch/scripts/k2_ab.py .

ROOT is the directory that holds the checkout's `stringdecomposer_tpu_torch`;
that package, with the kernels its own runtime/build.py builds, is what
runs. The workloads come from `workloads.py` beside this script, whatever
the checkout, as does the scaffolding shared with k1_ab.py (`ab_common.py`). Two shapes, both variants (raw and homopolymer-compressed):
  - golden: the golden read's 557 raw blocks (raw_decomposition_oracle.tsv)
    x DXZ1 with RC (M = 24), as the golden --second-best run scores them;
  - library piece: the same blocks x the HOR library (workloads.hor_library,
    seed 0; M = 264 with RC), one scorer call of the 1.6 Mbp x library
    run's size (557 x 264 x 215 query cells, under ops/identity.PAIR_CELLS).
Per shape: the packed call (`nw_identity_packed_both`, prologue included);
the kernel alone on pre-built inputs (the blocks sorted by length and
collapsed, as packed_both builds them): the pairwise entry on the pairs
expanded block-major (both checkouts have it, and the parent's packed call
runs it) and the cross entry where the checkout has one. One warm-up call,
then REPS calls timed with CUDA events (ms), and a digest of the packed
call's output, so that the turns can be held equal.
With `--e2e`, the script instead runs the port end to end with
--second-best on the card: the golden read against DXZ1, and run (iii),
the 1.6 Mbp assembly (workloads.synthesize, seed 0) against the library:
one warm-up run, then E2E_REPS runs timed on the host clock up to a
synchronize, then one run with the stage timer on for its spans
(`fin.dispatch` and `fin.gather` wait on K2).
Prints one JSON line: the checkout, the card's name and power limit, the
ptxas register and spill lines of its K2 kernels (from its build.log) and
the times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path

from ab_common import DATA, checkout, e2e, ms

REPS = {"golden": 10, "library piece": 5}
E2E_REPS = {"golden": 5, "run (iii)": 3}


def shapes(torch, dev, fasta, convert, identity, workloads):
    """{name: (packed_both args, sorted blocks and lengths of both variants,
    the monomers of both variants as int32)}."""
    import numpy as np

    with open(DATA / "raw_decomposition_oracle.tsv") as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    starts = np.array([int(r[2]) for r in rows], dtype=np.int64)
    blens = np.array([int(r[3]) - int(r[2]) + 1 for r in rows], dtype=np.int32)
    read_dev = torch.from_numpy(fasta.encode(fasta.load_fasta(str(DATA / "read.fa"))[0].seq)).to(dev)
    order = np.argsort(blens, kind="stable")
    ql = torch.from_numpy(blens[order]).to(dev)
    q = identity.blocks_from_read(read_dev, torch.from_numpy(starts[order]).to(dev), ql,
                                  int(blens.max()))
    qh, hl = identity.homo_collapse(q, ql)
    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"), upper=True)
    lib = [fasta.Record(r.name, r.seq.upper())
           for r in workloads.hor_library(fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa")),
                                          np.random.default_rng(0))]
    out = {}
    for name, recs in (("golden", dxz1), ("library piece", lib)):
        st = convert.state_from_numpy(*convert.numpy_state([], fasta.add_rc_interleaved(recs)), dev)
        targets = [x.to(torch.int32).contiguous() for x in (st.t_raw, st.tl_raw, st.t_homo, st.tl_homo)]
        packed = (read_dev, starts, blens, st.t_raw, st.tl_raw, st.t_homo, st.tl_homo)
        out[name] = (packed, ((q, ql), (qh, hl)), (targets[:2], targets[2:]))
    return out


def e2e_runs(torch, fasta, workloads) -> dict:
    """ab_common.e2e of the golden run and run (iii) unfiltered."""
    import numpy as np

    dxz1 = str(DATA / "DXZ1_star_monomers.fa")
    with tempfile.TemporaryDirectory() as work:
        lib_fa = str(Path(work) / "hor_library.fa")
        fasta.write_fasta(lib_fa, workloads.hor_library(fasta.load_fasta(dxz1), np.random.default_rng(0)))
        asm_fa = Path(work) / "asm.fa"
        asm = workloads.synthesize(1_600_000, fasta.load_fasta(dxz1), np.random.default_rng(0))
        asm_fa.write_text(f">asm\n{asm}\n")
        return e2e(torch, [("golden", str(DATA / "read.fa"), dxz1, E2E_REPS["golden"], {}),
                           ("run (iii)", str(asm_fa), lib_fa, E2E_REPS["run (iii)"], {})])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="directory holding the checkout's stringdecomposer_tpu_torch")
    ap.add_argument("--e2e", action="store_true",
                    help="time the golden run and run (iii) end to end instead")
    args = ap.parse_args()
    torch, res = checkout(args.root, "nw_identity", "k2_ab")
    import workloads
    from stringdecomposer_tpu_torch import convert
    from stringdecomposer_tpu_torch.io import fasta
    from stringdecomposer_tpu_torch.ops import identity, identity_cuda

    if args.e2e:
        res["e2e"] = e2e_runs(torch, fasta, workloads)
        print(json.dumps(res))
        return 0
    dev = torch.device("cuda")
    res["shapes"] = {}
    cross = getattr(identity_cuda, "nw_identity_cross_cuda", None)
    for name, (packed, blocks, targets) in shapes(torch, dev, fasta, convert, identity,
                                                  workloads).items():
        reps = REPS[name]
        kw = dict(n_pad=len(packed[1]), Lq=int(packed[2].max()))
        got = identity_cuda.nw_identity_packed_both(*packed, **kw)
        row = {"blocks": len(packed[1]), "M": int(targets[0][0].shape[0]),
               "packed_ms": ms(torch, lambda: identity_cuda.nw_identity_packed_both(*packed, **kw),
                               reps),
               "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        M = row["M"]
        exp = [(x.repeat_interleave(M, dim=0), xl.repeat_interleave(M), t.repeat(len(xl), 1),
                tl.repeat(len(xl))) for (x, xl), (t, tl) in zip(blocks, targets)]
        row["pairwise_ms"] = ms(torch, lambda: [identity_cuda.nw_identity_batch_cuda(*e)
                                                for e in exp], reps)
        del exp
        if cross is not None:
            row["cross_ms"] = ms(torch, lambda: [cross(x, xl, t, tl) for (x, xl), (t, tl)
                                                 in zip(blocks, targets)], reps)
        res["shapes"][name] = row
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
