#!/usr/bin/env python3
"""K3 (the --ed_thr HW filter, `hw_distance_batch_cuda`) of one checkout of
this repo, timed on the card, for an A/B of two commits on one card.

Unpack the other commit's port into a directory that .gitignore lists
(`mkdir -p build/parent && git archive <commit> stringdecomposer_tpu_torch |
tar -x -C build/parent`), then, in one chip call, run this script once per
turn, parent, change, change, parent, each in a fresh process:

    python3 stringdecomposer_tpu_torch/scripts/k3_ab.py build/parent
    python3 stringdecomposer_tpu_torch/scripts/k3_ab.py .

ROOT is the directory that holds the checkout's `stringdecomposer_tpu_torch`;
that package, with the kernels its own runtime/build.py builds, is what
runs. The workloads come from `workloads.py` beside this script, whatever
the checkout, as does the scaffolding shared with k1_ab.py (`ab_common.py`).
K3 alone, on pre-built inputs, at four shapes: the golden read's 19
windows (5,000 bp with a 500 bp overlap, padded to 5,500) against DXZ1 with
RC (M = 24, L = 192), the same windows against the HOR library
(workloads.hor_library, seed 0, with RC: M = 264, L = 192), the first 64
windows of the 1.6 Mbp assembly (workloads.synthesize, seed 0; one DP batch
of run (iii)) against the library, the golden windows against the DXZ1
tetramers (workloads.joined_set, k = 4) cut to 700 bp with RC (M = 24, L =
700), and past 16,384 bp a macrosatellite-like unit of 100 DXZ1 monomers
(~17 kbp, with RC) against the windows of a read of two copies of it with 1 %
of bases substituted (seed 0), chip_smoke's wide case. Per shape: one warm-up call, then REPS calls timed with CUDA events
(ms), and a digest of the output, so that the turns can be held equal.
With `--e2e`, the script instead runs run (iii), the assembly against the
library with --ed_thr 10 and --second-best, end to end on the card: one
warm-up run, then E2E_REPS runs timed on the host clock up to a
synchronize, then one run with the stage timer on for its spans
(`dp.filter` waits on K3). With `--profile`, one warm-up run, E2E_REPS
runs timed on the host clock, then one run under torch.profiler: the
device's busy time (the kernels' self time in the profiled run), its share
of the unprofiled runs' median wall time and the idle rest (the profiler's
own overhead stretches the profiled run's wall), and the device time by
kernel.
Prints one JSON line: the checkout, the card's name and power limit, the
ptxas register and spill lines of its K3 kernels (from its build.log) and
the times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

from ab_common import DATA, checkout, e2e, ms

REPS = {"golden x DXZ1": 10, "golden x library": 10, "64 x library": 10,
        "golden x tetramers L=700": 5, "unit x2 x the unit": 3}
E2E_REPS = 3


def shapes(torch, dev, fasta, chain_dp, oracle, workloads) -> dict:
    """{name: (windows, window_lens, mono, mono_lens)} on the card."""
    import numpy as np

    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    lib = workloads.hor_library(dxz1, np.random.default_rng(0))
    tetra = [fasta.Record(r.name, r.seq[:700]) for r in workloads.joined_set(dxz1, 4)]

    def windows(seq):
        codes = fasta.encode(seq)
        return [codes[o : o + n] for o, n in oracle.make_windows(len(codes), 5000, 500)]

    golden = chain_dp.build_window_batch(
        windows(fasta.load_fasta(str(DATA / "read.fa"))[0].seq), 5500)
    asm = workloads.synthesize(1_600_000, dxz1, np.random.default_rng(0))
    batch64 = chain_dp.build_window_batch(windows(asm)[:64], 5500)
    unit = workloads.joined_set(dxz1, 100)[0]
    r = np.random.default_rng(0)
    seq = np.array(list(unit.seq * 2))
    hit = r.choice(len(seq), len(seq) // 100, replace=False)
    seq[hit] = [("ACGT".replace(c, ""))[int(r.integers(3))] for c in seq[hit]]
    unit_x2 = chain_dp.build_window_batch(windows("".join(seq)), 5500)
    out = {}
    for name, wins, recs in (("golden x DXZ1", golden, dxz1), ("golden x library", golden, lib),
                             ("64 x library", batch64, lib),
                             ("golden x tetramers L=700", golden, tetra),
                             ("unit x2 x the unit", unit_x2, [unit])):
        monos = fasta.add_reverse_complement(recs)
        L = 700 if name.endswith("700") else (max(len(m.seq) for m in monos) + 7) // 8 * 8
        mono, lens = fasta.pad_monomers(monos, pad_to=L)
        out[name] = [torch.from_numpy(x).to(dev) for x in (*wins, mono, lens)]
    return out


def e2e_iii(torch, fasta, workloads, profile: bool) -> dict:
    """Run (iii) --ed_thr 10: ab_common.e2e, or one run under torch.profiler."""
    import numpy as np

    dxz1 = str(DATA / "DXZ1_star_monomers.fa")
    with tempfile.TemporaryDirectory() as work:
        lib_fa = str(Path(work) / "hor_library.fa")
        fasta.write_fasta(lib_fa, workloads.hor_library(fasta.load_fasta(dxz1),
                                                        np.random.default_rng(0)))
        asm_fa = Path(work) / "asm.fa"
        asm = workloads.synthesize(1_600_000, fasta.load_fasta(dxz1), np.random.default_rng(0))
        asm_fa.write_text(f">asm\n{asm}\n")
        if not profile:
            return e2e(torch, [("run (iii) --ed_thr 10", str(asm_fa), lib_fa, E2E_REPS,
                                {"ed_thr": 10})])
        return profile_run(torch, str(asm_fa), lib_fa, work)


def profile_run(torch, reads: str, monos: str, work: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    from stringdecomposer_tpu_torch import pipeline

    def run():
        pipeline.run(reads, monos, out_dir=str(Path(work) / "out"), second_best=True,
                      device="cuda", ed_thr=10)
        torch.cuda.synchronize()

    run()  # warm-up
    walls = []
    for _ in range(E2E_REPS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]
    t0 = time.perf_counter()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    profiled = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves, not the operators that launched them
    rows = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    return {"wall_s": walls, "profiled_wall_s": profiled, "busy_s": busy,
            "busy_share": busy / wall, "idle_share": 1 - busy / wall,
            "device_by_kernel": [[e.key[:60], e.count, dev_us(e) / 1e3] for e in rows[:15]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="directory holding the checkout's stringdecomposer_tpu_torch")
    ap.add_argument("--e2e", action="store_true",
                    help="time run (iii) --ed_thr 10 end to end instead")
    ap.add_argument("--profile", action="store_true",
                    help="profile run (iii) --ed_thr 10 instead")
    args = ap.parse_args()
    torch, res = checkout(args.root, "hw_", "k3_ab")
    import workloads
    from stringdecomposer_tpu_torch.io import fasta
    from stringdecomposer_tpu_torch.ops import chain_dp, oracle
    from stringdecomposer_tpu_torch.ops.hw_filter_cuda import hw_distance_batch_cuda

    if args.e2e or args.profile:
        res["profile" if args.profile else "e2e"] = e2e_iii(torch, fasta, workloads, args.profile)
        print(json.dumps(res))
        return 0
    res["shapes"] = {}
    for name, a in shapes(torch, torch.device("cuda"), fasta, chain_dp, oracle,
                          workloads).items():
        got = hw_distance_batch_cuda(*a)
        res["shapes"][name] = {
            "B": a[0].shape[0], "M": a[2].shape[0], "L": a[2].shape[1],
            "ms": ms(torch, lambda: hw_distance_batch_cuda(*a), REPS[name]),
            "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
