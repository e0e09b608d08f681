"""The control of `correct`: the plain reference put in the program's
place with one guarantee of the configuration broken (the last monomer
of equal score at the traceback's end and chain jumps; the NW path that
takes the diagonal first), judged by the run's own check.

    python benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed: the cell's inputs at its own size, the jobs a run keeps
(each client's first `check.jobs` kept jobs), the check's sample of them, the control's rows
of each sampled region written where the program's TSVs would be, and
the check's numbers, printed as one JSON line a seed. Every seed has to
come out not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

from harness import check, inputs, session, spec  # noqa: E402
from reference.decompose import regions_rows  # noqa: E402
from reference.fasta import read_fasta  # noqa: E402


def control_numbers(cell_name: str, seed: int, device, config=None, traffic=None,
                    log=print) -> list:
    bench = spec.benchmark()
    if config is None or traffic is None:
        cell = spec.cell(bench, cell_name)
        config = config or spec.config(cell["config"])
        traffic = traffic or spec.traffic(cell["traffic"])
    cli = config["cli"]
    run_dir = tempfile.mkdtemp(prefix="sdcontrol-", dir=os.environ.get("TMPDIR"))
    try:
        inp = inputs.make(config, traffic, seed, run_dir)
        keep = traffic["check"]["keep_every"]
        records = []
        for c, job in enumerate(inp.jobs):
            for n in range(traffic["check"]["jobs"]):
                i = inp.phase[c] + n * keep
                records.append(session.JobRecord(c, i, job, os.path.join(run_dir, f"c{c}_j{i}"),
                                                 True))
        picked = check.sample(records, traffic, seed, cli)
        ctl = regions_rows([(r.input.name, r.input.seq, reg) for r, reg in picked],
                           read_fasta(inp.monomers_fa), cli, device, ties="last", prefer="diag")
        for (rec, _), rows in zip(picked, ctl):
            os.makedirs(rec.out_dir, exist_ok=True)
            for kind, fn in check.TSVS.items():
                with open(os.path.join(rec.out_dir, fn), "a") as f:
                    f.writelines(r + "\n" for r in rows[kind])
        return check.judge(records, inp, config, traffic, seed, device, log)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    a = p.parse_args(argv)
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        numbers = control_numbers(a.workload, seed, dev,
                                  log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"workload": a.workload, "seed": seed, "device": str(dev),
                          "seconds": round(time.perf_counter() - t, 1),
                          "correct": all(v <= lim for _, v, lim in numbers),
                          "numbers": {n: v for n, v, _ in numbers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
