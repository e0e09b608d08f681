"""What decides `correct`: the TSVs that timed jobs wrote, held to the
plain reference (benchmark/reference/) over a sample drawn from the seed.

Outputs of every `keep_every`-th job are kept. Once the window has closed
`check.jobs` of the kept jobs that finished are judged over regions of
`check.windows` consecutive windows, whose middles cover every slot of
K1's device batch (`sample`): every raw row (K1, the walk, the halo
dedup), every final row and every alt row (K2 and finishing) whose block
starts there must be the reference's, byte for byte. Each number compared
has the limit 0.
"""

from __future__ import annotations

import os
import time

from reference.chain_dp import make_windows
from reference.decompose import region_bounds, regions_rows, rows_differ, rows_in
from reference.fasta import read_fasta

from . import inputs
from .inputs import SAMPLE

TSVS = {"raw": "final_decomposition_raw.tsv", "final": "final_decomposition.tsv",
        "alt": "final_decomposition_alt.tsv"}


def sample(records, traffic: dict, seed: int, cli: dict) -> list:
    """[(record, region)] to judge: `check.jobs` kept jobs drawn from the
    seed, and over them, round robin, regions of `check.windows` windows
    about a middle window m. The middles' indices step by the region's
    width through every residue modulo the device batch from a seeded
    start, each at a seeded place among the job's windows of that residue:
    past the DP stream's ramp a window's slot in K1's batch is fixed by its
    index modulo the batch, so every slot's rows are judged in every run."""
    done = [r for r in records if r.kept and r.error is None]
    if not done:
        return []
    chk = traffic["check"]
    r = inputs.rng(seed, SAMPLE, 1)
    picked = [done[i] for i in sorted(r.choice(len(done), min(chk["jobs"], len(done)),
                                               replace=False))]
    width, batch = chk["windows"], cli["device_batch"]
    first = int(r.integers(batch))
    out, seen = [], set()
    for i in range(-(-batch // width)):
        rec = picked[i % len(picked)]
        n_win = len(make_windows(rec.input.bp, cli["batch_size"], cli["overlap"]))
        residue = (first + i * width) % batch
        mids = range(residue, n_win, batch)
        m = int(mids[int(r.integers(len(mids)))]) if len(mids) else residue % n_win
        w0 = min(max(0, m - (width - 1) // 2), max(0, n_win - width))
        if (id(rec), w0) not in seen:
            seen.add((id(rec), w0))
            out.append((rec, region_bounds(rec.input.bp, w0, width, cli["batch_size"],
                                           cli["overlap"])))
    return out


def judge(records, inp, config: dict, traffic: dict, seed: int, device, log,
          ties: str = "first", prefer: str = "up") -> list[tuple[str, float, float]]:
    """[(number, value, limit)]: rows that differ from the reference's in
    each TSV over the sampled regions, and whether no job was judged."""
    cli = config["cli"]
    picked = sample(records, traffic, seed, cli)
    t = time.perf_counter()
    want = regions_rows([(rec.input.name, rec.input.seq, reg) for rec, reg in picked],
                        read_fasta(inp.monomers_fa), cli, device, ties, prefer)
    differ = {k: 0 for k in TSVS}
    for (rec, (w0, w1, lo, hi)), ref in zip(picked, want):
        counts = []
        for kind, fn in TSVS.items():
            got = rows_in(os.path.join(rec.out_dir, fn), rec.input.name, lo, hi)
            differ[kind] += rows_differ(got, ref[kind])
            counts.append(f"{kind} {len(got)}/{len(ref[kind])}")
        log(f"check: job c{rec.client}.{rec.index} ({rec.input.bp} bp) windows {w0}-{w1}, "
            f"starts [{lo}, {hi}): rows got/want " + ", ".join(counts))
    log(f"check: {len(picked)} regions of {len({id(rec) for rec, _ in picked})} jobs judged in "
        f"{time.perf_counter() - t:.1f} s")
    return [(f"{k}_rows_differ", float(v), 0.0) for k, v in differ.items()] + [
        ("no_job_judged", 0.0 if picked else 1.0, 0.0)]
