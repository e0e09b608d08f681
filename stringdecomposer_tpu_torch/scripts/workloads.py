"""Seeded synthetic workloads of chip_smoke.py and scripts/k2_ab.py: a
HOR-scale monomer library and a centromere-like assembly, both drawn from
a numpy.random.default_rng. The import below is absolute, so that k2_ab.py
can load this file beside another checkout's package."""

from __future__ import annotations

from stringdecomposer_tpu_torch.io.fasta import Record


def hor_library(records, rng):
    """A HOR-scale monomer library from a monomer set: each monomer, in file
    order, then 10 variants v = 0..9 with max(1, int(len * (0.02 + 0.01 v)))
    random edits each (substitution p 0.8, deletion 0.1, insertion 0.1),
    named `<first word of name>_v<v>`. From the 12 DXZ1 monomers and
    numpy.random.default_rng(0): 132 monomers, 264 with RC, padded to 192."""
    out = []
    for r in records:
        out.append(Record(r.name, r.seq))
        head = r.name.split()[0]
        for v in range(10):
            seq = list(r.seq)
            for _ in range(max(1, int(len(r.seq) * (0.02 + 0.01 * v)))):
                pos = int(rng.integers(len(seq)))
                kind = rng.random()
                if kind < 0.8:
                    seq[pos] = "ACGT".replace(seq[pos], "")[int(rng.integers(3))]
                elif kind < 0.9:
                    if len(seq) > 1:
                        del seq[pos]
                else:
                    seq.insert(pos, "ACGT"[int(rng.integers(4))])
            out.append(Record(f"{head}_v{v}", "".join(seq)))
    return out


def synthesize(n_bp: int, monomers, rng) -> str:
    """A centromere-like assembly of n_bp: tandem copies of monomers drawn
    at random, each with ~5 % edits (substitution p 0.6, deletion 0.2,
    insertion 0.2). The same draws as scripts/scale_smoke.synthesize, so
    seed 0 gives the same 1.6 Mbp assembly."""
    units = [m.seq for m in monomers]
    out = []
    total = 0
    while total < n_bp:
        u = list(units[rng.integers(len(units))])
        for _ in range(max(1, len(u) // 20)):
            p = int(rng.integers(len(u)))
            r = rng.random()
            if r < 0.6:
                u[p] = "ACGT"[rng.integers(4)]
            elif r < 0.8 and len(u) > 2:
                del u[p]
            else:
                u.insert(p, "ACGT"[rng.integers(4)])
        s = "".join(u)
        out.append(s)
        total += len(s)
    return "".join(out)[:n_bp]
