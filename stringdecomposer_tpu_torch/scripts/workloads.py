"""Seeded synthetic workloads of chip_smoke.py and the A/B scripts beside
this file: a HOR-scale monomer library, monomer sets of joined units
(dimers, trimers, the whole HOR) and their variants, a unit of many
monomers against a read of two copies of it, a centromere-like assembly
and the alignment API's pairs (those of its wide routes too), all drawn
from a numpy.random.default_rng; and the inputs of the JAX package's
reference outputs (`ref_input`: the cases of test_data/jax_refs/index.json).
The import below is absolute, so that the A/B scripts can load this file
beside another checkout's package."""

from __future__ import annotations

import os

from stringdecomposer_tpu_torch.io.fasta import Record, add_reverse_complement, load_fasta


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


def joined_set(records, k: int):
    """Each monomer joined to the next k - 1 in file order (wrapping round),
    named `<first word>+<first word>...`. From the 12 DXZ1 monomers: k = 2,
    12 dimers of 338-357 bp (24 with RC, padded to L = 360: K1's lanes and
    cluster bodies at C = 12, as alpha-satellite dimers or a ~360 bp
    satellite family would run); k = 3, 12 trimers of 507-527 bp (L = 528,
    past the lanes body's 512: K1's tiled body)."""
    n = len(records)
    return [Record("+".join(records[(i + j) % n].name.split()[0] for j in range(k)),
                   "".join(records[(i + j) % n].seq for j in range(k)))
            for i in range(n)]


def hor_unit(records):
    """The monomers joined in file order into one record, named `<first
    word>+...+<first word>`: a higher-order repeat unit as one monomer. From
    the 12 DXZ1 monomers: the 2,054 bp DXZ1 HOR (2 rows with RC, padded to L
    = 2,056: K1's tiled body, each row split over 2 warps of 33 cells a
    lane)."""
    return joined_set(records, len(records))[:1]


def joined_variants(records, k: int, n: int, rng):
    """n / 2 variants of `joined_set(records, k)`: variant j of unit j % 12,
    5 % of its bases substituted at random, named `v<k>_<j>`; with RC, n
    rows. For n = 150 a set too large for K1's shared route in int32 and
    int16: at k = 2 (L = 360) the large route's cluster body, at k = 3 (L =
    528) its tiled cluster body. k = 2 with numpy.random.default_rng(0) draws the
    dimer variants chip_smoke has driven since its dimer cases began. Past
    one cluster of 16 blocks, K1's grid route: k = 1, n = 2,400 (monomer
    variants, L = 192; the cluster body at int16) and k = 12, n = 256 (HOR-
    unit variants, L = 2,056: its tiled form), chip_smoke's full-width runs
    and `k1_ab.py --grid`'s, with k = 3, n = 1,400 in int16 (L = 528)."""
    units = joined_set(records, k)
    out = []
    for j in range(n // 2):
        seq = list(units[j % len(units)].seq)
        for p in rng.choice(len(seq), len(seq) // 20, replace=False):
            seq[p] = "ACGT".replace(seq[p], "")[int(rng.integers(3))]
        out.append(Record(f"v{k}_{j}", "".join(seq)))
    return out


def unit_pair(records, n: int, rng):
    """A macrosatellite-like workload: one unit of the first n monomers
    joined (`joined_set(records, n)[0]`; from the DXZ1 monomers, n = 100:
    17,129 bp, past K3's warp route; n = 200: 34,241 bp, a row past one
    block for K1) and a read of two copies of it with 1 % of its bases
    substituted at distinct positions. Returns ([the read, `read_x2`], the
    unit `dxz1_x<n>` with its reverse complement), as decompose_reads takes
    them; chip_smoke draws it from numpy.random.default_rng(0)."""
    import numpy as np

    unit = joined_set(records, n)[0]
    seq = np.array(list(unit.seq * 2))
    hit = rng.choice(len(seq), len(seq) // 100, replace=False)
    seq[hit] = [("ACGT".replace(c, ""))[int(rng.integers(3))] for c in seq[hit]]
    return [Record("read_x2", "".join(seq))], add_reverse_complement([Record(f"dxz1_x{n}",
                                                                             unit.seq)])


# the monomer sets a reference case may name ("set": {"call": ...}), each
# drawn from the set file's records and the case's own arguments
SET_CALLS = {
    None: lambda recs, st, rng: recs,
    "joined_set": lambda recs, st, rng: joined_set(recs, st["k"]),
    "joined_variants": lambda recs, st, rng: joined_variants(recs, st["k"], st["n"], rng),
    "hor_unit": lambda recs, st, rng: hor_unit(recs),
    "hor_library": lambda recs, st, rng: hor_library(recs, rng),
}


def ref_input(case: dict, data_dir: str):
    """The reads and monomer set of one case of
    test_data/jax_refs/index.json, rebuilt from the case's own fields, as
    its entry point takes them. `case["set"]`: the monomer file under
    `data_dir` (`file`), the workload drawn from its records (`call`, one
    of SET_CALLS or "unit_pair") with its arguments and its numpy seed
    (`seed`). `case["read"]`: the file's first read (`file`), or the read
    of the set's `unit_pair` draw (`call`), cut to its first `cut` bp (null:
    whole). A "cli" or "run" case gets its set forward (the pipeline adds
    the reverse complements, as it does for a FASTA file); a
    "decompose_reads" case gets it with them (`add_reverse_complement`, as
    chip_smoke adds them)."""
    import numpy as np

    st, rd = case["set"], case["read"]
    records = load_fasta(os.path.join(data_dir, st["file"]))
    rng = np.random.default_rng(st["seed"]) if st.get("seed") is not None else None
    if st["call"] == "unit_pair":
        if rd.get("call") != "unit_pair" or case["entry"] != "decompose_reads":
            raise ValueError(f"a unit_pair set takes its own read through decompose_reads: {case}")
        reads, monos = unit_pair(records, st["n"], rng)
    else:
        monos = SET_CALLS[st["call"]](records, st, rng)
        reads = load_fasta(os.path.join(data_dir, rd["file"]))[:1]
        if case["entry"] == "decompose_reads":
            monos = add_reverse_complement(monos)
    return [Record(r.name, r.seq[:rd["cut"]]) for r in reads], monos


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


def synth_pair(n: int, divergence: float, rng) -> tuple[str, str]:
    """A random ACGT query of n bp and a copy with int(n * divergence)
    edits at distinct positions (substitution, deletion, insertion, one
    third each), as scripts/bench_align.py synthesizes its pairs."""
    import numpy as np

    q = rng.integers(0, 4, n, dtype=np.int8)
    t = q.tolist()
    n_mut = int(n * divergence)
    idx = np.sort(rng.choice(n, n_mut, replace=False))
    kinds = rng.integers(0, 3, n_mut)
    for i, kind in zip(idx[::-1].tolist(), kinds[::-1].tolist()):
        if kind == 0:
            t[i] = (t[i] + 1 + int(rng.integers(3))) % 4
        elif kind == 1:
            del t[i]
        else:
            t.insert(i, int(rng.integers(4)))
    alpha = np.array(list("ACGT"))
    return "".join(alpha[q]), "".join(alpha[np.array(t)])


def align_pairs(rng) -> dict[str, str]:
    """The alignment API's workloads, from one rng (chip_smoke.py's
    align_scale and banded_ab.py draw them from numpy.random.default_rng(0)):
    `q`, `t`, a 262,144 bp pair at 1 % divergence; `tq`, a 4,096 bp query,
    and `big_t`, its copy repeated to 1,048,576 bp; `q8`, `t8`, an 8,192 bp
    pair for the comparison with the scan route at cut sizes."""
    q, t = synth_pair(262_144, 0.01, rng)
    tq, tt = synth_pair(4096, 0.01, rng)
    q8, t8 = synth_pair(8192, 0.01, rng)
    return dict(q=q, t=t, tq=tq, big_t=(tt * 256)[: 1 << 20], q8=q8, t8=t8)


def wide_pairs(rng) -> tuple[str, str, str, str]:
    """The alignment API's wide-route pairs, from one rng (chip_smoke.py's
    align_wide and banded_ab.py draw them from numpy.random.default_rng(3)):
    `q40`, `t40`, a 40,000 bp pair at 15 % divergence, whose NW distance by
    k-doubling reaches k = 8,192 (K5's wide route; K4's in mask mode);
    `q17`, a random 17,000 bp query (K6's wide route), and `t20`, its first
    9,000 bp followed by 11,000 random ones."""
    import numpy as np

    q40, t40 = synth_pair(40_000, 0.15, rng)
    alpha = np.array(list("ACGT"))
    q17 = "".join(alpha[rng.integers(0, 4, 17_000)])
    t20 = q17[:9000] + "".join(alpha[rng.integers(0, 4, 11_000)])
    return q40, t40, q17, t20
