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
With `--large`, the shapes are K1's large route at L = 192: the golden
windows (B = 19) and the first 64 windows of the 1.6 Mbp synthetic assembly
(workloads.synthesize, seed 0; one DP batch of run (iii)), each against the
264-monomer library (workloads.hor_library, seed 0, with RC) and its first
200 rows, in int32 and int16 state. With `--long`, the shapes are K1 at
rows past 256 bp: the golden windows against the DXZ1 dimers with RC (M =
24, L = 360: the shared route) and 150 dimer variants (M = 150: the large
route; workloads.joined_set and joined_variants, seed 0), in int32 and
int16 state, against the trimers and 150 trimer variants cut to 512 bp
(M = 24 and 150, L = 512), int32 (a parent before the lanes and cluster
bodies took L > 256 runs them on its chunked body), against the trimers
and their variants whole (L = 528) and the DXZ1 HOR unit (workloads.
hor_unit, M = 2, L = 2,056), int32 and int16, and the ~17 kbp unit of 100
DXZ1 monomers against its 7 windows of a read of two copies of it with 1 %
of bases substituted (seed 0; M = 2, L = 17,136), int32 (int16 is refused
there): a parent before the tiled bodies runs those on its chunked body.
With `--sweep` (a
checkout that has the cluster body), the `--large` shapes and the golden
windows x the 150 dimer variants (L = 360) through `chain_dp_large_cuda`
at every cluster size the shared memory admits, each with its
cudaOccupancyMaxActiveClusters and its digest against the plan's, then the
golden windows against the library's first 64 and 128 rows on the lanes
body and on the cluster body at each cluster size (sets the shared route
takes, timed on both bodies). With `--tiled` (a checkout that has the
tiled bodies), the golden windows x the DXZ1 HOR unit (the tiled body)
and the ~17 kbp unit's windows (the tiled cluster body, a row a block) at
1, 2, 4, 8, 16 and 32 warps a row (`tiled_layout` replaced for the run,
C = ceil(L / 32 G)), each with its digest against the rule's, then the
golden windows x the DXZ1 trimers and their 150 variants on the tiled
cluster body at every cluster size the shared memory admits
(`force_body="cluster_tiled"`), with its cudaOccupancyMaxActiveClusters, against
the rule's body. With `--grid` (a checkout that has the grid routes), the
sets past one cluster of 16 blocks at full width, each on the route the
rule gives it and on the chunked body (`force_body="large"`), in turns,
with min, median and max and the digests held equal, beside chip_smoke's
bound and one call of the plain twin: the golden windows x
2,400 DXZ1 monomer variants (workloads.joined_variants, k = 1, seed 0; L =
192, the grid route), x 1,400 trimer variants in int16 (k = 3; L = 528)
and x 256 DXZ1 HOR-unit variants (k = 12; L = 2,056; the grid route past
512), and the windows of a read of two copies of a unit of 200 DXZ1
monomers x the unit (~34 kbp, the split form); then the grid route at
every K of cs = 1, 2, 4, 8 and 16 on the 2,400 variants and at a few on
the HOR-unit variants (`grid=`), each with its occupancy and
`grid_plan`'s cost, so that the plan's model is held to the card; then the
exchange between clusters alone: the golden windows x the 264-monomer
library on the cluster body at cs = 8 and on the grid route at K x cs = 1
x 8, 2 x 4, 4 x 2 and 8 x 1 (33 rows a block each), whose differences
over the 5,500 positions are what the exchange costs. With `--e2e`, the script instead runs the
port end to end on the golden read against DXZ1 (`pipeline.run`,
`--second-best`, on the card), plain and with `ed_thr=10` (run (i)), the
golden read against the DXZ1 trimers and against the DXZ1 HOR unit, and the
1.6 Mbp assembly against the library unfiltered (run (iii)): one warm-up
run, then E2E_REPS (run (iii): E2E_REPS_III) runs timed on the host clock up
to a synchronize, then one run with the stage timer on for its spans
(`dp.gather` waits on K1).
Prints one JSON line: the checkout, the card's name and power limit, the
ptxas register and spill lines of its chain-DP kernels (from its build.log)
and the times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile

from ab_common import DATA, checkout, e2e, ms

REPS = 10
LARGE_REPS = 5
SWEEP_REPS = 3
GRID_REPS = 3
E2E_REPS = 5
E2E_REPS_III = 3


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


def large_shapes(fasta, oracle, chain_dp, workloads):
    """(name, windows, window lens, mono, mono lens) of `--large`: the golden
    windows and one 64-window batch of the 1.6 Mbp assembly, each x the
    library (M = 264) and its first 200 rows."""
    import numpy as np

    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    lib = workloads.hor_library(dxz1, np.random.default_rng(0))
    mono, lens = fasta.pad_monomers(fasta.add_reverse_complement(lib), pad_to=192)
    golden = fasta.encode(fasta.load_fasta(str(DATA / "read.fa"))[0].seq)
    asm = fasta.encode(workloads.synthesize(1_600_000, dxz1, np.random.default_rng(0)))
    out = []
    for what, codes, n in (("golden", golden, None), ("1.6Mbp[:64]", asm, 64)):
        wins = [codes[o : o + ln] for o, ln in oracle.make_windows(len(codes), 5000, 500)][:n]
        wb, wl = chain_dp.build_window_batch(wins, 5500)
        out += [(f"{what} x M={M}", wb, wl, mono[:M], lens[:M]) for M in (264, 200)]
    return out


def unit_case(fasta, oracle, chain_dp, workloads):
    """The ~17 kbp unit's shape: its windows (5,000 bp, 500 bp overlap,
    padded to 5,500) of a read of two copies of the unit of 100 DXZ1
    monomers with 1 % of its bases substituted (numpy seed 0, as chip_smoke's
    `wide_case`), and the unit with RC padded to a multiple of 8."""
    import numpy as np

    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    unit = workloads.joined_set(dxz1, 100)[0]
    r = np.random.default_rng(0)
    seq = np.array(list(unit.seq * 2))
    hit = r.choice(len(seq), len(seq) // 100, replace=False)
    seq[hit] = [("ACGT".replace(c, ""))[int(r.integers(3))] for c in seq[hit]]
    codes = fasta.encode("".join(seq))
    wins = [codes[o : o + n] for o, n in oracle.make_windows(len(codes), 5000, 500)]
    wb, wl = chain_dp.build_window_batch(wins, 5500)
    mono, lens = fasta.pad_monomers(fasta.add_reverse_complement([unit]),
                                    pad_to=(len(unit.seq) + 7) // 8 * 8)
    return wb, wl, mono, lens


def long_shapes(fasta, oracle, chain_dp, workloads, cut=None):
    """(name, windows, window lens, mono, mono lens, state) of `--long`: the
    golden windows x the DXZ1 dimers and their 150 variants (L = 360), int32
    and int16, x the trimers and their 150 variants cut to 512 bp (L = 512),
    int32, x the trimers and their variants whole (L = 528) and the HOR unit
    (L = 2,056), int32 and int16; the ~17 kbp unit's windows x the unit, int32.
    With `cut`, only the sets of that name ("dimers variants" for
    `--sweep`), int32."""
    import numpy as np

    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    codes = fasta.encode(fasta.load_fasta(str(DATA / "read.fa"))[0].seq)
    wins = [codes[o : o + n] for o, n in oracle.make_windows(len(codes), 5000, 500)]
    wb, wl = chain_dp.build_window_batch(wins, 5500)
    out = []
    both = ("int32", "int16")
    for k, width, states in ((2, 360, both), (3, 512, ("int32",)), (3, 528, both)):
        for what, records in ((f"{'di' if k == 2 else 'tri'}mers", workloads.joined_set(dxz1, k)),
                              (f"{'di' if k == 2 else 'tri'}mers variants",
                               workloads.joined_variants(dxz1, k, 150, np.random.default_rng(0)))):
            if cut not in (None, what):
                continue
            records = [fasta.Record(r.name, r.seq[:width]) for r in records]
            mono, lens = fasta.pad_monomers(fasta.add_reverse_complement(records), pad_to=width)
            for dt in (("int32",) if cut else states):
                out.append((f"golden x {what} M={len(lens)} L={width}", wb, wl, mono, lens, dt))
    if cut is None:
        mono, lens = fasta.pad_monomers(
            fasta.add_reverse_complement(workloads.hor_unit(dxz1)), pad_to=2056)
        out += [("golden x HOR unit M=2 L=2056", wb, wl, mono, lens, dt) for dt in both]
        wb2, wl2, mono, lens = unit_case(fasta, oracle, chain_dp, workloads)
        out.append((f"17 kbp unit x its {len(wb2)} windows M=2 L={mono.shape[1]}", wb2, wl2, mono,
                    lens, "int32"))
    return out


def joined_fastas(fasta, workloads, d):
    """The DXZ1 trimers and the DXZ1 HOR unit as FASTAs in directory d (the
    runs add RC): the golden read's e2e sets past 512 bp."""
    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    out = {}
    for name, records in (("trimers", workloads.joined_set(dxz1, 3)),
                          ("hor_unit", workloads.hor_unit(dxz1))):
        out[name] = f"{d}/{name}.fa"
        fasta.write_fasta(out[name], records)
    return out


def large_library(fasta, workloads, d):
    """The 264-monomer library FASTA (the run adds RC) and the 1.6 Mbp
    assembly, written into directory d: run (iii)'s inputs."""
    import numpy as np

    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    lib, asm = f"{d}/library.fa", f"{d}/asm.fa"
    fasta.write_fasta(lib, workloads.hor_library(dxz1, np.random.default_rng(0)))
    with open(asm, "w") as f:
        f.write(f">asm\n{workloads.synthesize(1_600_000, dxz1, np.random.default_rng(0))}\n")
    return lib, asm


def digest(blocks, counts) -> str:
    return hashlib.sha256(blocks.cpu().numpy().tobytes()
                          + counts.cpu().numpy().tobytes()).hexdigest()[:16]


def sweep(torch, k1, shapes, dev, cap):
    """Every admissible cluster size of each shape (`--large`'s and the
    dimer variants at L = 360), int32 and int16: occupancy, ms, digest
    (equal to the plan's); then M = 64 and 128 on the lanes body against the
    cluster body."""
    out = {}
    for name, *arrays in shapes:
        a = [torch.from_numpy(x).to(dev) for x in arrays]
        B, (M, L) = a[0].shape[0], a[2].shape
        for dt, sb in (("int32", 4), ("int16", 2)):
            kw = dict(max_blocks=cap, state_dtype=dt)
            plan = k1.cluster_plan(M, L, sb, B, lambda cs: k1.cluster_occupancy(M, L, sb, cs, B))
            want = digest(*k1.chain_dp_large_cuda(*a, **kw))
            rows = {}
            for cs in range(1, k1.CLUSTER_MAX + 1):
                shape = k1.cluster_shape(M, L, sb, cs)
                if shape is None:
                    continue
                occ = k1.cluster_occupancy(M, L, sb, cs, B)
                row = {"R": shape[0], "form": shape[1], "threads": shape[2], "smem": shape[3],
                       "max_active_clusters": occ}
                if occ > 0:
                    got = digest(*k1.chain_dp_large_cuda(*a, cluster_size=cs, **kw))
                    row.update(ms=ms(torch, lambda: k1.chain_dp_large_cuda(
                        *a, cluster_size=cs, **kw), SWEEP_REPS), digest_equal=got == want)
                rows[cs] = row
            out[f"{name} {dt}"] = {"plan_cs": plan[0], "B": B, "sizes": rows}
    golden = shapes[0]
    for M in (64, 128):
        a = [torch.from_numpy(x).to(dev) for x in (golden[1], golden[2], golden[3][:M],
                                                    golden[4][:M])]
        want = digest(*k1.chain_dp_forward_cuda(*a, max_blocks=cap))
        row = {"body": k1.body(M, 192), "lanes_ms": ms(
            torch, lambda: k1.chain_dp_forward_cuda(*a, max_blocks=cap), SWEEP_REPS)}
        for cs in range(1, k1.CLUSTER_MAX + 1):
            if k1.cluster_shape(M, 192, 4, cs) is None or k1.cluster_occupancy(M, 192, 4, cs, 19) == 0:
                continue
            got = digest(*k1.chain_dp_large_cuda(*a, cluster_size=cs, max_blocks=cap))
            row[f"cluster_{cs}_ms"] = ms(torch, lambda: k1.chain_dp_large_cuda(
                *a, cluster_size=cs, max_blocks=cap), SWEEP_REPS)
            row[f"cluster_{cs}_digest_equal"] = got == want
        out[f"golden x M={M} lanes vs cluster"] = row
    return out


def tiled_sweep(torch, k1, fasta, oracle, chain_dp, workloads, dev, cap):
    """`--tiled`: the warps a row of the tiled bodies at the HOR unit and
    the ~17 kbp unit, then the trimers on the tiled cluster body at every
    admissible cluster size against the tiled body."""
    golden = [sh for sh in long_shapes(fasta, oracle, chain_dp, workloads)
              if sh[5] == "int32" and ("HOR" in sh[0] or "17 kbp" in sh[0]
                                        or sh[0].endswith("L=528"))]
    out, rule = {}, k1.tiled_layout
    for name, *arrays, _ in golden:
        a = [torch.from_numpy(x).to(dev) for x in arrays]
        M, L = arrays[2].shape
        want = digest(*k1.chain_dp_forward_cuda(*a, max_blocks=cap))
        row = {"body": k1.body(M, L), "rule_ms": ms(
            torch, lambda: k1.chain_dp_forward_cuda(*a, max_blocks=cap), SWEEP_REPS)}
        if "trimers" in name:  # every cluster size, against the rule's body
            for cs in range(1, k1.CLUSTER_MAX + 1):
                if k1.cluster_shape(M, L, 4, cs) is None:
                    continue
                occ = k1.cluster_occupancy(M, L, 4, cs, len(a[0]))
                if occ == 0:
                    continue
                kw = dict(max_blocks=cap, force_body="cluster_tiled", cluster_size=cs)
                row[f"cluster_{cs}"] = {
                    "occupancy": occ, "digest_equal": digest(*k1.chain_dp_large_cuda(
                        *a, **kw)) == want,
                    "ms": ms(torch, lambda: k1.chain_dp_large_cuda(*a, **kw), SWEEP_REPS)}
            out[name] = row
            continue
        R = M if row["body"] == "tiled" else 1  # the unit: a row a block
        row["rule"] = rule(R, L)[:2]
        for G in (1, 2, 4, 8, 16, 32):
            C = -(-L // (32 * G))
            g = -(-L // (32 * C))
            if g > 1 and R * g > k1.TILED_WARPS:
                continue
            k1.tiled_layout = lambda R_, L_, g=g, C=C: (g, C, 32 * min(k1.TILED_WARPS, R_ * g))
            try:
                row[f"G={g}, C={C}"] = {
                    "digest_equal": digest(*k1.chain_dp_forward_cuda(*a, max_blocks=cap)) == want,
                    "ms": ms(torch, lambda: k1.chain_dp_forward_cuda(*a, max_blocks=cap),
                             SWEEP_REPS)}
            finally:
                k1.tiled_layout = rule
        out[name] = row
    return out


def _once(torch, fn) -> float:
    """One call of fn timed with CUDA events (ms), no warm-up."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def k1_bound_ms(a, state_bytes, max_blocks) -> float:
    """chip_smoke.py's K1 bound at these inputs (windows, mono, lens and
    column 0 read once, end, spend and the walk's records written once; 15
    int32 operations a cell a position, 16.73 T/s; 3.35 TB/s)."""
    win, _, mono, lens = a
    B, W = win.shape
    M, L = mono.shape[-2:]
    cells = int(lens.clamp(0, L).sum()) * (B if lens.dim() == 1 else 1)
    nbytes = (B * W + mono.numel() + 4 * lens.numel() + B * M * L * state_bytes
              + 2 * B * W * M * state_bytes + B * (16 * max_blocks + 4))
    return 1e3 * max(nbytes / 3.35e12, (W - 1) * cells * 15 / (64 * 132 * 1.98e9))


def grid_shapes(fasta, oracle, chain_dp, workloads):
    """(name, windows, window lens, mono, mono lens, state) of `--grid`."""
    import numpy as np

    dxz1 = fasta.load_fasta(str(DATA / "DXZ1_star_monomers.fa"))
    codes = fasta.encode(fasta.load_fasta(str(DATA / "read.fa"))[0].seq)
    wins = [codes[o : o + n] for o, n in oracle.make_windows(len(codes), 5000, 500)]
    wb, wl = chain_dp.build_window_batch(wins, 5500)
    out = []
    for k, n, dt in ((1, 2400, "int32"), (3, 1400, "int16"), (12, 256, "int32")):
        monos = fasta.add_reverse_complement(
            workloads.joined_variants(dxz1, k, n, np.random.default_rng(0)))
        mono, lens = fasta.pad_monomers(monos, pad_to=(max(len(m.seq) for m in monos) + 7) // 8 * 8)
        out.append((f"golden x {n} k={k} variants M={n} L={mono.shape[1]} {dt}", wb, wl, mono,
                    lens, dt))
    unit = workloads.joined_set(dxz1, 200)[0]
    r = np.random.default_rng(0)
    seq = np.array(list(unit.seq * 2))
    hit = r.choice(len(seq), len(seq) // 100, replace=False)
    seq[hit] = [("ACGT".replace(c, ""))[int(r.integers(3))] for c in seq[hit]]
    codes = fasta.encode("".join(seq))
    wins = [codes[o : o + n] for o, n in oracle.make_windows(len(codes), 5000, 500)]
    wb2, wl2 = chain_dp.build_window_batch(wins, 5500)
    mono, lens = fasta.pad_monomers(fasta.add_reverse_complement([unit]),
                                    pad_to=(len(unit.seq) + 7) // 8 * 8)
    out.append((f"34 kbp unit x its {len(wb2)} windows M=2 L={mono.shape[1]} int32", wb2, wl2,
                mono, lens, "int32"))
    return out


def grid_sweep(torch, k1, fasta, oracle, chain_dp, workloads, dev, cap):
    """`--grid`: each set past one cluster on its route and on the chunked
    body in turns; the grid route at every K of a few cluster sizes; the
    exchange alone on the library."""
    out = {"routes": {}, "k_sweep": {}, "exchange": {}}
    sets = grid_shapes(fasta, oracle, chain_dp, workloads)
    for name, *arrays, dt in sets:
        a = [torch.from_numpy(x).to(dev) for x in arrays]
        B, (M, L) = a[0].shape[0], a[2].shape
        sb = 2 if dt == "int16" else 4
        kw = dict(max_blocks=cap, state_dtype=dt)
        plan = k1.grid_plan(M, L, sb, B, lambda p: k1.grid_occupancy(M, L, sb, p))
        row = {"body": k1.body(M, L, sb), "plan": plan[:3], "route_ms": [], "chunked_ms": [],
               "bound_ms": k1_bound_ms(a, sb, cap)}
        want = digest(*k1.chain_dp_forward_cuda(*a, **kw))
        row["plain_ms"] = _once(torch, lambda: chain_dp.chain_dp_forward(*a, **kw))
        row["digest_equal"] = digest(*k1.chain_dp_large_cuda(*a, force_body="large", **kw)) == want
        for _ in range(2):  # route, chunked, route, chunked
            row["route_ms"] += ms(torch, lambda: k1.chain_dp_forward_cuda(*a, **kw), GRID_REPS)
            row["chunked_ms"] += ms(torch, lambda: k1.chain_dp_large_cuda(
                *a, force_body="large", **kw), 1)
        out["routes"][name] = row
        if not name.startswith(("golden x 2400", "golden x 256")):
            continue
        rows = {}
        sizes = (1, 2, 4, 8, 16) if L <= k1.LANES_MAX_L else (1, 4, 16)
        for cs in sizes:
            Ks = [K for K in range(2, k1.SM_COUNT // cs + 1)
                  if k1.grid_shape(M, L, sb, K, cs) is not None]
            if L > k1.LANES_MAX_L:
                Ks = Ks[:: max(1, len(Ks) // 4)]
            for K in Ks:
                p = (K, cs, 1, *k1.grid_shape(M, L, sb, K, cs))
                occ = k1.grid_occupancy(M, L, sb, p)
                r = {"R": p[3], "form": p[4], "threads": p[5], "smem": p[6], "occupancy": occ,
                     "cost": k1.grid_cost(p, L, B, occ)[0]}
                if occ >= K:
                    r["digest_equal"] = digest(*k1.chain_dp_large_cuda(
                        *a, grid=p[:3], **kw)) == want
                    r["ms"] = ms(torch, lambda: k1.chain_dp_large_cuda(*a, grid=p[:3], **kw), 2)
                rows[f"K={K} cs={cs}"] = r
        out["k_sweep"][name] = rows
    lib = large_shapes(fasta, oracle, chain_dp, workloads)[0]
    a = [torch.from_numpy(x).to(dev) for x in lib[1:]]
    want = digest(*k1.chain_dp_large_cuda(*a, max_blocks=cap))
    row = {"cluster cs=8": ms(torch, lambda: k1.chain_dp_large_cuda(
        *a, cluster_size=8, max_blocks=cap), GRID_REPS)}
    for K, cs in ((1, 8), (2, 4), (4, 2), (8, 1)):
        row[f"grid K={K} cs={cs} digest_equal"] = digest(*k1.chain_dp_large_cuda(
            *a, grid=(K, cs, 1), max_blocks=cap)) == want
        row[f"grid K={K} cs={cs}"] = ms(torch, lambda: k1.chain_dp_large_cuda(
            *a, grid=(K, cs, 1), max_blocks=cap), GRID_REPS)
    out["exchange"][lib[0]] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="directory holding the checkout's stringdecomposer_tpu_torch")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--scaling", action="store_true",
                      help="time M = 1 .. 32 rows of one set instead of the A/B shapes")
    what.add_argument("--large", action="store_true",
                      help="time the large route's shapes (M = 264, 200; B = 19, 64; int32, int16)")
    what.add_argument("--long", action="store_true",
                      help="time K1 at L = 360, 512, 528, 2,056 and ~17 kbp (int32, int16)")
    what.add_argument("--sweep", action="store_true",
                      help="time the large route's shapes and L = 360 at every cluster size")
    what.add_argument("--tiled", action="store_true",
                      help="time the tiled bodies at every warps a row and the trimers on clusters")
    what.add_argument("--grid", action="store_true",
                      help="time the grid routes against the chunked body, and at every K")
    what.add_argument("--e2e", action="store_true",
                      help="time the golden run, run (i) and run (iii) end to end instead")
    args = ap.parse_args()
    torch, res = checkout(args.root, "chain_dp", "k1_ab")
    import workloads
    from stringdecomposer_tpu_torch.io import fasta
    from stringdecomposer_tpu_torch.ops import chain_dp, oracle
    from stringdecomposer_tpu_torch.ops import chain_dp_cuda as k1

    if args.e2e:
        read, dxz1 = str(DATA / "read.fa"), str(DATA / "DXZ1_star_monomers.fa")
        with tempfile.TemporaryDirectory() as d:
            lib, asm = large_library(fasta, workloads, d)
            sets = joined_fastas(fasta, workloads, d)
            res["e2e"] = e2e(torch, [("golden", read, dxz1, E2E_REPS, {}),
                                     ("run (i) ed_thr 10", read, dxz1, E2E_REPS, {"ed_thr": 10}),
                                     ("golden x trimers", read, sets["trimers"], E2E_REPS, {}),
                                     ("golden x HOR unit", read, sets["hor_unit"], E2E_REPS, {}),
                                     ("run (iii) unfiltered", asm, lib, E2E_REPS_III, {})])
        print(json.dumps(res))
        return 0
    dev = torch.device("cuda")
    cap = 5500 // 8
    if args.sweep:
        at = large_shapes(fasta, oracle, chain_dp, workloads) + [
            sh[:5] for sh in long_shapes(fasta, oracle, chain_dp, workloads, "dimers variants")]
        res["sweep"] = sweep(torch, k1, at, dev, cap)
        print(json.dumps(res))
        return 0
    if args.tiled:
        res["tiled"] = tiled_sweep(torch, k1, fasta, oracle, chain_dp, workloads, dev, cap)
        print(json.dumps(res))
        return 0
    if args.grid:
        res["grid"] = grid_sweep(torch, k1, fasta, oracle, chain_dp, workloads, dev, cap)
        print(json.dumps(res))
        return 0
    res["shapes"] = {}
    if args.large:
        cases = [(f"{name} {dt}", dt, *arrays)
                 for name, *arrays in large_shapes(fasta, oracle, chain_dp, workloads)
                 for dt in ("int32", "int16")]
        reps = LARGE_REPS
    elif args.long:
        cases = [(f"{name} {dt}", dt, *arrays)
                 for name, *arrays, dt in long_shapes(fasta, oracle, chain_dp, workloads)]
        reps = LARGE_REPS
    else:
        cases = [(name, "auto", *arrays)
                 for name, *arrays in shapes(fasta, oracle, chain_dp, args.scaling)]
        reps = REPS
    for name, dt, *arrays in cases:
        a = [torch.from_numpy(x).to(dev) for x in arrays]
        kw = dict(max_blocks=cap, state_dtype=dt)
        blocks, counts = k1.chain_dp_forward_cuda(*a, **kw)
        res["shapes"][name] = {"M": int(a[2].shape[0]), "L": int(a[2].shape[1]),
                               "B": int(a[0].shape[0]), "W": int(a[0].shape[1]),
                               "ms": ms(torch, lambda: k1.chain_dp_forward_cuda(*a, **kw), reps),
                               "digest": digest(blocks, counts)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
