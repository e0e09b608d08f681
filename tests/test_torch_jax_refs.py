"""The JAX package's reference outputs for the port's large and long monomer
sets (stringdecomposer_tpu_torch/test_data/jax_refs/), their generator, and
the tests that hold the committed references to it.

    JAX_PLATFORMS=cpu python tests/test_torch_jax_refs.py --write [CASE ...]

(re)writes the named cases of CASES (all without names): for each, the
input is rebuilt from the case's fields by the port's
scripts/workloads.ref_input, the JAX package runs on the CPU (its CLI or
pipeline.run: three TSVs; decompose_reads: the raw rows), and index.json
gets the case's entry: its inputs, M and L padded, the K1 body and route
the card takes for them (ops/chain_dp_cuda.body, route, and the plan
without the card's occupancy), and for each output its sha256, bytes and
lines, with the seconds of the JAX run. The raw TSV is written gzipped
beside it. Final and alt TSVs are kept as digests only. chip_smoke.py's
phase `jax_refs` holds the port's kernel route on the card to every entry.

    JAX_PLATFORMS=cpu python tests/test_torch_jax_refs.py --check CASE

runs the JAX package on one committed entry's inputs and prints the digests
as one JSON line (the regeneration test below runs it under a time limit).

The JAX package runs with device_batch 1 here (its batches otherwise pad
to 24 windows, which costs the CPU 24 times the work of one); the bytes do
not depend on it, and the card runs the port's default."""

from __future__ import annotations

import fcntl
import gzip
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from stringdecomposer_tpu_torch.io.fasta import load_fasta, write_fasta  # noqa: E402
from stringdecomposer_tpu_torch.ops import chain_dp_cuda as k1  # noqa: E402
from stringdecomposer_tpu_torch.scripts import workloads  # noqa: E402

DATA = REPO / "stringdecomposer_tpu_torch" / "test_data"
REFS = DATA / "jax_refs"
INDEX = REFS / "index.json"
TSVS = ("final_decomposition_raw.tsv", "final_decomposition.tsv", "final_decomposition_alt.tsv")
RAW_ROWS = "raw_rows.tsv"  # decompose_reads' blocks, format_raw_rows, a row a line
JAX_DEVICE_BATCH = 1

DX = "DXZ1_star_monomers.fa"


def _golden(cut=None):
    return {"file": "read.fa", "cut": cut}


def _opts(second_best=True, ed_thr=-1, batch_size=5000, overlap=500):
    return {"second_best": second_best, "ed_thr": ed_thr, "batch_size": batch_size,
            "overlap": overlap}


def _units(n):
    return {"read": {"call": "unit_pair", "cut": None},
            "set": {"file": DX, "call": "unit_pair", "n": n, "seed": 0}}


# every case of the references: what chip_smoke drives on each K1 body of a
# routed path, the golden read cut where JAX on the CPU takes too long
CASES = {
    "golden_b500": dict(entry="cli", read=_golden(), set={"file": DX, "call": None},
                        options=_opts(batch_size=500, overlap=100)),
    "dimers": dict(entry="cli", read=_golden(), set={"file": DX, "call": "joined_set", "k": 2},
                   options=_opts()),
    "dimer_variants": dict(entry="run", read=_golden(),
                           set={"file": DX, "call": "joined_variants", "k": 2, "n": 150,
                                "seed": 0}, options=_opts()),
    "trimers": dict(entry="cli", read=_golden(), set={"file": DX, "call": "joined_set", "k": 3},
                    options=_opts()),
    "trimer_variants": dict(entry="run", read=_golden(),
                            set={"file": DX, "call": "joined_variants", "k": 3, "n": 150,
                                 "seed": 0}, options=_opts()),
    "hor_unit": dict(entry="cli", read=_golden(30_000), set={"file": DX, "call": "hor_unit"},
                     options=_opts()),
    "library": dict(entry="run", read=_golden(),
                    set={"file": DX, "call": "hor_library", "seed": 0}, options=_opts()),
    "library_ed_thr": dict(entry="run", read=_golden(),
                           set={"file": DX, "call": "hor_library", "seed": 0},
                           options=_opts(ed_thr=10)),
    "unit_17k": dict(entry="decompose_reads", **_units(100), options=_opts(second_best=False)),
    "variants_2400": dict(entry="decompose_reads", read=_golden(10_000),
                          set={"file": DX, "call": "joined_variants", "k": 1, "n": 2400,
                               "seed": 0}, options=_opts(second_best=False)),
    "hor_variants_256": dict(entry="decompose_reads", read=_golden(10_000),
                             set={"file": DX, "call": "joined_variants", "k": 12, "n": 256,
                                  "seed": 0}, options=_opts(second_best=False)),
    "unit_34k": dict(entry="decompose_reads", **_units(200), options=_opts(second_best=False)),
}
# the K1 bodies (and the lanes and cluster bodies past LANES_LONG_L) the
# references must cover between them
BODIES = {"lanes_long", "cluster", "cluster_long", "tiled", "cluster_tiled", "grid", "grid_tiled",
          "split"}


def ref_argv(options: dict) -> list[str]:
    """The CLI flags of a reference case's `options` (second_best, ed_thr,
    batch_size, overlap), the defaults left out."""
    argv = ["--second-best"] if options["second_best"] else []
    if options["ed_thr"] > -1:
        argv += ["--ed_thr", str(options["ed_thr"])]
    if (options["batch_size"], options["overlap"]) != (5000, 500):
        argv += ["-b", str(options["batch_size"]), "-v", str(options["overlap"])]
    return argv


def _digest(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
            "lines": data.count(b"\n")}


def _padded(case: dict, monos) -> tuple[int, int]:
    """M and L as the port pads them: the set with its reverse complements
    (which the pipeline adds to a FASTA file's set), rows rounded up to 8."""
    M = len(monos) * (1 if case["entry"] == "decompose_reads" else 2)
    return M, (max(len(m.seq) for m in monos) + 7) // 8 * 8


def _plan(body: str, M: int, L: int):
    """The cluster or grid plan of a body without the card's occupancy (one
    window in one wave), as a list; None for the other bodies."""
    plan = (k1.cluster_plan(M, L, 4) if body in ("cluster", "cluster_tiled") else
            k1.grid_plan(M, L, 4) if body in k1.GRID_BODIES else None)
    return list(plan) if plan else None


def case_inputs(case: dict, work: str) -> tuple[str, str, list, list]:
    """The case's reads and monomers (workloads.ref_input) and, for a "cli"
    or "run" case, the FASTA files both packages read (written once)."""
    reads, monos = workloads.ref_input(case, str(DATA))
    read_fa, mono_fa = os.path.join(work, "reads.fa"), os.path.join(work, "monomers.fa")
    write_fasta(read_fa, reads)
    write_fasta(mono_fa, monos)
    return read_fa, mono_fa, reads, monos


def jax_outputs(case: dict, work: str) -> tuple[dict[str, bytes], float]:
    """The JAX package's outputs for a case on the CPU ({file name: bytes})
    and the seconds its run took."""
    from stringdecomposer_tpu.cli import main as jax_cli
    from stringdecomposer_tpu.io.fasta import Record as JRecord
    from stringdecomposer_tpu.pipeline import PipelineConfig, decompose_reads, run
    from stringdecomposer_tpu.report import format_raw_rows

    read_fa, mono_fa, reads, monos = case_inputs(case, work)
    opts = case["options"]
    out = os.path.join(work, "jax")
    t0 = time.perf_counter()
    if case["entry"] == "cli":
        rc = jax_cli([read_fa, mono_fa, "-o", out, *ref_argv(opts),
                      "--device-batch", str(JAX_DEVICE_BATCH)])
        if rc != 0:
            raise RuntimeError(f"JAX CLI exit code {rc}")
    elif case["entry"] == "run":
        run(read_fa, mono_fa, out_dir=out, device_batch=JAX_DEVICE_BATCH, **opts)
    else:
        cfg = PipelineConfig(part_size=opts["batch_size"], overlap=opts["overlap"],
                             ed_thr=opts["ed_thr"], device_batch=JAX_DEVICE_BATCH)
        res = decompose_reads([JRecord(r.name, r.seq) for r in reads],
                              [JRecord(m.name, m.seq) for m in monos], cfg)
        names = [m.name for m in monos]
        raw = "".join(r + "\n" for rn, b in res for r in format_raw_rows(rn, b, names))
        return {RAW_ROWS: raw.encode()}, time.perf_counter() - t0
    secs = time.perf_counter() - t0
    return {f: pathlib.Path(out, f).read_bytes() for f in TSVS}, secs


def dp_rows(case: dict, work: str) -> list[int]:
    """The monomer rows of each K1 launch the port's DP stream makes for the
    case (at its default device_batch): M, or under --ed_thr the launch's
    largest kept count. Runs the stream on the CPU with K3's plain twin and
    a K1 that records its rows and returns no blocks."""
    import torch

    from stringdecomposer_tpu_torch import pipeline
    from stringdecomposer_tpu_torch.io.fasta import add_reverse_complement

    _, _, reads, monos = case_inputs(case, work)
    if case["entry"] != "decompose_reads":
        monos = add_reverse_complement(monos)
    rows = []

    def spy(windows, window_lens, mono, mono_lens, max_blocks=0, **kw):
        rows.append(int(mono.shape[-2]))
        B = windows.shape[0]
        return (torch.zeros(B, max_blocks, 4, dtype=torch.int32),
                torch.zeros(B, dtype=torch.int32))

    opts = case["options"]
    cfg = pipeline.PipelineConfig(part_size=opts["batch_size"], overlap=opts["overlap"],
                                  ed_thr=opts["ed_thr"])
    pipeline.decompose_reads(reads, monos, cfg, "cpu", forward_fn=spy)
    return rows


def entry_of(name: str, work: str) -> dict:
    """A case's index entry: its inputs, shapes, the card's K1 body, the
    JAX package's output digests and seconds. Writes the raw TSV gzipped
    into REFS."""
    case = CASES[name]
    _, _, reads, monos = case_inputs(case, work)
    M, L = _padded(case, monos)
    rows = dp_rows(case, work) if case["options"]["ed_thr"] > -1 else [M]
    bodies = {k1.body(m, L, 4) for m in rows}
    if len(bodies) != 1:
        raise RuntimeError(f"{name}: K1 launches of {sorted(set(rows))} rows take bodies {bodies}")
    M_dp = max(rows)
    body = bodies.pop()
    outs, secs = jax_outputs(case, work)
    raw_name = RAW_ROWS if RAW_ROWS in outs else TSVS[0]
    gz = f"{name}_raw.tsv.gz"
    with open(REFS / gz, "wb") as f:
        f.write(gzip.compress(outs[raw_name], mtime=0))
    return {**case, "argv": ref_argv(case["options"]) if case["entry"] == "cli" else None,
            "read_bp": len(reads[0].seq), "M": M, "L": L, "M_dp": M_dp,
            "body": body, "route": k1.route(M_dp, L, 4), "plan": _plan(body, M_dp, L),
            "outputs": {f: _digest(b) for f, b in outs.items()}, "raw_gz": gz,
            "jax": {"seconds": round(secs, 1), "device_batch": JAX_DEVICE_BATCH}}


def load_index() -> dict:
    return json.loads(INDEX.read_text())


@pytest.mark.parametrize("n", [100, 200])
def test_unit_pair_draws_what_chip_smoke_drew(n):
    """workloads.unit_pair against the draws of chip_smoke's own function
    before it moved to workloads (copied here): at seed 0, the same read,
    of twice the unit's length, substituted at the same positions, and
    the same unit with its reverse complement."""
    from stringdecomposer_tpu_torch.io.fasta import reverse_complement

    dx = load_fasta(str(DATA / DX))
    reads, monos = workloads.unit_pair(dx, n, np.random.default_rng(0))
    unit = workloads.joined_set(dx, n)[0]
    r = np.random.default_rng(0)
    seq = np.array(list(unit.seq * 2))
    hit = r.choice(len(seq), len(seq) // 100, replace=False)
    seq[hit] = [("ACGT".replace(c, ""))[int(r.integers(3))] for c in seq[hit]]
    assert [(x.name, x.seq) for x in reads] == [("read_x2", "".join(seq))]
    assert len(reads[0].seq) == 2 * len(unit.seq) == {100: 2 * 17_129, 200: 2 * 34_241}[n]
    differ = np.flatnonzero(np.array(list(reads[0].seq)) != np.array(list(unit.seq * 2)))
    assert differ.tolist() == sorted(hit.tolist())
    assert [(m.name, m.seq) for m in monos] == [(f"dxz1_x{n}", unit.seq),
                                                (f"dxz1_x{n}'", reverse_complement(unit.seq))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_rebuilds_from_its_own_fields(name):
    """Every case has its entry in index.json with the case's inputs;
    workloads.ref_input rebuilds them from the entry to its read length, M
    and L; the gzipped raw TSV beside it has the entry's digest, and its
    outputs are the entry point's (three TSVs, or decompose_reads' raw
    rows)."""
    entry = load_index()[name]
    case = CASES[name]
    assert {k: entry[k] for k in case} == case
    reads, monos = workloads.ref_input(entry, str(DATA))
    assert len(reads) == 1 and len(reads[0].seq) == entry["read_bp"]
    assert _padded(entry, monos) == (entry["M"], entry["L"])
    raw_name = RAW_ROWS if entry["entry"] == "decompose_reads" else TSVS[0]
    assert set(entry["outputs"]) == ({RAW_ROWS} if raw_name == RAW_ROWS else set(TSVS))
    raw = gzip.decompress((REFS / entry["raw_gz"]).read_bytes())
    assert _digest(raw) == entry["outputs"][raw_name] and raw.count(b"\n") > 0
    assert entry["argv"] == (ref_argv(case["options"]) if case["entry"] == "cli"
                             else None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_body_is_the_ports_rule(name):
    """Each entry's K1 body, route and plan are what ops/chain_dp_cuda
    gives at its rows and L: M, or under --ed_thr the largest kept count
    of a launch (at most M)."""
    entry = load_index()[name]
    M, M_dp, L = entry["M"], entry["M_dp"], entry["L"]
    assert M_dp == M if entry["options"]["ed_thr"] < 0 else 1 <= M_dp <= M
    assert entry["body"] == k1.body(M_dp, L, 4)
    assert entry["route"] == k1.route(M_dp, L, 4)
    assert entry["plan"] == _plan(entry["body"], M_dp, L)


def test_entries_cover_every_routed_body():
    """Between them the entries run every K1 body of a routed path, the
    lanes and cluster bodies past LANES_LONG_L too, and the folder stays
    under 2 MB."""
    index = load_index()
    assert list(index) == list(CASES)
    got = {e["body"] + ("_long" if e["body"] in ("lanes", "cluster") and e["L"] > k1.LANES_LONG_L
                        else "") for e in index.values()}
    assert got >= BODIES, got
    assert sum(f.stat().st_size for f in REFS.iterdir()) < 2 << 20


def test_regenerated_entry_equals_the_committed_one(tmp_path):
    """The generator's --check on the committed hor_unit entry (the golden
    read's first 30 kbp x the DXZ1 HOR unit, CLI --second-best), with the
    JAX package live on the CPU in a process of its own under a time limit:
    the same three digests the index holds."""
    # one XLA thread: the suite's other workers share the cores (as fast alone)
    flags = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {flags}".strip()}
    res = subprocess.run([sys.executable, __file__, "--check", "hor_unit"], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["outputs"] == load_index()["hor_unit"]["outputs"]


def main(argv: list[str]) -> int:
    if argv[:1] == ["--check"] and len(argv) == 2:
        entry = load_index()[argv[1]]
        case = {k: entry[k] for k in ("entry", "read", "set", "options")}
        with tempfile.TemporaryDirectory() as work:
            outs, secs = jax_outputs(case, work)
        print(json.dumps({"outputs": {f: _digest(b) for f, b in outs.items()},
                          "seconds": round(secs, 1)}))
        return 0
    if argv[:1] != ["--write"] or not set(argv[1:]) <= set(CASES):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(2)  # dp_rows' K3 twin, beside other writers
    REFS.mkdir(parents=True, exist_ok=True)
    for name in argv[1:] or list(CASES):
        with tempfile.TemporaryDirectory() as work:
            entry = entry_of(name, work)
        with open(REFS / ".lock", "w") as lock:  # writers of other cases may run beside
            fcntl.flock(lock, fcntl.LOCK_EX)
            index = load_index() if INDEX.exists() else {}
            index[name] = entry
            index = {k: index[k] for k in CASES if k in index}
            INDEX.write_text(json.dumps(index, indent=1) + "\n")
        print(f"{name}: M={entry['M']} L={entry['L']} {entry['body']}, "
              f"{entry['jax']['seconds']} s, {entry['outputs']}", flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
