"""The JAX package's property, CLI and streaming-finishing tests, held on the
port (--device cpu, the plain twins) and against the JAX package's own
output on the same inputs: scoring reaching the DP, reverse-complement
detection, --second-best with -i, the N-symbol warning, gzip input, a crash
mid-run, no .tmp files left, finishing's flush boundaries, duplicate
monomer names and a single monomer; and three mixes of flags: --stream-reads
with --ed_thr, -i and -s, read headers with a description, and --resume of
a raw TSV the JAX package wrote."""

import filecmp
import gzip
import io
import os
import pathlib

import numpy as np
import pytest
import torch

from stringdecomposer_tpu import finishing as jax_finishing
from stringdecomposer_tpu.cli import main as jax_cli
from stringdecomposer_tpu.io.fasta import Record as JRecord
from stringdecomposer_tpu.io.fasta import add_rc_interleaved as jax_rc_interleaved
from stringdecomposer_tpu.io.fasta import add_reverse_complement as jax_add_rc
from stringdecomposer_tpu.ops.oracle import Scoring as JScoring
from stringdecomposer_tpu.pipeline import PipelineConfig as JConfig
from stringdecomposer_tpu.pipeline import decompose_reads as jax_decompose
from stringdecomposer_tpu.pipeline import run as jax_run
from stringdecomposer_tpu_torch import cli, finishing, pipeline
from stringdecomposer_tpu_torch.io.fasta import Record, add_rc_interleaved, add_reverse_complement
from stringdecomposer_tpu_torch.io.fasta import reverse_complement
from stringdecomposer_tpu_torch.ops.oracle import Scoring

torch.set_num_threads(1)

MONO = "ACGGTCTGAACTTGGCA"
TSVS = ("final_decomposition.tsv", "final_decomposition_alt.tsv", "final_decomposition_raw.tsv")


def _outs(d, names=TSVS) -> dict:
    return {n: (pathlib.Path(d) / n).read_text() for n in names}


def _blocks(reads, monomers, **cfg_kw):
    """decompose_reads of the port and of the JAX package on the same reads
    (part_size 64, overlap 8, device_batch 2): the port's blocks, after
    checking that they equal JAX's."""
    kw = dict(part_size=64, overlap=8, device_batch=2)
    jsc = cfg_kw.get("scoring")
    got = pipeline.decompose_reads(
        [Record(f"r{i}", s) for i, s in enumerate(reads)],
        add_reverse_complement([Record("m", monomers)]),
        pipeline.PipelineConfig(**kw, **cfg_kw), "cpu")
    want = jax_decompose(
        [JRecord(f"r{i}", s) for i, s in enumerate(reads)],
        jax_add_rc([JRecord("m", monomers)]),
        JConfig(**kw, **({"scoring": JScoring(*vars(jsc).values())} if jsc else {})))
    assert [(n, [vars(b) for b in bl]) for n, bl in got] == \
        [(n, [vars(b) for b in bl]) for n, bl in want]
    return got


def test_scoring_scales_identity():
    """Doubling every unit cost doubles every block score: -s reaches the DP."""
    read = MONO + MONO[:-3] + "T" + MONO
    b0 = _blocks([read], MONO)[0][1]
    b1 = _blocks([read], MONO, scoring=Scoring(-2, -2, -2, 2))[0][1]
    assert len(b0) == len(b1) >= 2
    for x, y in zip(b0, b1):
        assert (x.monomer, x.start, x.end) == (y.monomer, y.start, y.end)
        assert y.identity == 2 * x.identity


def test_reverse_complement_monomer_detected():
    rc_read = reverse_complement(MONO) * 2
    blocks = _blocks([rc_read], MONO)[0][1]
    assert blocks and all(b.monomer == 1 for b in blocks)  # index 1 = m'
    fwd = _blocks([MONO * 2], MONO)[0][1]
    assert all(b.monomer == 0 for b in fwd)
    n = len(rc_read)
    assert sorted((n - 1 - b.end, n - 1 - b.start) for b in blocks) == \
        sorted((b.start, b.end) for b in fwd)


@pytest.fixture
def tiny_case(tmp_path):
    seqs = tmp_path / "seqs.fa"
    mono = tmp_path / "monomers.fa"
    seqs.write_text(">r1\nACGTACGGACGTACGTTACGTACGT\n>r2 with description\nTTTTACGTACGT\n")
    mono.write_text(">mA\nACGTACGT\n>mB\nTTTT\n")
    return str(seqs), str(mono), tmp_path


def _both_clis(args, tmp, names=TSVS):
    """The port's CLI (--device cpu) into tmp/t and the JAX package's into
    tmp/jax with the same arguments; both exit 0 and write the same bytes.
    Returns the port's output directory."""
    assert cli.main([*args, "-o", str(tmp / "t"), "--device", "cpu"]) == 0
    assert jax_cli([*args, "-o", str(tmp / "jax")]) == 0
    assert _outs(tmp / "t", names) == _outs(tmp / "jax", names)
    return tmp / "t"


def test_cli_second_best_and_min_identity(tiny_case):
    seqs, mono, tmp = tiny_case
    out = _both_clis([seqs, mono, "-b", "16", "-v", "4", "--second-best", "-i", "60",
                      "--device-batch", "2", "--out-file", "sb"], tmp,
                     ("sb.tsv", "sb_alt.tsv", "sb_raw.tsv"))
    rows = [ln.split("\t") for ln in (out / "sb.tsv").read_text().splitlines()]
    assert rows and all(len(r) == 12 for r in rows)
    assert all(float(r[4]) >= 60 for r in rows)  # min-identity filter
    assert all(r[5] != "None" for r in rows)  # second best computed
    alt = [ln.split("\t") for ln in (out / "sb_alt.tsv").read_text().splitlines()]
    assert alt and all(len(r) == 6 for r in alt)
    stars = [r for r in alt if r[5] == "*"]
    assert len(alt) == 4 * len(rows) and len(stars) == len(rows)


def test_cli_n_symbol_warns_and_runs(tmp_path):
    """N is a fifth symbol that matches no ACGT: a warning, and the run goes on."""
    seqs, mono = tmp_path / "n.fa", tmp_path / "m.fa"
    seqs.write_text(">r\nACGTNNACGTACGT\n")
    mono.write_text(">m\nACGTACGT\n")
    out = _both_clis([str(seqs), str(mono), "-b", "16", "-v", "4", "--device-batch", "2"],
                     tmp_path)
    assert "contain N symbol" in (out / "stringdecomposer.log").read_text()
    assert (out / "final_decomposition.tsv").read_text().splitlines()


def test_gzip_fasta_input(tmp_path):
    seqs, mono = tmp_path / "seqs.fa.gz", tmp_path / "m.fa"
    with gzip.open(seqs, "wt") as f:
        f.write(">r1\nACGTACGTACGTACGT\n")
    mono.write_text(">m\nACGTACGT\n")
    out = _both_clis([str(seqs), str(mono), "-b", "16", "-v", "4", "--device-batch", "2"],
                     tmp_path)
    assert (out / "final_decomposition.tsv").read_text().splitlines()


RUN = dict(device_batch=2, batch_size=16, overlap=4)


def test_crash_midrun_preserves_previous_outputs(tiny_case, monkeypatch):
    """A run that dies mid-finishing leaves the previous run's TSVs whole
    and invalidates the raw TSV's stamp first."""
    seqs, mono, tmp = tiny_case
    out = str(tmp / "t")
    pipeline.run(seqs, mono, out_dir=out, device="cpu", **RUN)
    jax_run(seqs, mono, out_dir=str(tmp / "jax"), **RUN)
    before = _outs(out)
    assert before == _outs(tmp / "jax")

    def boom(*a, **k):
        raise RuntimeError("injected mid-finishing crash")

    monkeypatch.setattr(finishing, "write_final_rows", boom)
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run(seqs, mono, out_dir=out, device="cpu", **RUN)
    assert _outs(out) == before
    assert not os.path.exists(os.path.join(out, "final_decomposition_raw.tsv.stamp"))


def test_success_leaves_no_tmp_files(tiny_case):
    seqs, mono, tmp = tiny_case
    out, out2 = str(tmp / "t"), str(tmp / "t" / "streamed")
    pipeline.run(seqs, mono, out_dir=out, device="cpu", **RUN)
    assert not [p for p in os.listdir(out) if p.endswith(".tmp")]
    pipeline.run(seqs, mono, out_dir=out2, device="cpu", stream_reads=1, **RUN)
    assert not [p for p in os.listdir(out2) if p.endswith(".tmp")]
    assert filecmp.cmp(os.path.join(out, "final_decomposition.tsv"),
                       os.path.join(out2, "final_decomposition.tsv"), shallow=False)
    jax_run(seqs, mono, out_dir=str(tmp / "jax"), **RUN)
    assert _outs(out) == _outs(tmp / "jax")


def _stream_case():
    rng = np.random.default_rng(3)
    reads, per_read = {}, []
    for r in range(3):
        seq = "".join(rng.choice(list("ACGT"), size=150))
        reads[f"r{r}"] = seq
        per_read.append((f"r{r}", [{"m": "m", "start": s, "end": min(s + 16, len(seq) - 1)}
                                   for s in range(0, 140, 17)]))
    per_read.append(("r3", []))  # a read with no block
    reads["r3"] = "ACGT"
    return per_read, reads


def _final_text(finished) -> tuple[str, str]:
    fout, falt = io.StringIO(), io.StringIO()
    finishing.write_final_rows(fout, falt, finished)
    return fout.getvalue(), falt.getvalue()


def test_flush_boundaries_do_not_change_output():
    per_read, reads = _stream_case()
    monomers = add_rc_interleaved([Record("m", MONO)])
    big = finishing.finish_reads(per_read, reads, monomers, "cpu", second_best=True)
    assert [n for n, _ in big] == ["r0", "r1", "r2", "r3"]
    want = jax_finishing.finish_reads(per_read, reads, jax_rc_interleaved([JRecord("m", MONO)]),
                                      second_best=True)
    assert _final_text(big) == _final_text(want)
    for fp in (1, 7, 16, 64):
        small = finishing.finish_reads(per_read, reads, monomers, "cpu", second_best=True,
                                       flush_pairs=fp)
        assert _final_text(small) == _final_text(big), fp


def test_duplicate_monomer_names_second_best():
    """The last occurrence of a duplicated name carries its score; no column
    of the best name is second best; homo ranking keeps duplicates."""
    reads = {"r": "ACGGTCTGAACTTGGCAACGT"}
    seqs = [("m", "ACGGTCTGAACTTGGCA"), ("x", "TTTTTTTTTTTTTTTTT"), ("m", "ACGGTCTGAACTTGGCT")]
    per_read = [("r", [{"m": "m", "start": 0, "end": 16}])]
    res = finishing.finish_reads(per_read, reads, [Record(n, s) for n, s in seqs], "cpu",
                                 second_best=True)
    b = res[0][1][0]
    assert b.second_best == "x"
    assert abs(b.score - (16 / 17) * 100.0) < 1e-9
    assert set(b.alt) == {"m", "x"} and abs(b.alt["m"] - b.score) < 1e-9
    assert b.homo_best == "m" and b.homo_second_best == "m"
    want = jax_finishing.finish_reads(per_read, reads, [JRecord(n, s) for n, s in seqs],
                                      second_best=True)
    assert _final_text(res) == _final_text(want)


def test_single_monomer_second_best_is_none():
    reads = {"r": "ACGGTCTGAACTTGGCA"}
    per_read = [("r", [{"m": "m", "start": 0, "end": 16}])]
    res = finishing.finish_reads(per_read, reads, [Record("m", MONO)], "cpu", second_best=True)
    b = res[0][1][0]
    assert b.second_best == "None" and b.second_best_score == -1
    want = jax_finishing.finish_reads(per_read, reads, [JRecord("m", MONO)], second_best=True)
    assert _final_text(res) == _final_text(want)


def _reads_fa(path, n_reads=6, descriptions=False):
    rng = np.random.default_rng(21)
    lines = []
    for i in range(n_reads):
        n = int(rng.integers(40, 180))
        arr = np.array(list((MONO * (n // len(MONO) + 1))[:n]))
        idx = rng.integers(0, n, max(1, n // 10))
        arr[idx] = rng.choice(list("ACGT"), len(idx))
        desc = f" read {i} len={n} desc\twith tab" if descriptions and i % 2 == 0 else ""
        lines.append(f">r{i}{desc}\n{''.join(arr)}\n")
    path.write_text("".join(lines))
    return str(path)


@pytest.fixture
def mix(tmp_path):
    mono = tmp_path / "m.fa"
    mono.write_text(f">m\n{MONO}\n>m2\n{MONO[4:]}TTGCA\n>m3\n{MONO[::-1]}\n")
    return str(mono), tmp_path


@pytest.mark.parametrize("second_best", [False, True])
def test_stream_reads_with_ed_thr_min_identity_and_scoring(mix, second_best):
    mono, tmp = mix
    seqs = _reads_fa(tmp / "seqs.fa")
    _both_clis([seqs, mono, "-b", "64", "-v", "8", "--device-batch", "3", "--stream-reads", "2",
                "--ed_thr", "6", "-i", "55", "-s-2,-1,-3,2"]
               + (["--second-best"] if second_best else []), tmp)


def test_headers_with_a_description(mix):
    mono, tmp = mix
    seqs = _reads_fa(tmp / "seqs.fa", descriptions=True)
    out = _both_clis([seqs, mono, "-b", "64", "-v", "8", "--device-batch", "3",
                      "--second-best"], tmp)
    names = {ln.split("\t")[0] for ln in (out / TSVS[0]).read_text().splitlines()}
    assert "r0" in names and not any(" " in n for n in names)


def test_resume_of_a_raw_tsv_the_jax_package_wrote(mix):
    """The JAX package's raw TSV and stamp resume in the port with no K1
    launch, into the JAX package's own final and alt bytes."""
    mono, tmp = mix
    seqs = _reads_fa(tmp / "seqs.fa")
    kw = dict(batch_size=64, overlap=8, device_batch=3)
    jax_run(seqs, mono, out_dir=str(tmp / "jax"), second_best=True, **kw)
    want = _outs(tmp / "jax")
    os.makedirs(tmp / "t")
    for n in (TSVS[2], TSVS[2] + ".stamp"):
        (tmp / "t" / n).write_bytes((tmp / "jax" / n).read_bytes())

    def no_k1(*a, **k):
        raise AssertionError("K1 launched on a resumed run")

    pipeline.run(seqs, mono, out_dir=str(tmp / "t"), second_best=True, resume=True,
                 device="cpu", forward_fn=no_k1, **kw)
    assert _outs(tmp / "t") == want
