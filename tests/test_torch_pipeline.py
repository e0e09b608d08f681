"""The PyTorch port end to end on the CPU (--device cpu, the plain twins):
the reference binary's raw fixtures, byte-equality with the JAX package's
run() on a prefix of the golden read, the CLI contract, and the rules that
the port never imports jax and never falls back from CUDA to the CPU."""

import filecmp
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement, load_fasta, write_fasta
from stringdecomposer_tpu.ops.oracle import Scoring
from stringdecomposer_tpu.report import format_raw_rows
from stringdecomposer_tpu_torch import pipeline

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
N_CASES = sum(len(json.loads((FIXTURES / n).read_text()))
              for n in ("random_cases.json", "random_cases_b.json"))
TSVS = ("final_decomposition_raw.tsv", "final_decomposition.tsv", "final_decomposition_alt.tsv")
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


@pytest.mark.parametrize("idx", range(N_CASES))
def test_decompose_reads_matches_reference_raw(random_cases, idx):
    case = random_cases[idx]
    monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
    cfg = pipeline.PipelineConfig(scoring=Scoring(*case["scoring"]), part_size=case["part_size"],
                                  overlap=case["overlap"], device_batch=3)
    reads = [Record(n, s) for n, s in (case.get("reads") or [["read0", case["read"]]])]
    result = pipeline.decompose_reads(reads, monomers, cfg, device="cpu")
    names = [m.name for m in monomers]
    got = "".join(r + "\n" for rn, b in result for r in format_raw_rows(rn, b, names))
    assert got == case["raw"]


@pytest.fixture(scope="module")
def golden_prefix(tmp_path_factory, test_data_dir):
    """A 12 kbp prefix of the golden read, and the JAX package's outputs for
    it with and without --second-best (the light run reuses the raw stage
    through --resume)."""
    from stringdecomposer_tpu.pipeline import run as jax_run

    d = tmp_path_factory.mktemp("golden_prefix")
    read = load_fasta(test_data_dir / "read.fa")[0]
    fa = d / "read12k.fa"
    write_fasta(str(fa), [Record(read.name, read.seq[:12000])])
    mono = str(test_data_dir / "DXZ1_star_monomers.fa")
    jax_run(str(fa), mono, out_dir=str(d / "jax_light"), second_best=True)
    shutil.copytree(d / "jax_light", d / "jax")
    jax_run(str(fa), mono, out_dir=str(d / "jax_light"), second_best=False, resume=True)
    return fa, mono, d


@pytest.mark.parametrize("second_best", [False, True])
def test_run_matches_jax_run(golden_prefix, second_best):
    fa, mono, d = golden_prefix
    out = d / f"torch_{second_best}"
    pipeline.run(str(fa), mono, out_dir=str(out), second_best=second_best, device="cpu")
    ref = d / ("jax" if second_best else "jax_light")
    for f in TSVS:
        assert filecmp.cmp(out / f, ref / f, shallow=False), f
    assert (out / TSVS[0]).stat().st_size > 0 and (out / TSVS[1]).stat().st_size > 0


def test_run_ed_thr_matches_jax_run(golden_prefix):
    """--ed_thr 10 --second-best: the three TSVs and the raw-stage stamp
    (which carries ed_thr) equal the JAX package's."""
    from stringdecomposer_tpu.pipeline import run as jax_run

    fa, mono, d = golden_prefix
    jax_run(str(fa), mono, out_dir=str(d / "jax_ed10"), second_best=True, ed_thr=10)
    out = d / "torch_ed10"
    pipeline.run(str(fa), mono, out_dir=str(out), second_best=True, ed_thr=10, device="cpu")
    for f in TSVS + (TSVS[0] + ".stamp",):
        assert filecmp.cmp(out / f, d / "jax_ed10" / f, shallow=False), f
    assert (out / TSVS[0]).stat().st_size > 0


def test_raw_stamp_carries_ed_thr(tmp_path):
    from stringdecomposer_tpu.pipeline import stage_fingerprint as jax_fingerprint

    fa, mono = _small_inputs(tmp_path, "ACGTTGCAAGGTTTGACCATGCAG" * 3)
    stamps = []
    for ed_thr in (-1, 5):
        out = tmp_path / f"o{ed_thr}"
        pipeline.run(str(fa), str(mono), out_dir=str(out), ed_thr=ed_thr, device="cpu")
        stamp = (out / (TSVS[0] + ".stamp")).read_text().strip()
        assert stamp == jax_fingerprint(str(fa), str(mono), "-1,-1,-1,1", 5000, 500, ed_thr)
        stamps.append(stamp)
    assert stamps[0] != stamps[1]


@pytest.mark.parametrize("second_best", [False, True])
def test_finish_reads_matches_jax(golden_prefix, second_best):
    """finish_reads with positional keys: two entries share a read name but
    score against different sequences, and a tiny flush size splits the
    read into chunks that must re-merge."""
    import io

    from stringdecomposer_tpu import finishing as jf
    from stringdecomposer_tpu.io.fasta import add_rc_interleaved
    from stringdecomposer_tpu.report import parse_raw_tsv
    from stringdecomposer_tpu_torch import finishing as tf

    fa, mono, d = golden_prefix
    name, blocks = parse_raw_tsv((d / "jax" / TSVS[0]).read_text())[0]
    seq = load_fasta(str(fa))[0].seq
    entries = [(name, blocks[:12], 0), (name, blocks[:12], 1)]
    flush = 5 * (48 if second_best else 1)  # 5 blocks per chunk
    reads = {0: seq, 1: seq[::-1]}
    fin = add_rc_interleaved(load_fasta(mono, upper=True))
    outs = []
    for finish in (lambda: jf.finish_reads(entries, reads, fin, second_best=second_best,
                                           flush_pairs=flush),
                   lambda: tf.finish_reads(entries, reads, fin, "cpu", second_best=second_best,
                                           flush_pairs=flush)):
        fout, falt = io.StringIO(), io.StringIO()
        tf.write_final_rows(fout, falt, finish())
        outs.append((fout.getvalue(), falt.getvalue()))
    assert outs[0] == outs[1]
    half = len(outs[1][0]) // 2
    assert outs[1][0][:half] != outs[1][0][half:]  # the two keys scored differently


@pytest.mark.parametrize("second_best", [False, True])
def test_finish_reads_threads_agree(golden_prefix, second_best):
    """Four finishing threads (-t 4) share the resident-read FIFO and the
    launch counters, and give the rows of one thread."""
    import io

    from stringdecomposer_tpu.io.fasta import add_rc_interleaved
    from stringdecomposer_tpu.report import parse_raw_tsv
    from stringdecomposer_tpu_torch import finishing as tf

    fa, mono, d = golden_prefix
    name, blocks = parse_raw_tsv((d / "jax" / TSVS[0]).read_text())[0]
    seq = load_fasta(str(fa))[0].seq
    entries = [(name, blocks[i : i + 4], i) for i in range(0, 40, 4)]
    reads = {i: seq for i in range(0, 40, 4)}
    fin = add_rc_interleaved(load_fasta(mono, upper=True))
    outs = []
    for threads in (1, 4):
        fout, falt = io.StringIO(), io.StringIO()
        tf.write_final_rows(fout, falt, tf.finish_reads(
            entries, reads, fin, "cpu", second_best=second_best,
            flush_pairs=4 * (48 if second_best else 1), threads=threads))
        outs.append((fout.getvalue(), falt.getvalue()))
    assert outs[0] == outs[1] and outs[0][0]


def _cli(*args, cwd=None):
    return subprocess.run([sys.executable, "-m", "stringdecomposer_tpu_torch", *map(str, args)],
                          capture_output=True, text=True, env=ENV, cwd=cwd, timeout=300)


def _small_inputs(tmp_path, seq):
    fa = tmp_path / "reads.fa"
    write_fasta(str(fa), [Record("r0", seq)])
    mono = tmp_path / "mono.fa"
    write_fasta(str(mono), [Record("m0", "ACGTTGCAAGGT"), Record("m1", "TTGACCATGCAG")])
    return fa, mono


def test_cli_runs_and_logs_sentinel(tmp_path):
    fa, mono = _small_inputs(tmp_path, "ACGTTGCAAGGTTTGACCATGCAGACGTTGCATGGT" * 3)
    res = _cli(fa, mono, "-o", tmp_path / "out", "--second-best", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    log = (tmp_path / "out" / "stringdecomposer.log").read_text()
    assert "Thank you for using StringDecomposer!" in log
    assert (tmp_path / "out" / "final_decomposition.tsv").stat().st_size > 0


def test_cli_lowercase_input_exits_255(tmp_path):
    fa, mono = _small_inputs(tmp_path, "acgttgcaaggt")
    res = _cli(fa, mono, "-o", tmp_path / "out", "--device", "cpu")
    assert res.returncode == 255


def _jax_option_strings():
    from stringdecomposer_tpu.cli import build_parser as jax_parser

    return [(s, a) for a in jax_parser()._actions for s in a.option_strings
            if s not in ("-h", "--help", "--version")]


@pytest.mark.parametrize("opt", [s for s, _ in _jax_option_strings()])
def test_cli_parses_every_jax_option(opt):
    """Every option string of the JAX CLI parses in the port's parser, with
    the JAX option's default as its value (or a sample where that is None),
    into the same destination and value."""
    from stringdecomposer_tpu_torch.cli import build_parser

    action = dict(_jax_option_strings())[opt]
    if action.nargs == 0:  # a switch
        value = None
    elif action.default is not None:
        value = str(action.default)
    else:
        value = "1" if action.type is int else "x"
    # one token, so that a value such as "-1,-1,-1,1" is not read as an option
    token = opt if value is None else opt + ("=" if opt.startswith("--") else "") + value
    args = build_parser().parse_args(["reads.fa", "mono.fa", token])
    want = True if value is None else (action.type(value) if action.type else value)
    assert getattr(args, action.dest) == want


def test_cli_host_id_0_num_processes_1_matches_jax_cli(tmp_path):
    """`--host-id 0 --num-processes 1` (the JAX CLI's single-host values)
    runs rc 0 on the CPU and writes the JAX CLI's three TSVs, byte for byte."""
    from stringdecomposer_tpu import cli as jax_cli

    fa, mono = _small_inputs(tmp_path, "ACGTTGCAAGGTTTGACCATGCAGACGTTGCATGGT" * 4)
    flags = ["--second-best", "--host-id", "0", "--num-processes", "1"]
    assert jax_cli.main([str(fa), str(mono), "-o", str(tmp_path / "jax"), *flags]) == 0
    res = _cli(fa, mono, "-o", tmp_path / "torch", "--device", "cpu", *flags)
    assert res.returncode == 0, res.stderr
    for f in TSVS:
        assert filecmp.cmp(tmp_path / "torch" / f, tmp_path / "jax" / f, shallow=False), f
    assert (tmp_path / "torch" / TSVS[0]).stat().st_size > 0


@pytest.mark.parametrize("flags", [["--data-parallel"], ["--data-parallel", "--second-best"],
                                   ["--host-id", "1"], ["--num-processes", "2"],
                                   ["--num-processes", "0"], ["--num-hosts", "2"],
                                   ["--num-hosts", "2", "--second-best", "--stream-reads", "1"]])
def test_cli_multi_device_flags_match_jax_cli(tmp_path, flags):
    """The JAX CLI's flags of more than one device or host run with rc 0 on
    the CPU and write the JAX CLI's three TSVs, byte for byte: the flags
    that are single-host in JAX (--data-parallel, a lone --host-id or
    --num-processes) against jax_cli.main on the same flags; --num-hosts 2
    as two port processes (host 1 and host 0, started together) into one
    out-dir, against the JAX CLI's one-process run. (--coordinator:
    tests/test_torch_multihost.py::test_coordinator_two_processes_match_jax_cli.)"""
    from stringdecomposer_tpu import cli as jax_cli

    fa = tmp_path / "reads.fa"
    seq = "ACGTTGCAAGGTTTGACCATGCAGACGTTGCATGGT"
    write_fasta(str(fa), [Record(f"r{i}", seq * (i + 2)) for i in range(3)])
    mono = tmp_path / "mono.fa"
    write_fasta(str(mono), [Record("m0", "ACGTTGCAAGGT"), Record("m1", "TTGACCATGCAG")])
    multihost = "--num-hosts" in flags
    jax_flags = [f for f in flags if f not in ("--num-hosts", "2")] if multihost else flags
    assert jax_cli.main([str(fa), str(mono), "-o", str(tmp_path / "jax"), *jax_flags]) == 0
    out = tmp_path / "torch"
    if multihost:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "stringdecomposer_tpu_torch", str(fa), str(mono), "-o",
             str(out), "--device", "cpu", *flags, "--host-id", str(h)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
            for h in (1, 0)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=120)
                assert p.returncode == 0, err[-3000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert (out / "final_decomposition_raw.shard00001.tsv").exists()
    else:
        res = _cli(fa, mono, "-o", out, "--device", "cpu", *flags)
        assert res.returncode == 0, res.stderr
    for f in TSVS:
        assert filecmp.cmp(out / f, tmp_path / "jax" / f, shallow=False), f
    assert (out / TSVS[1]).stat().st_size > 0


def test_cli_data_parallel_without_a_card_raises(tmp_path, monkeypatch):
    """--data-parallel on the default device asks for every GPU: without a
    card it raises, and never shards over the CPU instead."""
    from stringdecomposer_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa, mono = _small_inputs(tmp_path, "ACGTTGCAAGGT")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([str(fa), str(mono), "-o", str(tmp_path / "o"), "--data-parallel"])
    assert not (tmp_path / "o" / TSVS[0]).exists()


def test_port_never_imports_jax(tmp_path):
    fa, mono = _small_inputs(tmp_path, "ACGTTGCAAGGTTTGACCATGCAG" * 2)
    code = (
        "import sys\n"
        "import stringdecomposer_tpu_torch as p\n"
        "from stringdecomposer_tpu_torch import cli\n"
        f"assert cli.main([{str(fa)!r}, {str(mono)!r}, '-o', {str(tmp_path / 'o')!r},"
        " '--second-best', '--device', 'cpu', '--ed_thr', '5']) == 0\n"
        "p.decompose_reads\n"
        "from stringdecomposer_tpu_torch.ops import align, banded, banded_cuda\n"
        "for backend in ('scan', 'kernel'):\n"
        "    banded.DEFAULT_BACKEND = backend\n"
        "    r = align.align('ACGTTGCA' * 30, 'ACGTTCA' * 30, mode='HW', task='path', k=40,"
        " device='cpu')\n"
        "    assert r['editDistance'] == 30, r\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NOJAX" in res.stdout


def test_help_does_not_import_torch():
    code = ("import sys\nfrom stringdecomposer_tpu_torch import cli\n"
            "cli.build_parser().format_help()\nassert 'torch' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa, mono = _small_inputs(tmp_path, "ACGTTGCAAGGT")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.run(str(fa), str(mono), out_dir=str(tmp_path / "o"), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.decompose_reads([Record("r", "ACGT")], [Record("m", "ACGT")], device="cuda")
    assert not (tmp_path / "o").exists()


def test_state_from_numpy_round_trip(test_data_dir):
    """The port's device state holds exactly the arrays the JAX package
    builds for the DP (pad_monomers) and for finishing (AsyncFinisher)."""
    from stringdecomposer_tpu.finishing import AsyncFinisher
    from stringdecomposer_tpu.io.fasta import add_rc_interleaved, pad_monomers
    from stringdecomposer_tpu.models.reliability import load_coefficients
    from stringdecomposer_tpu_torch.convert import numpy_state, pad_codes, state_from_numpy

    fwd = load_fasta(test_data_dir / "DXZ1_star_monomers.fa")
    dp = add_reverse_complement(fwd)
    fin = add_rc_interleaved(load_fasta(test_data_dir / "DXZ1_star_monomers.fa", upper=True))
    mono, lens = pad_monomers(dp, pad_to=192)
    jf = AsyncFinisher({}, fin, second_best=True)
    coef = load_coefficients()
    st = state_from_numpy(mono, lens, jf.mono_codes, jf.homo_codes, coef, "cpu")
    np.testing.assert_array_equal(st.mono.numpy(), mono)
    np.testing.assert_array_equal(st.mono_lens.numpy(), lens)
    for t, tl, codes in ((st.t_raw, st.tl_raw, jf.mono_codes), (st.t_homo, st.tl_homo, jf.homo_codes)):
        assert tl.tolist() == [len(c) for c in codes]
        for row, c in zip(t.numpy(), codes):
            np.testing.assert_array_equal(row[: len(c)], c)
    np.testing.assert_array_equal(st.coef, coef)
    # the port's own builder yields the same arrays
    m2, l2, f2, h2, c2 = numpy_state(dp, fin)
    np.testing.assert_array_equal(m2, mono)
    np.testing.assert_array_equal(l2, lens)
    for a, b in zip(f2 + h2, jf.mono_codes + jf.homo_codes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c2, coef)
    arr, ln = pad_codes([np.array([1, 2], np.int8), np.array([], np.int8)])
    assert arr.tolist() == [[1, 2], [0, 0]] and ln.tolist() == [2, 0]


@pytest.mark.slow
def test_full_golden_read_on_cpu(tmp_path, test_data_dir):
    out = tmp_path / "out"
    pipeline.run(str(test_data_dir / "read.fa"), str(test_data_dir / "DXZ1_star_monomers.fa"),
                 out_dir=str(out), second_best=True, device="cpu")
    assert filecmp.cmp(out / TSVS[0], test_data_dir / "raw_decomposition_oracle.tsv", shallow=False)
    assert filecmp.cmp(out / TSVS[1], test_data_dir / "final_decomposition_fc89af8.tsv",
                       shallow=False)
