"""The port's one-GPU run modes on the CPU (--device cpu, the plain twins),
byte for byte against the JAX package on the same seeded inputs:
--stream-reads (against JAX's _run_streaming and the port's one-shot run),
--resume (a second run launches no K1; changed inputs and stale stamps
recompute), --serve with --precompile (a subprocess, one JSON line a job),
precompile_menu's coverage of a later job, and --profile-dir."""

import filecmp
import gzip
import json
import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stringdecomposer_tpu import cli as jax_cli
from stringdecomposer_tpu.pipeline import run as jax_run
from stringdecomposer_tpu_torch import cli, pipeline

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TSVS = ("final_decomposition.tsv", "final_decomposition_alt.tsv", "final_decomposition_raw.tsv")
UNIT = "ACGGTCTGAACTTGGCA"
COMMON = dict(batch_size=64, overlap=8, device_batch=4)
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def _outs(d) -> dict:
    return {n: (pathlib.Path(d) / n).read_text() for n in TSVS}


def _reads_fa(path, rng, n_reads=7, lo=30, hi=200, dup_names=False):
    lines = []
    for i in range(n_reads):
        n = int(rng.integers(lo, hi))
        arr = np.array(list((UNIT * (n // len(UNIT) + 1))[:n]))
        idx = rng.integers(0, n, max(1, n // 12))
        arr[idx] = rng.choice(list("ACGT"), len(idx))
        name = f"r{i - 1}" if dup_names and i % 3 == 2 else f"r{i}"
        lines.append(f">{name}\n{''.join(arr)}\n")
    path.write_text("".join(lines))
    return str(path)


@pytest.fixture
def case(tmp_path):
    seqs = _reads_fa(tmp_path / "seqs.fa", np.random.default_rng(17))
    mono = tmp_path / "m.fa"
    mono.write_text(f">m\n{UNIT}\n")
    return seqs, str(mono), tmp_path


@pytest.mark.parametrize("second_best", [False, True])
def test_streaming_matches_jax_and_oneshot(case, second_best):
    seqs, mono, tmp = case
    jax_run(seqs, mono, out_dir=str(tmp / "jax"), second_best=second_best, stream_reads=3,
            **COMMON)
    want = _outs(tmp / "jax")
    pipeline.run(seqs, mono, out_dir=str(tmp / "one"), second_best=second_best, device="cpu",
                 **COMMON)
    assert _outs(tmp / "one") == want and want[TSVS[0]]
    for n in (1, 3, 100):
        pipeline.run(seqs, mono, out_dir=str(tmp / f"s{n}"), second_best=second_best,
                     stream_reads=n, device="cpu", **COMMON)
        assert _outs(tmp / f"s{n}") == want, n


def test_streaming_gzip(case):
    seqs, mono, tmp = case
    gz = tmp / "seqs.fa.gz"
    with gzip.open(gz, "wt") as f:
        f.write(open(seqs).read())
    jax_run(str(gz), mono, out_dir=str(tmp / "jax"), stream_reads=2, **COMMON)
    pipeline.run(seqs, mono, out_dir=str(tmp / "plain"), device="cpu", **COMMON)
    pipeline.run(str(gz), mono, out_dir=str(tmp / "gz"), stream_reads=2, device="cpu", **COMMON)
    assert _outs(tmp / "gz") == _outs(tmp / "plain") == _outs(tmp / "jax")


def test_streaming_blank_header(tmp_path):
    """A '>' header of only whitespace is a read with an empty name, in the
    port's readers as in the JAX package's; --stream-reads runs it (the
    JAX package's runner stops at its raw rows) to the one-shot run's
    bytes, which are the JAX package's."""
    from stringdecomposer_tpu_torch.io.fasta import iter_fasta, parse_fasta

    text = f">  \n{UNIT * 3}\n>r2\n{UNIT[3:] * 2}\n"
    p = tmp_path / "blank.fa"
    p.write_text(text)
    for recs in (list(iter_fasta(str(p))), parse_fasta(text)):
        assert [r.name for r in recs] == ["", "r2"]
        assert [r.seq for r in recs] == [UNIT * 3, UNIT[3:] * 2]
    mono = tmp_path / "m.fa"
    mono.write_text(f">m\n{UNIT}\n")
    jax_run(str(p), str(mono), out_dir=str(tmp_path / "jax"), second_best=True, **COMMON)
    pipeline.run(str(p), str(mono), out_dir=str(tmp_path / "t"), stream_reads=1,
                 second_best=True, device="cpu", **COMMON)
    assert _outs(tmp_path / "t") == _outs(tmp_path / "jax")
    assert _outs(tmp_path / "t")[TSVS[0]].startswith("\tm\t")


@pytest.mark.parametrize("seed", range(6))
def test_streaming_equals_oneshot_adversarial(tmp_path, seed):
    """Random read mixes (reads with no window, exact window multiples,
    duplicate names) through --stream-reads at several group sizes give the
    port's one-shot bytes, which are the JAX package's."""
    rng = np.random.default_rng(1000 + seed)
    part, overlap = 64, 8
    lengths = []
    for _ in range(int(rng.integers(3, 8))):
        kind = rng.integers(0, 4)
        if kind == 0:
            lengths.append(int(rng.integers(1, overlap)))  # no window
        elif kind == 1:
            lengths.append(part * int(rng.integers(1, 3)))  # an exact multiple
        elif kind == 2:
            lengths.append(part + int(rng.integers(0, overlap + 1)))
        else:
            lengths.append(int(rng.integers(20, 300)))
    names, lines = [], []
    for i, n in enumerate(lengths):
        arr = np.array(list((UNIT * (n // len(UNIT) + 1))[:n]))
        idx = rng.integers(0, n, max(1, n // 10))
        arr[idx] = rng.choice(list("ACGT"), len(idx))
        name = f"r{i}" if rng.random() > 0.33 or not names else names[-1]
        names.append(name)
        lines.append(f">{name}\n{''.join(arr)}\n")
    seqs = tmp_path / "seqs.fa"
    seqs.write_text("".join(lines))
    mono = tmp_path / "m.fa"
    mono.write_text(f">m\n{UNIT}\n")
    common = dict(batch_size=part, overlap=overlap, device_batch=4, second_best=True)
    jax_run(str(seqs), str(mono), out_dir=str(tmp_path / "jax"), **common)
    want = _outs(tmp_path / "jax")
    pipeline.run(str(seqs), str(mono), out_dir=str(tmp_path / "one"), device="cpu", **common)
    assert _outs(tmp_path / "one") == want
    for gsz in (1, 2, 100):
        pipeline.run(str(seqs), str(mono), out_dir=str(tmp_path / f"s{gsz}"), stream_reads=gsz,
                     device="cpu", **common)
        assert _outs(tmp_path / f"s{gsz}") == want, (seed, gsz)


def _no_k1(*args, **kwargs):
    raise AssertionError("K1 launched on a resumed run")


@pytest.fixture
def resumable(tmp_path):
    """Reads with a duplicate name, a --second-best run of the port and of
    the JAX package, and the JAX package's light-mode resume of its run."""
    seqs = _reads_fa(tmp_path / "seqs.fa", np.random.default_rng(3), dup_names=True)
    mono = tmp_path / "m.fa"
    mono.write_text(f">m\n{UNIT}\n>m2\n{UNIT[5:]}ACGTA\n")
    jax_run(seqs, str(mono), out_dir=str(tmp_path / "jax"), second_best=True, **COMMON)
    jax_run(seqs, str(mono), out_dir=str(tmp_path / "jax"), resume=True, **COMMON)
    pipeline.run(seqs, str(mono), out_dir=str(tmp_path / "t"), second_best=True, device="cpu",
                 **COMMON)
    return seqs, str(mono), tmp_path


def test_resume_launches_no_k1(resumable):
    """The second run (light mode) finishes from the raw TSV alone: no K1,
    and the JAX package's resumed bytes, duplicate read names included."""
    seqs, mono, tmp = resumable
    pipeline.run(seqs, mono, out_dir=str(tmp / "t"), resume=True, device="cpu",
                 forward_fn=_no_k1, **COMMON)
    assert _outs(tmp / "t") == _outs(tmp / "jax")
    assert open(seqs).read().count(">r1\n") == 2


def test_resume_changed_inputs_recompute(resumable):
    seqs, mono, tmp = resumable
    with open(seqs, "a") as f:
        f.write(f">extra\n{UNIT * 4}\n")
    calls = []

    def forward(*a, **k):
        calls.append(1)
        return pipeline.chain_dp_forward_cuda(*a, **k)

    pipeline.run(seqs, mono, out_dir=str(tmp / "t"), resume=True, device="cpu",
                 forward_fn=forward, **COMMON)
    jax_run(seqs, mono, out_dir=str(tmp / "jax2"), **COMMON)
    assert calls and _outs(tmp / "t") == _outs(tmp / "jax2")
    assert "extra\t" in _outs(tmp / "t")[TSVS[0]]


def test_resume_stale_stamp_recomputes_with_warning(resumable, caplog):
    seqs, mono, tmp = resumable
    (tmp / "t" / (TSVS[2] + ".stamp")).write_text("0" * 64 + "\n")
    caplog.set_level(logging.WARNING, logger="SD-TPU")
    calls = []

    def forward(*a, **k):
        calls.append(1)
        return pipeline.chain_dp_forward_cuda(*a, **k)

    pipeline.run(seqs, mono, out_dir=str(tmp / "t"), resume=True, device="cpu",
                 forward_fn=forward, **COMMON)
    # a fresh run keys reads by position, a resumed one by name: with the
    # duplicate name the two differ, and this one is fresh
    jax_run(seqs, mono, out_dir=str(tmp / "jax2"), **COMMON)
    assert calls and _outs(tmp / "t") == _outs(tmp / "jax2") != _outs(tmp / "jax")
    assert "--resume: " in caplog.text and "was produced from different inputs; recomputing" \
        in caplog.text
    assert (tmp / "t" / (TSVS[2] + ".stamp")).read_text() == \
        (tmp / "jax" / (TSVS[2] + ".stamp")).read_text()


def _serve(tmp, jobs: str, *flags: str) -> list[dict]:
    """Run `--serve` with `flags` on these job lines, on a machine that
    shows no card; returns its JSON status lines and its stdout."""
    res = subprocess.run([sys.executable, "-m", "stringdecomposer_tpu_torch", "--serve", *flags],
                         input=jobs, capture_output=True, text=True, timeout=600,
                         env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, cwd=tmp)
    assert res.returncode == 0, res.stderr
    return [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")], res.stdout


def test_serve_with_precompile(case):
    """One process, one JSON status line a job: two good jobs and a bad line
    give ok, ok, error; the good jobs' TSVs equal the JAX CLI's."""
    seqs, mono, tmp = case
    flags = ["-b", "64", "-v", "8", "--device-batch", "4"]
    jobs = (f"{seqs} {mono} -o {tmp}/j1\n"
            f"{seqs} {mono} -o {tmp}/j2 --second-best --out-file x\n"
            "--no-such-flag\n")
    lines, out = _serve(tmp, jobs, "--precompile", mono, "--device", "cpu", *flags)
    assert [x["status"] for x in lines] == ["ok", "ok", "error"], out
    assert lines[0] == {"status": "ok", "rc": 0, "final": f"{tmp}/j1/final_decomposition.tsv"}
    assert lines[2] == {"status": "error", "rc": 2, "error": "bad arguments"}
    for job, jflags, base in (("j1", [], "final_decomposition"),
                              ("j2", ["--second-best", "--out-file", "x"], "x")):
        assert jax_cli.main([seqs, mono, "-o", str(tmp / f"jax_{job}"), *flags, *jflags]) == 0
        for n in TSVS:
            n = n.replace("final_decomposition", base)
            assert filecmp.cmp(tmp / job / n, tmp / f"jax_{job}" / n, shallow=False), (job, n)


def test_serve_reports_failed_jobs_and_goes_on(case):
    """A job on a card this machine does not have (--device cuda, the
    default) and a job on a missing file each say "error"; nothing runs on
    the CPU in their place, and the next job runs."""
    seqs, mono, tmp = case
    jobs = (f"{seqs} {mono} -o {tmp}/j1\n"
            f"missing.fa {mono} -o {tmp}/j2 --device cpu\n"
            f"{seqs} {mono} -o {tmp}/j3 --device cpu -b 64 -v 8\n")
    lines, out = _serve(tmp, jobs)
    assert [x["status"] for x in lines] == ["error", "error", "ok"], out
    assert "torch.cuda.is_available() is False" in lines[0]["error"]
    assert not (tmp / "j1" / TSVS[0]).exists() and (tmp / "j3" / TSVS[0]).stat().st_size


def test_precompile_menu_covers_a_later_job(tmp_path, monkeypatch):
    """Every (rows, width) window batch of a job with read lengths the
    warm-up never saw is matched by a warm-up batch of the same width and
    at least as many rows (JAX's test_precompile.py holds its compile keys
    so)."""
    mono = tmp_path / "m.fa"
    mono.write_text(f">m\n{UNIT}\n")
    kw = dict(device_batch=4, batch_size=16, overlap=4, second_best=True, device="cpu")
    shapes = []
    build = pipeline.build_window_batch

    def spy(wins, W):
        shapes.append((len(wins), W))
        return build(wins, W)

    monkeypatch.setattr(pipeline, "build_window_batch", spy)
    pipeline.precompile_menu(str(mono), **kw)
    warm = list(shapes)
    shapes.clear()
    rng = np.random.default_rng(3)
    lines = []
    for i, n in enumerate([3, 11, 17, 23, 40, 95]):
        arr = np.array(list((UNIT * (n // len(UNIT) + 1))[:n]))
        idx = rng.integers(0, n, max(1, n // 10))
        arr[idx] = rng.choice(list("ACGT"), len(idx))
        lines.append(f">j{i}\n{''.join(arr)}\n")
    seqs = tmp_path / "job.fa"
    seqs.write_text("".join(lines))
    pipeline.run(str(seqs), str(mono), out_dir=str(tmp_path / "out"), **kw)
    assert warm and shapes
    for rows, W in shapes:
        assert any(W == w and rows <= r for r, w in warm), (rows, W, warm)


def test_profile_dir_writes_a_trace(case):
    seqs, mono, tmp = case
    args = [seqs, mono, "-b", "64", "-v", "8", "--device-batch", "4", "--second-best",
            "--device", "cpu"]
    assert cli.main([*args, "-o", str(tmp / "plain")]) == 0
    assert cli.main([*args, "-o", str(tmp / "prof"), "--profile-dir", str(tmp / "trace")]) == 0
    assert _outs(tmp / "prof") == _outs(tmp / "plain")
    traces = list((tmp / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
