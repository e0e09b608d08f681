"""The port's data parallelism (stringdecomposer_tpu_torch/parallel/sharding.py
and ops/align._rows_sharded) on the CPU, against the JAX package's sharded
functions on its 8-device virtual CPU mesh (tests/conftest.py) and against
the port unsharded. A repeated device list (["cpu"] * n) runs n shards on
the CPU; every output is an integer or a TSV, so the tolerance is 0."""

import filecmp

import jax
import numpy as np
import pytest
import torch

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement
from stringdecomposer_tpu.ops.oracle import Scoring
from stringdecomposer_tpu.parallel.mesh import get_mesh
from stringdecomposer_tpu.parallel import sharding as j_sharding
from stringdecomposer_tpu.report import format_raw_rows
from stringdecomposer_tpu_torch import pipeline
from stringdecomposer_tpu_torch.parallel import mesh, sharding

torch.set_num_threads(1)

TSVS = ("final_decomposition_raw.tsv", "final_decomposition.tsv", "final_decomposition_alt.tsv")
N_DEV = [2, 4, 8]


def _raw(result, monomers) -> str:
    names = [m.name for m in monomers]
    return "".join(r + "\n" for rn, b in result for r in format_raw_rows(rn, b, names))


def _blocks(result):
    return [(n, [(b.monomer, b.start, b.end, b.identity) for b in bl]) for n, bl in result]


def test_get_devices():
    assert mesh.get_devices("cpu") == [torch.device("cpu")]


def test_get_devices_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.get_devices("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.make_sharded_forward()


@pytest.mark.parametrize("n_dev", N_DEV)
def test_sharded_forward_matches_jax_and_unsharded(random_cases, n_dev):
    """Port of test_sharding.py::test_sharded_matches_reference_fixtures:
    the reference binary's raw TSV, the JAX sharded forward's and the port
    unsharded, on the first six fixture cases (device_batch 8 against 19
    or fewer windows: batches that do not divide by 4 or 8 pad)."""
    from stringdecomposer_tpu.pipeline import PipelineConfig as JConfig
    from stringdecomposer_tpu.pipeline import decompose_reads as j_decompose

    j_fwd = j_sharding.make_sharded_forward(get_mesh(jax.devices()[:n_dev]))
    fwd = sharding.make_sharded_forward(["cpu"] * n_dev)
    for case in random_cases[:6]:
        monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
        kw = dict(scoring=Scoring(*case["scoring"]), part_size=case["part_size"],
                  overlap=case["overlap"], device_batch=8)
        reads = [Record(n, s) for n, s in (case.get("reads") or [["read0", case["read"]]])]
        cfg = pipeline.PipelineConfig(**kw)
        got = _raw(pipeline.decompose_reads(reads, monomers, cfg, "cpu", forward_fn=fwd),
                   monomers)
        assert got == case["raw"]
        assert got == _raw(pipeline.decompose_reads(reads, monomers, cfg, "cpu"), monomers)
        assert got == _raw(j_decompose(reads, monomers, JConfig(**kw), forward_fn=j_fwd),
                           monomers)


@pytest.mark.parametrize("n_dev", [3, 4])
def test_sharded_ed_thr_matches_jax_and_unsharded(n_dev):
    """Port of test_sharding.py::test_sharded_ed_thr_matches_single_device:
    the rank-3 per-window monomer tensors pad and split with the windows
    (3 shards: an odd count, so the batch pads)."""
    from stringdecomposer_tpu.pipeline import PipelineConfig as JConfig
    from stringdecomposer_tpu.pipeline import decompose_reads as j_decompose

    rng = np.random.default_rng(41)
    alpha = np.array(list("ACGT"))
    monos = [Record(f"m{j}", "".join(rng.choice(alpha, 12))) for j in range(3)]
    monomers = add_reverse_complement(monos)
    seq = "".join(monos[int(rng.integers(3))].seq for _ in range(40))
    reads = [Record("r0", seq)]
    kw = dict(part_size=64, overlap=8, device_batch=8, ed_thr=4)
    cfg = pipeline.PipelineConfig(**kw)
    got = pipeline.decompose_reads(reads, monomers, cfg, "cpu",
                                   forward_fn=sharding.make_sharded_forward(["cpu"] * n_dev))
    assert _blocks(got) == _blocks(pipeline.decompose_reads(reads, monomers, cfg, "cpu"))
    j_fwd = j_sharding.make_sharded_forward(get_mesh(jax.devices()[:4]))
    assert _blocks(got) == _blocks(j_decompose(reads, monomers, JConfig(**kw), forward_fn=j_fwd))
    assert sum(len(b) for _, b in got) > 0


@pytest.mark.parametrize("n_dev", N_DEV)
def test_sharded_identity_bit_identical(n_dev):
    """Port of test_sharding.py::test_sharded_identity_kernel_bit_identical:
    37 pairs (no device count divides them), against JAX's nw_identity_batch,
    JAX's sharded identity and the port's pairwise entry unsharded."""
    from stringdecomposer_tpu.ops.identity import nw_identity_batch as j_identity
    from stringdecomposer_tpu_torch.ops.identity_cuda import nw_identity_batch_cuda

    rng = np.random.default_rng(7)
    P, Lq, Lt = 37, 96, 64
    q = rng.integers(0, 4, size=(P, Lq)).astype(np.int8)
    t = rng.integers(0, 4, size=(P, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, size=P).astype(np.int32)
    tl = rng.integers(1, Lt + 1, size=P).astype(np.int32)
    args = [torch.from_numpy(a) for a in (q, ql, t, tl)]
    got = sharding.make_sharded_identity(["cpu"] * n_dev)(*args)
    wants = (j_identity(q, ql, t, tl),
             j_sharding.make_sharded_identity(get_mesh(jax.devices()[:n_dev]))(q, ql, t, tl),
             nw_identity_batch_cuda(*args))
    for want in wants:
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("n_dev", N_DEV)
def test_sharded_packed_bit_identical(n_dev):
    """The --second-best finishing call with its blocks sharded: 13 blocks of
    a seeded read against 6 monomers, padded to 16, equal to the single
    call, at a block count no shard count divides."""
    from stringdecomposer_tpu_torch.convert import pad_codes
    from stringdecomposer_tpu_torch.finishing import _homo_codes
    from stringdecomposer_tpu_torch.ops.identity_cuda import nw_identity_packed_both

    rng = np.random.default_rng(5)
    read = torch.from_numpy(rng.integers(0, 4, 900).astype(np.int8))
    starts = rng.integers(0, 700, 13).astype(np.int64)
    lens = rng.integers(20, 190, 13).astype(np.int32)
    monos = [rng.integers(0, 4, int(n)).astype(np.int8) for n in rng.integers(150, 180, 6)]
    t_raw, tl_raw = (torch.from_numpy(a) for a in pad_codes(monos))
    t_homo, tl_homo = (torch.from_numpy(a) for a in pad_codes([_homo_codes(m) for m in monos]))
    args = (read, starts, lens, t_raw, tl_raw, t_homo, tl_homo)
    kw = dict(n_pad=16, Lq=int(lens.max()))
    want = nw_identity_packed_both(*args, **kw)
    got = sharding.make_sharded_packed(["cpu"] * n_dev)(*args, **kw)
    assert got.shape == want.shape == (2, 16 * 6, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_dev", N_DEV)
def test_finishing_with_sharded_kernels_byte_identical(tmp_path, n_dev):
    """Port of test_sharding.py::test_finishing_with_sharded_kernel_byte_identical:
    run() with every sharded function (DP windows, light-mode pairs, packed
    blocks) writes the JAX package's sharded run's bytes and the port's
    unsharded run's, with and without --second-best."""
    from stringdecomposer_tpu.pipeline import run as j_run

    rng = np.random.default_rng(3)
    alpha = np.array(list("ACGT"))
    monos = [Record(f"m{j}", "".join(rng.choice(alpha, 10))) for j in range(2)]
    seq = "".join(monos[int(rng.integers(2))].seq for _ in range(30))
    seqs = tmp_path / "seqs.fa"
    mono_fa = tmp_path / "mono.fa"
    seqs.write_text(f">r0\n{seq}\n>r1\n{seq[:83]}\n")
    mono_fa.write_text("".join(f">{m.name}\n{m.seq}\n" for m in monos))
    devs = ["cpu"] * n_dev
    kernels = dict(forward_fn=sharding.make_sharded_forward(devs),
                   identity_fn=sharding.make_sharded_identity(devs),
                   packed_fn=sharding.make_sharded_packed(devs))
    common = dict(batch_size=64, overlap=8, device_batch=8)
    for second_best in (True, False):
        d = tmp_path / str(second_best)
        j_mesh = get_mesh(jax.devices()[:n_dev])
        j_run(str(seqs), str(mono_fa), out_dir=str(d / "jax"), second_best=second_best,
              forward_fn=j_sharding.make_sharded_forward(j_mesh),
              identity_kernel=j_sharding.make_sharded_identity(j_mesh), **common)
        pipeline.run(str(seqs), str(mono_fa), out_dir=str(d / "single"), device="cpu",
                     second_best=second_best, **common)
        pipeline.run(str(seqs), str(mono_fa), out_dir=str(d / "sharded"), device="cpu",
                     second_best=second_best, **common, **kernels)
        for name in TSVS:
            for ref in ("jax", "single"):
                assert filecmp.cmp(d / "sharded" / name, d / ref / name, shallow=False), \
                    (second_best, name, ref)
        assert (d / "sharded" / TSVS[1]).stat().st_size > 0


def _align_pairs():
    """19 seeded pairs of 50-500 bp with up to 12 substitutions (the inputs
    of test_banded_pallas.py::test_align_data_parallel_byte_identical)."""
    rng = np.random.default_rng(16)
    alpha = np.array(list("ACGT"))
    qs, ts = [], []
    for _ in range(19):  # odd, > n_dev: exercises row padding
        n = int(rng.integers(50, 500))
        a = rng.integers(0, 4, n)
        b = a.copy()
        for i in sorted(rng.choice(n, int(rng.integers(0, 12)), replace=False).tolist(),
                        reverse=True):
            b[i] = (b[i] + 1 + rng.integers(3)) % 4
        qs.append("".join(alpha[a]))
        ts.append("".join(alpha[b]))
    return qs, ts


@pytest.fixture(scope="module")
def jax_align_results():
    """The JAX package's align_batch on the 19 pairs, over its 8-device mesh."""
    from stringdecomposer_tpu.ops import align as j_align

    qs, ts = _align_pairs()
    return {(mode, task): j_align.align_batch(qs, ts, mode=mode, task=task, k=40)
            for mode, task in (("NW", "path"), ("SHW", "locations"), ("HW", "locations"))}


@pytest.mark.parametrize("backend", ["scan", "kernel"])
@pytest.mark.parametrize("mode,task", [("NW", "path"), ("SHW", "locations"), ("HW", "locations")])
def test_align_rows_sharded_byte_identical(monkeypatch, jax_align_results, backend, mode, task):
    """Port of test_banded_pallas.py::test_align_data_parallel_byte_identical:
    the pairs split over 3 and 8 shards (odd and even, both pad) equal
    SDTPU_ALIGN_DP=off and the JAX package, on the scans and on the K4-K6
    routes (their twins on the CPU)."""
    from stringdecomposer_tpu_torch.ops import align, banded

    qs, ts = _align_pairs()
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", backend)
    monkeypatch.setattr(align, "ALIGN_DATA_PARALLEL", "off")
    single = align.align_batch(qs, ts, mode=mode, task=task, k=40, device="cpu")
    monkeypatch.setattr(align, "ALIGN_DATA_PARALLEL", "auto")
    calls = []
    real = align._rows_sharded
    monkeypatch.setattr(align, "_rows_sharded",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for n_dev in (3, 8):
        monkeypatch.setattr(align, "ROW_DEVICES", ["cpu"] * n_dev)
        assert align.align_batch(qs, ts, mode=mode, task=task, k=40, device="cpu") == single
    assert calls  # the routers went through the row split
    assert single == jax_align_results[mode, task]


def test_rows_sharded_splits_and_falls_through(monkeypatch):
    """The split itself: shards of ceil(P / n) rows, zero-padded, in order;
    one call on the caller's device with one device, fewer rows than
    devices, or SDTPU_ALIGN_DP=off."""
    from stringdecomposer_tpu_torch.ops import align

    seen = []

    def fn(a, b):
        seen.append(a.shape[0])
        return a * 2, b[:, 0] + a[:, 0]

    a = np.arange(14).reshape(7, 2)
    b = np.arange(21).reshape(7, 3)
    monkeypatch.setattr(align, "ROW_DEVICES", ["cpu"] * 3)
    x, y = align._rows_sharded(fn, (a, b), device="cpu")
    assert seen == [3, 3, 3]
    np.testing.assert_array_equal(x, a * 2)
    np.testing.assert_array_equal(y, b[:, 0] + a[:, 0])
    for devices, rows, mode in ((["cpu"], 7, "auto"), (["cpu"] * 8, 7, "auto"),
                                (["cpu"] * 3, 7, "off")):
        seen.clear()
        monkeypatch.setattr(align, "ROW_DEVICES", devices)
        monkeypatch.setattr(align, "ALIGN_DATA_PARALLEL", mode)
        align._rows_sharded(fn, (a[:rows], b[:rows]), device="cpu")
        assert seen == [rows]
