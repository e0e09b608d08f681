"""The port's DP stream with batches in flight (pipeline.decompose_stream)
against the JAX package's on the CPU, on the same seeded inputs: the raw
blocks at device_batch 2-7, with and without --ed_thr; the order in which
both dispatch K1 and yield chunks (up to four batches in flight, drained
oldest first); the 24 / 48 / B ramp of the first batches; and the
block-cap overflow redo, which recomputes a batch from its own inputs."""

import logging

import numpy as np
import pytest
import torch

from stringdecomposer_tpu import pipeline as jp
from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement
from stringdecomposer_tpu.ops.chain_dp import chain_dp_forward as jax_forward
from stringdecomposer_tpu.ops.oracle import Scoring
from stringdecomposer_tpu.report import format_raw_rows
from stringdecomposer_tpu_torch import pipeline as tp
from stringdecomposer_tpu_torch.ops import chain_dp as k1_plain

torch.set_num_threads(1)

UNIT = "ACGGTCTGAACTTGGCA"


def _mutate(rng, seq: str, rate: float) -> str:
    arr = np.array(list(seq))
    idx = rng.integers(0, len(arr), max(1, int(len(arr) * rate)))
    arr[idx] = rng.choice(list("ACGT"), len(idx))
    return "".join(arr)


def _random_case(seed: int, max_len: int = 400):
    """Reads of mutated copies of two monomers (some shorter than a window,
    some of many windows) and the monomers with RC."""
    rng = np.random.default_rng(seed)
    monos = [UNIT, _mutate(rng, UNIT[::-1] + "TG", 0.2)]
    reads = []
    for i in range(int(rng.integers(3, 7))):
        n = int(rng.integers(10, max_len))
        seq = "".join(monos[int(rng.integers(2))] for _ in range(n // 17 + 1))[:n]
        reads.append(Record(f"r{i}", _mutate(rng, seq, 0.05)))
    return reads, add_reverse_complement([Record(f"m{j}", m) for j, m in enumerate(monos)])


def _raw(result, monomers) -> str:
    names = [m.name for m in monomers]
    return "".join(r + "\n" for rn, b in result for r in format_raw_rows(rn, b, names))


def _cfgs(device_batch: int, ed_thr: int, part: int = 64, overlap: int = 8):
    kw = dict(scoring=Scoring(-1, -1, -1, 1), part_size=part, overlap=overlap,
              device_batch=device_batch, ed_thr=ed_thr)
    return jp.PipelineConfig(**kw), tp.PipelineConfig(**kw)


@pytest.mark.parametrize("ed_thr", [-1, 4])
@pytest.mark.parametrize("device_batch", range(2, 8))
def test_decompose_reads_matches_jax(device_batch, ed_thr):
    reads, monos = _random_case(100 * device_batch + ed_thr)
    jcfg, tcfg = _cfgs(device_batch, ed_thr)
    want = _raw(jp.decompose_reads(reads, monos, jcfg), monos)
    got = _raw(tp.decompose_reads(reads, monos, tcfg, device="cpu"), monos)
    assert got == want and want


def _trace(module, stream_fn, forward, reads, monos, cfg):
    """The stream's events in order: 'F' for each K1 call, (read, final,
    blocks) for each chunk yielded, and the windows of each batch built
    (the JAX package's pad rows, repeats of its last window, dropped)."""
    events, batches = [], []
    build = module.build_window_batch

    def spy_build(wins, W):
        real = [w for i, w in enumerate(wins) if i == 0 or w is not wins[i - 1]]
        batches.append((W, [bytes(w) for w in real]))
        return build(wins, W)

    def spy_forward(*a, **k):
        events.append("F")
        return forward(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(module, "build_window_batch", spy_build)
    try:
        for ridx, blocks, final in stream_fn(reads, monos, cfg, spy_forward):
            events.append((ridx, final, len(blocks)))
    finally:
        mp.undo()
    return events, batches


def _both_traces(reads, monos, device_batch, ed_thr=-1, part=64, overlap=8):
    jcfg, tcfg = _cfgs(device_batch, ed_thr, part, overlap)
    want = _trace(jp, lambda r, m, c, f: jp.decompose_stream(r, m, c, forward_fn=f),
                  jax_forward, reads, monos, jcfg)
    got = _trace(tp, lambda r, m, c, f: tp.decompose_stream(r, m, c, "cpu", forward_fn=f),
                 k1_plain.chain_dp_forward, reads, monos, tcfg)
    return got, want


@pytest.mark.parametrize("ed_thr", [-1, 4])
@pytest.mark.parametrize("device_batch", [2, 5])
def test_dispatch_and_drain_order_match_jax(device_batch, ed_thr, caplog):
    """K1 calls and yields interleave as in the JAX package: no chunk comes
    out before four batches are in flight, then one batch is replayed per
    batch dispatched, oldest first."""
    reads, monos = _random_case(7 + device_batch, max_len=1500)
    caplog.set_level(logging.INFO, logger="SD-TPU")
    (events, batches), (want_events, want_batches) = _both_traces(reads, monos, device_batch,
                                                                  ed_thr)
    assert batches == want_batches
    assert events == want_events
    assert len(batches) >= 6 and events[:4] == ["F"] * 4
    assert f"{len(batches)} batches, at most 4 in flight" in caplog.text


def test_ramp_matches_jax():
    """At device_batch 64 the first two batches take 24 and 48 windows, then
    64 each, within the width buckets of each slab; the batches' windows
    and their order equal the JAX package's."""
    rng = np.random.default_rng(5)
    long_read = _mutate(rng, UNIT * 1000, 0.03)  # 17,000 bp: 266 windows
    reads = [Record("long", long_read), Record("short", long_read[:30]),
             Record("mid", long_read[:1500])]
    monos = add_reverse_complement([Record("m", UNIT)])
    (events, batches), (want_events, want_batches) = _both_traces(reads, monos, 64)
    assert batches == want_batches and events == want_events
    assert [len(w) for _, w in batches[:3]] == [24, 48, 64]


def test_overflow_redo_matches_jax():
    """A 3,000 bp window against TTTT holds ~750 blocks, past the cap of 376
    records: each such batch is recomputed uncapped from its own inputs
    while later batches are in flight, and the blocks equal the JAX
    package's (the T run as tests/test_properties.py asserts for it alone)."""
    rng = np.random.default_rng(11)
    reads = [Record("a", _mutate(rng, "ACGT" * 750, 0.1)), Record("t", "T" * 3000),
             Record("b", _mutate(rng, "TTGA" * 1500, 0.1)), Record("c", "T" * 2000 + "ACGA" * 50)]
    monos = add_reverse_complement([Record("m", "TTTT")])
    (events, batches), (want_events, want_batches) = _both_traces(reads, monos, 1, part=3000,
                                                                  overlap=8)
    assert batches == want_batches and events == want_events
    # every window of ~750 TTTT blocks overflows: the first batch's redo runs
    # with three later batches in flight, before its first chunk comes out
    assert events[:6] == ["F"] * 5 + [(0, True, 525)]
    assert events.count("F") > len(batches) == 5
    jcfg, tcfg = _cfgs(1, -1, 3000, 8)
    got = tp.decompose_reads(reads, monos, tcfg, device="cpu")
    assert _raw(got, monos) == _raw(jp.decompose_reads(reads, monos, jcfg), monos)
    blocks = got[1][1]
    assert len(blocks) == 750 and blocks[0].start == 0 and blocks[-1].end == 2999


def test_one_batch_is_one_in_flight(caplog):
    caplog.set_level(logging.INFO, logger="SD-TPU")
    reads, monos = [Record("r", UNIT * 3)], add_reverse_complement([Record("m", UNIT)])
    tp.decompose_reads(reads, monos, _cfgs(4, -1)[1], device="cpu")
    assert "1 batches, at most 1 in flight" in caplog.text
