"""The --ed_thr pre-filter of the PyTorch port (the plain HW-distance twin,
the K3 wrapper's CPU dispatch, the batched filter, and the pipeline route)
against the JAX package on the same NumPy inputs: the lax.scan
hw_distance_batch, the Pallas hw_distance_batch_pallas run by the Pallas
interpreter on the CPU, filter_monomers_device, and the reference binary's
ed_thr fixtures. Every output is an integer array or a TSV string and must
be equal (tolerance 0)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement, encode, pad_monomers
from stringdecomposer_tpu.ops import hw_filter as jax_hw
from stringdecomposer_tpu.ops.oracle import Scoring, make_windows
from stringdecomposer_tpu.report import format_raw_rows
from stringdecomposer_tpu_torch import pipeline
from stringdecomposer_tpu_torch.ops import chain_dp as k1_plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda, identity_cuda
from stringdecomposer_tpu_torch.ops import hw_filter as plain
from stringdecomposer_tpu_torch.ops.hw_filter_cuda import hw_distance_batch_cuda

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ED_THR_CASES = [c for n in ("ed_thr_cases.json", "ed_thr_cases_b.json")
                for c in json.loads((FIXTURES / n).read_text())]


def _random_problem(seed, B, W, M, L, alphabet=5):
    """Random codes (N = 4 included when alphabet is 5) with ragged lengths:
    window 0 at full width, window 1 of length 1, monomer 0 at full width,
    the last monomer of length 1."""
    rng = np.random.default_rng(seed)
    win = np.full((B, W), k1_plain.READ_PAD, dtype=np.int8)
    wl = rng.integers(1, W + 1, B).astype(np.int32)
    wl[0] = W
    if B > 1:
        wl[1] = 1
    for b in range(B):
        win[b, : wl[b]] = rng.integers(0, alphabet, wl[b])
    mono = np.full((M, L), 5, dtype=np.int8)
    ml = rng.integers(1, L + 1, M).astype(np.int32)
    ml[0], ml[-1] = L, 1
    for m in range(M):
        mono[m, : ml[m]] = rng.integers(0, alphabet, ml[m])
    return win, wl, mono, ml


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,B,W,M,L", [
    (0, 3, 70, 5, 24),   # test_ed_thr.py's shape
    (1, 4, 1, 6, 9),     # every window of length 1
    (2, 2, 45, 7, 1),    # every monomer of length 1; W not a multiple of 16
    (3, 5, 101, 9, 40),  # W not a multiple of 16
    (4, 2, 33, 3, 130),  # monomers longer than the window
])
def test_twin_matches_jax_scan_and_pallas(seed, B, W, M, L):
    win, wl, mono, ml = _random_problem(seed, B, W, M, L)
    got = plain.hw_distance_batch(*_torch(win, wl, mono, ml)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hw.hw_distance_batch(win, wl, mono, ml)))
    pallas = jax_hw.hw_distance_batch_pallas(win, wl, mono, ml, pair_tile=8, t_tile=16)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    # the K3 wrapper runs the twin on CPU tensors
    np.testing.assert_array_equal(hw_distance_batch_cuda(*_torch(win, wl, mono, ml)).numpy(), got)


def _hw_brute(q: str, t: str) -> int:
    m, n = len(q), len(t)
    D = np.zeros((m + 1, n + 1), dtype=np.int64)
    D[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                          D[i - 1, j - 1] + (q[i - 1] != t[j - 1]))
    return int(D[m].min())


def test_twin_matches_brute_force_on_edlib_cases(edlib_cases):
    cases = edlib_cases[:40]
    mono, ml = pad_monomers([Record(f"q{i}", c["q"]) for i, c in enumerate(cases)])
    win, wl = k1_plain.build_window_batch([encode(c["t"]) for c in cases],
                                          max(len(c["t"]) for c in cases))
    dist = plain.hw_distance_batch(*_torch(win, wl, mono, ml)).numpy()
    for i, c in enumerate(cases):
        assert dist[i, i] == _hw_brute(c["q"], c["t"]), i


@pytest.mark.parametrize("ed_thr", [0, 3, 1000])
def test_filter_matches_jax_and_host_filter(ed_thr):
    """Tied distances: the (distance, index) order decides."""
    rng = np.random.default_rng(ed_thr)
    B, M, L = 6, 11, 8
    dist = rng.integers(0, 6, size=(B, M)).astype(np.int32)
    dist[0] = 5  # all tied, none within ed_thr 0 or 3
    mono = rng.integers(0, 5, size=(M, L)).astype(np.int8)
    lens = rng.integers(1, L + 1, size=M).astype(np.int32)
    mono_w, lens_w, perm = (x.numpy() for x in plain.filter_monomers_device(
        *_torch(dist, mono, lens), ed_thr))
    j_mono, j_lens, j_perm = (np.asarray(x) for x in jax_hw.filter_monomers_device(
        dist, mono, lens, ed_thr))
    np.testing.assert_array_equal(perm, j_perm)
    np.testing.assert_array_equal(lens_w, j_lens)
    np.testing.assert_array_equal(mono_w, j_mono)
    for b in range(B):
        keep = plain.filter_monomers(dist[b], ed_thr)
        np.testing.assert_array_equal(keep, jax_hw.filter_monomers(dist[b], ed_thr))
        n = len(keep)
        assert n == max(1, int((dist[b] <= ed_thr).sum()))
        np.testing.assert_array_equal(perm[b, :n], keep)
        np.testing.assert_array_equal(lens_w[b, :n], lens[keep])
        assert not lens_w[b, n:].any()


@pytest.mark.parametrize("idx", range(len(ED_THR_CASES)))
def test_decompose_reads_ed_thr_matches_reference_raw(idx):
    case = ED_THR_CASES[idx]
    monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
    cfg = pipeline.PipelineConfig(scoring=Scoring(*case["scoring"]), part_size=case["part_size"],
                                  overlap=case["overlap"], device_batch=3, ed_thr=case["ed_thr"])
    result = pipeline.decompose_reads([Record("read0", case["read"])], monomers, cfg, device="cpu")
    names = [m.name for m in monomers]
    got = "".join(r + "\n" for rn, b in result for r in format_raw_rows(rn, b, names))
    assert got == case["raw"]


def test_m_eff_slice_gives_the_same_blocks():
    """K1 on the first max(kept) rows of the per-window set gives the blocks
    of the full set: the rows past a window's kept count have length 0."""
    rng = np.random.default_rng(5)
    alpha = np.array(list("ACGT"))
    fwd = [Record(f"m{j}", "".join(rng.choice(alpha, int(rng.integers(14, 22)))))
           for j in range(8)]
    mono, lens = pad_monomers(add_reverse_complement(fwd), pad_to=24)
    wins = []
    for b in range(3):
        unit = fwd[b].seq
        arr = np.array(list((unit * 10)[:150]))
        hit = rng.integers(0, len(arr), 12)
        arr[hit] = rng.choice(alpha, len(hit))
        wins.append(encode("".join(arr)))
    wb, wl = k1_plain.build_window_batch(wins, 150)
    wb_t, wl_t, mono_t, lens_t = _torch(wb, wl, mono, lens)
    dist = plain.hw_distance_batch(wb_t, wl_t, mono_t, lens_t)
    mono_w, lens_w, _ = plain.filter_monomers_device(dist, mono_t, lens_t, 3)
    m_eff = int((dist <= 3).sum(dim=1).clamp(min=1).max())
    assert 1 <= m_eff < len(lens)
    full = k1_plain.chain_dp_forward(wb_t, wl_t, mono_w, lens_w, return_debug=True)
    cut = k1_plain.chain_dp_forward(wb_t, wl_t, mono_w[:, :m_eff].contiguous(),
                                    lens_w[:, :m_eff].contiguous(), return_debug=True)
    np.testing.assert_array_equal(cut[0].numpy(), full[0].numpy())
    np.testing.assert_array_equal(cut[1].numpy(), full[1].numpy())
    assert int(full[1].min()) > 0


def test_cpu_dispatch_launches_nothing():
    counters = (hw_distance_batch_cuda, chain_dp_cuda.chain_dp_forward_cuda,
                chain_dp_cuda.chain_dp_large_cuda, chain_dp_cuda.block_walk_cuda,
                identity_cuda.nw_identity_batch_cuda)
    before = [c.launches for c in counters]
    hw_distance_batch_cuda(*_torch(*_random_problem(9, 2, 20, 3, 8)))
    case = ED_THR_CASES[0]
    monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
    cfg = pipeline.PipelineConfig(part_size=case["part_size"], overlap=case["overlap"],
                                  ed_thr=case["ed_thr"])
    pipeline.decompose_reads([Record("r", case["read"])], monomers, cfg, device="cpu")
    assert [c.launches for c in counters] == before


def test_filter_on_windows_of_a_read():
    """The pipeline's filter input: the windows of one read against the
    state's PAD_CODE-padded monomers, twin against the JAX scan."""
    case = ED_THR_CASES[13]
    monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
    mono, lens = pad_monomers(monomers, pad_to=(max(len(m.seq) for m in monomers) + 7) // 8 * 8)
    codes = encode(case["read"])
    wins = [codes[o : o + n] for o, n in make_windows(len(codes), case["part_size"], case["overlap"])]
    wb, wl = k1_plain.build_window_batch(wins, case["part_size"] + case["overlap"])
    got = plain.hw_distance_batch(*_torch(wb, wl, mono, lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hw.hw_distance_batch(wb, wl, mono, lens)))
