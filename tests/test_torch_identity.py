"""NW identity of the PyTorch port (plain twin, the K2 wrapper's CPU
dispatch, and the packed finishing prologue) against the JAX package on the
same NumPy inputs: the lax.scan nw_identity_batch, and the Pallas
nw_identity_packed_both run by the Pallas interpreter on the CPU."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops.identity import nw_identity_batch as jax_nw
from stringdecomposer_tpu_torch.ops import identity as plain
from stringdecomposer_tpu_torch.ops.chain_dp import pair_scan
from stringdecomposer_tpu_torch.ops.identity_cuda import nw_identity_batch_cuda

torch.set_num_threads(1)


def _pad_batch(strs):
    codes = [np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int8) for s in strs]
    L = max(1, max(len(c) for c in codes))
    arr = np.full((len(codes), L), 7, dtype=np.int8)
    lens = np.zeros(len(codes), dtype=np.int32)
    for i, c in enumerate(codes):
        arr[i, : len(c)] = c
        lens[i] = len(c)
    return arr, lens


def _check(qs, ts):
    q, ql = _pad_batch(qs)
    t, tl = _pad_batch(ts)
    want = [np.asarray(x) for x in jax_nw(q, ql, t, tl)]
    got = nw_identity_batch_cuda(*(torch.from_numpy(a) for a in (q, ql, t, tl)))
    for g, w in zip(got, want):  # dist, matches, columns
        np.testing.assert_array_equal(g.numpy(), w)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("part", range(4))
def test_plain_matches_jax_on_edlib_subsample(edlib_cases, part):
    """A sixteenth of the edlib fixture pairs per part (a quarter in all),
    also held against edlib's own distance and CIGAR columns."""
    import re

    cases = edlib_cases[part::32] + edlib_cases[part + 16 :: 32]
    D, mt, cols = _check([c["q"] for c in cases], [c["t"] for c in cases])
    for i, c in enumerate(cases):
        ops = re.findall(r"(\d+)([=XIDM])", c["cigar"])
        assert (D[i], mt[i], cols[i]) == (
            int(c["ed"]), sum(int(n) for n, op in ops if op == "="), sum(int(n) for n, _ in ops))


def test_edge_lengths():
    """tlen 0, qlen 0 (pad rows), and qlen != tlen skews
    (test_identity_pallas.py:37-107)."""
    rng = np.random.default_rng(3)

    def rs(n):
        return "".join(rng.choice(list("ACGT"), n))

    _check(["A", "", "ACGT" * 8, "G" * 17, "ACGT", rs(1), rs(60), rs(31)],
           ["", "ACG", "ACGT" * 8, "G" * 16, "T", rs(60), rs(1), rs(33)])


def test_nw_path_spec_copy_agrees():
    rng = np.random.default_rng(4)
    qs = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(0, 20, 6)]
    ts = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(0, 20, 6)]
    D, mt, cols = _check(qs, ts)
    for i, (q, t) in enumerate(zip(qs, ts)):
        assert plain.nw_path_spec(q, t) == (D[i], mt[i], cols[i])
    assert plain.aai_from_counts(3, 4) == 75.0 and plain.aai_from_counts(0, 0) == 0.0


def test_packed_both_matches_jax_pallas():
    """The case of test_identity_pallas.py:110: scrambled blocks, a long
    outlier, repeated starts and zero-length pad rows, both variants."""
    import jax.numpy as jnp

    from stringdecomposer_tpu.finishing import _pad_codes, homo_compress
    from stringdecomposer_tpu.io.fasta import encode
    from stringdecomposer_tpu.ops.identity_pallas import nw_identity_packed_both

    rng = np.random.default_rng(23)
    alpha = list("ACGT")
    unit = "".join(rng.choice(alpha, 17))
    read = (unit * 40)[:600]
    blocks = [(5, 20), (100, 17), (0, 230), (40, 8), (300, 60), (100, 17), (550, 50), (7, 1)]
    starts = np.array([s for s, _ in blocks], dtype=np.int64)
    lens = np.array([n for _, n in blocks], dtype=np.int32)
    monos = ["".join(rng.choice(alpha, int(n))) for n in (17, 23, 11)]
    t_raw, tl_raw = _pad_codes([encode(m) for m in monos])
    t_homo, tl_homo = _pad_codes([encode(homo_compress(m)) for m in monos])
    want = np.asarray(nw_identity_packed_both(
        jnp.asarray(encode(read)), starts, lens, jnp.asarray(t_raw), tl_raw,
        jnp.asarray(t_homo), tl_homo, n_pad=16, Lq=256))
    got = plain.nw_identity_packed_both_plain(
        torch.from_numpy(encode(read)), starts, lens, torch.from_numpy(t_raw),
        torch.from_numpy(tl_raw), torch.from_numpy(t_homo), torch.from_numpy(tl_homo),
        n_pad=16, Lq=256)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("pair_cells", [1, 300, 2000])
def test_packed_both_split_into_pieces(monkeypatch, pair_cells):
    """Splitting the length-sorted blocks into several scorer calls (one
    block each at 1; the 230 bp outlier alone at 300) changes no result."""
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 4, 700).astype(np.int8))
    starts = rng.integers(0, 400, 9).astype(np.int64)
    lens = np.array([20, 17, 230, 8, 60, 17, 50, 1, 0], dtype=np.int32)
    t = torch.from_numpy(rng.integers(0, 4, (3, 25)).astype(np.int8))
    tl = torch.tensor([11, 25, 7], dtype=torch.int32)
    targs = [t, tl, t[:, 1:], tl - 1]
    want = plain.nw_identity_packed_both_plain(codes, starts, lens, *targs, n_pad=12, Lq=256)
    assert len(plain._pieces(np.sort(lens), 3)) == 1
    monkeypatch.setattr(plain, "PAIR_CELLS", pair_cells)
    assert len(plain._pieces(np.sort(np.pad(lens, (0, 3))), 3)) > 1
    got = plain.nw_identity_packed_both_plain(codes, starts, lens, *targs, n_pad=12, Lq=256)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int64])
def test_pair_scan_running_form_equals_the_log_step_form(dtype):
    """pair_scan's running-max form (torch.gt / torch.lt, no steps) gives
    the values and payloads of its log-step form (steps past log2 n) on
    random ties-heavy inputs of 1-3 leading axes and 1-69 elements."""
    g = torch.Generator().manual_seed(3)
    for _ in range(60):
        lead = torch.randint(1, 5, (int(torch.randint(1, 4, (1,), generator=g)),), generator=g)
        shape = [*lead.tolist(), int(torch.randint(1, 70, (1,), generator=g))]
        t = torch.randint(-4, 4, shape, generator=g).to(dtype)
        pays = [torch.randint(-99, 99, shape, generator=g).to(dtype),
                torch.arange(shape[-1]).expand(shape).contiguous()]
        for later_wins in (torch.gt, torch.lt):
            got = pair_scan(t, pays, later_wins)
            want = pair_scan(t, pays, later_wins, steps=64)
            for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_earliest_tie_scan_and_first_max_argmax():
    """The tie rules the twins rest on: the pair scans keep the EARLIEST
    payload on ties (torch.cummax keeps the last), and argmax returns the
    first maximum."""
    t = torch.tensor([1, 3, 3, 2, 3])
    assert torch.cummax(t, 0).indices.tolist() == [0, 1, 2, 2, 4]  # why pair_scan exists
    vals, (idx,) = pair_scan(t, [torch.arange(5)], torch.gt)
    assert vals.tolist() == [1, 3, 3, 3, 3] and idx.tolist() == [0, 1, 1, 1, 1]
    vals, (idx,) = pair_scan(torch.tensor([4, 2, 2, 5, 2]), [torch.arange(5)], torch.lt)
    assert vals.tolist() == [4, 2, 2, 2, 2] and idx.tolist() == [0, 1, 1, 1, 1]
    assert int(torch.tensor([0, 7, 7, 1, 7]).argmax()) == 1
    assert torch.tensor([[5, 9, 9], [2, 2, 1]]).argmax(dim=1).tolist() == [1, 0]
    x = torch.tensor([[1, 0, 1, 1, 0]], dtype=torch.int8)
    assert torch.argsort(x, dim=1, stable=True).tolist() == [[1, 4, 0, 2, 3]]


def test_cpu_dispatch_launches_nothing():
    before = nw_identity_batch_cuda.launches
    q, ql = _pad_batch(["ACGT", "GG"])
    nw_identity_batch_cuda(*(torch.from_numpy(a) for a in (q, ql, q, ql)))
    assert nw_identity_batch_cuda.launches == before
