"""K2's kernel schedule, as its plain mirror ops/identity.nw_lanes runs it: a
warp per pair, C query rows a lane, the systolic sweep with the bottom rows
shifted down a step late, lane 0's boundary row, the strip carry and the
capture select. Held equal (tolerance 0) to the port's twin
nw_identity_batch for every C = 1..C_MAX, at the lane and strip seams, at
lengths 0 and 1, on homopolymer ties and on random pairs; plus the cross
twin and the packed finishing entry (which scores through it) against the
JAX package, and the rules the wrapper shares with the kernel."""

import pathlib
import re

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops.identity import nw_identity_batch as jax_nw
from stringdecomposer_tpu_torch.ops import identity as plain
from stringdecomposer_tpu_torch.ops import identity_cuda

torch.set_num_threads(1)

CU = pathlib.Path(identity_cuda.__file__).resolve().parent.parent / "csrc" / "nw_identity.cu"


def _pairs(rng, q_lens, t_lens, alpha=4):
    """Random codes over `alpha` letters, padded with 7 past each length."""
    P = len(q_lens)
    Lq, Lt = max(1, max(q_lens)), max(1, max(t_lens))
    q = np.full((P, Lq), 7, dtype=np.int8)
    t = np.full((P, Lt), 7, dtype=np.int8)
    for p in range(P):
        q[p, : q_lens[p]] = rng.integers(0, alpha, q_lens[p])
        t[p, : t_lens[p]] = rng.integers(0, alpha, t_lens[p])
    return q, np.array(q_lens, dtype=np.int32), t, np.array(t_lens, dtype=np.int32)


def _strs(strs):
    codes = [np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int8) for s in strs]
    L = max(1, max(len(c) for c in codes))
    arr = np.full((len(codes), L), 7, dtype=np.int8)
    for i, c in enumerate(codes):
        arr[i, : len(c)] = c
    return arr, np.array([len(c) for c in codes], dtype=np.int32)


def _lanes_equal(arrays, C):
    a = [torch.from_numpy(x) for x in arrays]
    want = plain.nw_identity_batch(*a)
    got = plain.nw_lanes(*a, C)
    for name, g, w in zip(("dist", "matches", "columns"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"C={C} {name}")
    return want


@pytest.mark.parametrize("C", range(1, identity_cuda.C_MAX + 1))
def test_lanes_seams(C):
    """qlen at 32C - 1, 32C and 32C + 1 (the last lane's last row, a full
    strip, one row into a second strip), qlen and tlen of 0 and 1, and a
    random pair of each length class."""
    rng = np.random.default_rng(C)
    R = 32 * C
    ql = [R - 1, R, R + 1, 0, 1, 0, 1, 1, C, C + 1, int(rng.integers(1, R))]
    tl = [19, 1, 23, 5, 0, 0, 1, 17, 2, 29, int(rng.integers(1, 40))]
    _lanes_equal(_pairs(rng, ql, tl), C)


@pytest.mark.parametrize("C", [1, 2, 3])
def test_lanes_strips(C):
    """Two and three strips, their seams at 32C and 64C rows, with target
    lengths on both sides of the warp's 32-step ramp."""
    rng = np.random.default_rng(10 + C)
    R = 32 * C
    ql = [2 * R, 2 * R + 1, 3 * R - 1, 3 * R, 3 * R + 2, 2 * R + C]
    tl = [40, 3, 31, 32, 33, 1]
    _lanes_equal(_pairs(rng, ql, tl), C)


@pytest.mark.parametrize("C", [1, 2, 16])
def test_lanes_homopolymer_ties(C):
    """Runs where up, left and diag tie (test_identity_pallas.py's cases)."""
    qs = ["G" * 17, "ACGT" * 8, "A" * 40, "AC" * 20, "G" * 16, "ACGT" * 8 + "A"]
    ts = ["G" * 16, "ACGT" * 8, "A" * 3, "CA" * 21, "G" * 17, "ACGT" * 7]
    _lanes_equal((*_strs(qs), *_strs(ts)), C)


@pytest.mark.parametrize("seed", range(3))
def test_lanes_random_at_the_kernels_C(seed):
    """Random pairs from a numpy seed, at the C the kernel picks for their
    padded width (identity_cuda.cells_per_lane)."""
    rng = np.random.default_rng(100 + seed)
    P = 12
    ql = rng.integers(0, 90, P).tolist()
    tl = rng.integers(0, 60, P).tolist()
    arrays = _pairs(rng, ql, tl, alpha=5)
    _lanes_equal(arrays, identity_cuda.cells_per_lane(arrays[0].shape[1]))


def test_lanes_against_jax():
    """The mirror against the JAX package's nw_identity_batch directly."""
    rng = np.random.default_rng(7)
    arrays = _pairs(rng, [70, 33, 0, 64, 5], [50, 0, 9, 64, 80])
    got = plain.nw_lanes(*(torch.from_numpy(a) for a in arrays), 2)
    want = jax_nw(*arrays)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cross_matches_jax_on_expanded_pairs():
    """nw_identity_cross against the JAX nw_identity_batch on the (block x
    monomer) pairs expanded block-major, monomer fastest; a block of length
    0 included. The wrapper on CPU tensors runs it and counts no launch."""
    rng = np.random.default_rng(8)
    q, ql, _, _ = _pairs(rng, [31, 0, 45, 7, 33], [1] * 5)
    _, _, t, tl = _pairs(rng, [1] * 4, [20, 35, 1, 28])
    Nb, M = len(ql), len(tl)
    want = jax_nw(np.repeat(q, M, axis=0), np.repeat(ql, M), np.tile(t, (Nb, 1)), np.tile(tl, Nb))
    want = np.stack([np.asarray(want[0]), np.asarray(want[2])], axis=1).reshape(Nb, M, 2)
    args = [torch.from_numpy(a) for a in (q, ql, t, tl)]
    got = plain.nw_identity_cross(*args)
    assert got.dtype == torch.int32 and got.shape == (Nb, M, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    before = identity_cuda.nw_identity_cross_cuda.launches
    np.testing.assert_array_equal(identity_cuda.nw_identity_cross_cuda(*args).numpy(), want)
    assert identity_cuda.nw_identity_cross_cuda.launches == before


@pytest.mark.parametrize("case", ["block_over_256", "zero_length_pad_row"])
def test_packed_both_cross_matches_jax_pallas(case):
    """nw_identity_packed_both_plain, which scores through the cross twin,
    against the JAX Pallas nw_identity_packed_both run by the Pallas
    interpreter on the CPU: a block longer than 256 bp (two of the kernel's
    C = 8 lanes' worth of rows past 256), and pad rows of length 0 beside a
    block of length 1."""
    import jax.numpy as jnp

    from stringdecomposer_tpu.finishing import _pad_codes, homo_compress
    from stringdecomposer_tpu.io.fasta import encode
    from stringdecomposer_tpu.ops.identity_pallas import nw_identity_packed_both

    rng = np.random.default_rng(31 if case == "block_over_256" else 32)
    alpha = list("ACGT")
    read = "".join(rng.choice(alpha, 700)).replace("CA", "CCA")[:700]
    if case == "block_over_256":
        blocks, n_pad = [(3, 290), (400, 20), (100, 9)], 4
    else:
        blocks, n_pad = [(10, 12), (50, 1), (200, 30)], 8
    starts = np.array([s for s, _ in blocks], dtype=np.int64)
    lens = np.array([n for _, n in blocks], dtype=np.int32)
    monos = ["".join(rng.choice(alpha, int(n))) for n in (12, 21)]
    t_raw, tl_raw = _pad_codes([encode(m) for m in monos])
    t_homo, tl_homo = _pad_codes([encode(homo_compress(m)) for m in monos])
    Lq = int(lens.max())
    want = np.asarray(nw_identity_packed_both(
        jnp.asarray(encode(read)), starts, lens, jnp.asarray(t_raw), tl_raw,
        jnp.asarray(t_homo), tl_homo, n_pad=n_pad, Lq=Lq))
    got = plain.nw_identity_packed_both_plain(
        torch.from_numpy(encode(read)), starts, lens, torch.from_numpy(t_raw),
        torch.from_numpy(tl_raw), torch.from_numpy(t_homo), torch.from_numpy(tl_homo),
        n_pad=n_pad, Lq=Lq)
    assert got.shape == (2, n_pad * len(monos), 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_kernel_constants_and_rules():
    """The wrapper's copies of the kernel's constants, the C it picks (7 for
    the golden raw blocks' 215 bp, 12 for the DXZ1 dimers' ~360 bp, the
    strip route past 512 rows), and the strip carry's device-memory rows,
    allocated exactly where a query can exceed one strip."""
    src = CU.read_text()
    assert int(re.search(r"constexpr int kMaxC = (\d+);", src).group(1)) == identity_cuda.C_MAX
    cpl = identity_cuda.cells_per_lane
    assert [cpl(n) for n in (0, 1, 32, 33, 150, 215, 360, 512, 513, 4500)] == \
        [1, 1, 1, 2, 5, 7, 12, 16, 16, 16]
    assert identity_cuda.carry_scratch(4, 512, 5000, "cpu") is None  # one strip
    for P, Lq, Lt in ((4, 513, 20), (3, 4500, 4200)):
        carry = identity_cuda.carry_scratch(P, Lq, Lt, "cpu")
        assert carry.shape == (P, 2, Lt + 1, 2) and carry.dtype == torch.int32
