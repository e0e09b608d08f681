"""K1's cluster body, as its plain mirror ops/chain_dp.sweep_cluster splits a
position: a window's rows over cs slices (the blocks of a thread block
cluster), each slice stepping its rows as the lanes body does and keeping
its own copy of the parity buffers of every row's end score. Held equal
(tolerance 0) to the port's twin `sweep` and to the JAX package's
chain_dp_forward for cs in {2, 3, 9, 16}, in int32 and int16 state; plus the
launch plan (`cluster_plan`), the body rule's cluster cases and the large
route's CPU dispatch."""

import pathlib
import re

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.io.fasta import add_reverse_complement, encode, load_fasta, pad_monomers
from stringdecomposer_tpu.ops import chain_dp as jax_chain_dp
from stringdecomposer_tpu_torch.ops import chain_dp as plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda

torch.set_num_threads(1)

CSRC = pathlib.Path(chain_dp_cuda.__file__).resolve().parent.parent / "csrc"
CLUSTER_SIZES = (2, 3, 9, 16)
DTYPES = pytest.mark.parametrize("dt", [torch.int32, torch.int16], ids=["int32", "int16"])
SCORINGS = ((-1, -1, -1, 1), (-2, -1, -1, 2), (-1, -2, -1, 1), (-3, -1, -2, 1))


def _problem(rng, B, W, M, L, alpha, zero_rows=0, per_window=True):
    """Random codes over `alpha` letters: windows [B, W] (ragged, READ_PAD
    past each length), monomers [B, M, L] (or [M, L]) with lengths drawn in
    [1, L] (the first at L), the last `zero_rows` rows of length 0."""
    win = np.full((B, W), plain.READ_PAD, dtype=np.int8)
    wl = rng.integers(1, W + 1, B).astype(np.int32)
    wl[0] = W
    for b in range(B):
        win[b, : wl[b]] = rng.integers(0, alpha, wl[b])
    shape = (B, M) if per_window else (M,)
    lens = rng.integers(1, L + 1, shape).astype(np.int32)
    lens[..., 0] = L
    if zero_rows:
        lens[..., -zero_rows:] = 0
    mono = np.full(shape + (L,), 5, dtype=np.int8)
    for idx in np.ndindex(*shape):
        mono[idx][: lens[idx]] = rng.integers(0, alpha, lens[idx])
    return [torch.from_numpy(a) for a in (win, wl, mono, lens)]


def _sweeps(windows, mono, lens, sc, cs, dt):
    """(sweep_cluster's, sweep's) (chain, end, spend) at the C the card takes."""
    mono_b, lens_b = plain.broadcast_monomers(mono, lens, windows.shape[0])
    dp0 = plain.init_column(windows, mono_b, lens_b, sc[1], sc[2], sc[3], dt)
    want = plain.sweep(windows, mono_b, lens_b, dp0, *sc)
    C = -(-mono.shape[-1] // 32)
    got = plain.sweep_cluster(windows, mono_b, lens_b, dp0, *sc, cluster_size=cs,
                              cells_per_lane=C)
    return got, want


def _equal(got, want):
    for name, g, w in zip(("chain", "end", "spend"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@DTYPES
@pytest.mark.parametrize("cs", CLUSTER_SIZES)
def test_sweep_cluster_matches_sweep(cs, dt):
    """M = 3 cs - 1 rows (not a multiple of cs: the last slice holds 2), at
    L = 40, 64 and 192 (C = 2 and 6, full and partial lanes); ragged
    lengths; per-window monomers with the last slice's rows of length 0,
    one of them or both; the shared [M, L] form; a two-letter alphabet (many
    ties); four scorings; W = 1."""
    rng = np.random.default_rng(200 + cs)
    M = 3 * cs - 1
    for j, (L, alpha, zero_rows, W, per_window) in enumerate(
            ((40, 2, 1, 50, True), (64, 4, 2, 30, True), (192, 4, 0, 20, False),
             (40, 2, 0, 1, True))):
        sc = SCORINGS[(j + cs) % len(SCORINGS)]
        args = _problem(rng, 3, W, M, L, alpha, zero_rows, per_window)
        _equal(*_sweeps(args[0], args[2], args[3], sc, cs, dt))


def test_sweep_cluster_refuses_an_empty_slice():
    args = _problem(np.random.default_rng(0), 1, 5, 5, 40, 4, per_window=False)
    for cs in (0, 4, 6):  # 4 slices of 2 rows or 6 of 1 leave one of 5 rows empty
        with pytest.raises(ValueError, match="empty"):
            _sweeps(args[0], args[2], args[3], SCORINGS[0], cs, torch.int32)


def _mono(records):
    monos = add_reverse_complement(records)
    return pad_monomers(monos, pad_to=(max(len(m.seq) for m in monos) + 7) // 8 * 8)


@pytest.fixture(scope="module")
def library_case(test_data_dir):
    """The 264-monomer HOR library (scripts/workloads.hor_library, the set
    that takes the cluster body on the card) against 2 windows of ~300 bp
    drawn from it, with the JAX package's outputs on them."""
    from stringdecomposer_tpu_torch.scripts.workloads import hor_library

    lib = hor_library(load_fasta(test_data_dir / "DXZ1_star_monomers.fa"),
                      np.random.default_rng(0))
    mono, lens = _mono(lib)
    assert mono.shape == (264, 192)
    rng = np.random.default_rng(8)
    wins = []
    for b in range(2):
        unit = "".join(lib[int(rng.integers(len(lib)))].seq for _ in range(2))
        wins.append(encode(unit[: 300 - 23 * b]))
    wb, wl = plain.build_window_batch(wins, 300)
    kw = dict(ins=-1, dele=-1, mismatch=-1, match=1, max_blocks=1, return_debug=True)
    jax_out = jax_chain_dp.chain_dp_forward(wb, wl, mono, lens, **kw)
    jax_out = [np.asarray(x) for x in jax_out[:2]] + [np.asarray(x) for x in jax_out[2]]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (wb, wl, mono, lens)], kw, jax_out


@DTYPES
@pytest.mark.parametrize("cs", CLUSTER_SIZES)
def test_library_m264_matches_sweep_and_jax(library_case, cs, dt):
    """sweep_cluster at M = 264 equals `sweep` and the JAX package's debug
    arrays (chain, end, spend: every row of the library is real, so the int16
    state's values equal int32's); the walk over them gives JAX's blocks and
    counts, max_blocks = 1 overflowing."""
    args, kw, (jb, jc, jchain, jend, jspend) = library_case
    got, want = _sweeps(args[0], args[2], args[3], (-1, -1, -1, 1), cs, dt)
    _equal(got, want)
    for g, j in zip(got, (jchain, jend, jspend)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), j)
    blocks, counts = plain.block_walk(got[1], got[2], args[1], kw["max_blocks"])
    np.testing.assert_array_equal(blocks.numpy(), jb)
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert jc.max() > kw["max_blocks"]


@DTYPES
@pytest.mark.parametrize("cs", (None,) + CLUSTER_SIZES)
def test_large_route_cpu_matches_jax(library_case, cs, dt):
    """chain_dp_large_cuda on CPU tensors, at the plan's cluster size and at
    each given one, runs the plain twin: JAX's blocks, counts and debug
    arrays, max_blocks = 1 overflowing; it launches nothing."""
    args, kw, jax_out = library_case
    fn = chain_dp_cuda.chain_dp_large_cuda
    names = ("launches", "launches_int16", "launches_cluster", "launches_cluster_int16",
             "launches_cluster_long", "launches_cluster_long_int16")
    before = [getattr(fn, n) for n in names]
    got = fn(*args, cluster_size=cs, state_dtype="int16" if dt == torch.int16 else "int32", **kw)
    for g, j in zip(got[:2] + got[2], jax_out):
        np.testing.assert_array_equal(g.numpy(), j)
    assert [getattr(fn, n) for n in names] == before


def test_large_route_refuses_a_cluster_size_that_does_not_fit(library_case):
    """cluster_size is checked against what the plan admits, on any device:
    above 16 blocks, a block without a row, or rows past shared memory."""
    args, kw, _ = library_case
    for cs, M in ((17, 264), (1, 264), (0, 264), (4, 5)):
        with pytest.raises(ValueError, match="not admitted"):
            chain_dp_cuda.chain_dp_large_cuda(args[0], args[1], args[2][:M], args[3][:M],
                                              cluster_size=cs, **kw)


@pytest.mark.parametrize("sb", [4, 2], ids=["int32", "int16"])
def test_cluster_plan_invariants(sb):
    """Every admissible shape and the plan's pick: each block owns at least
    one row, at most 1,024 threads in whole warps (512 past L = 256, where a
    warp holds two rows in registers), shared memory within 232,448 bytes,
    at most 16 blocks; pure; `body` says "cluster" exactly where the shared
    route does not fit and a plan exists, and past 16 blocks "grid" where
    `grid_plan` finds K clusters on the card (M = 2,001-4,000 at L = 192 and
    (5,000, 192)), else "large"."""
    assert chain_dp_cuda.SMEM_LIMIT == 232_448 and chain_dp_cuda.CLUSTER_MAX == 16
    for L in (8, 40, 191, 192, 256, 257, 300, 360, 480, 512):
        for M in list(range(1, 300, 7)) + [1000, 1999, 2000, 2001, 2100, 2905, 2906, 4000]:
            for cs in range(0, 18):
                shape = chain_dp_cuda.cluster_shape(M, L, sb, cs)
                if shape is None:
                    continue
                R, form, threads, smem = shape
                assert 1 <= cs <= 16 and R == -(-M // cs) and (cs - 1) * R < M <= cs * R
                assert threads <= (1024 if L <= 256 else 512) and threads % 32 == 0
                assert smem <= 232_448
                assert form == ("regs" if R <= 32 else
                                "rows_dense" if L % 32 == 0 else "rows")
                if form == "regs":
                    assert threads == 32 * -(-R // (1 if L <= 256 else 2))
                assert smem == 8 * M + (R * L * (2 * sb + 1) if R > 32 else 0)
            plan = chain_dp_cuda.cluster_plan(M, L, sb)
            assert plan == chain_dp_cuda.cluster_plan(M, L, sb)
            if plan is not None:
                assert plan[1:] == chain_dp_cuda.cluster_shape(M, L, sb, plan[0])
            large = chain_dp_cuda.route(M, L, sb) == "large"
            body = chain_dp_cuda.body(M, L, sb)
            assert (body == "cluster") == (large and plan is not None)
            if large and plan is None:
                grid = chain_dp_cuda.grid_plan(M, L, sb) is not None
                assert body == ("grid" if grid else "large")
    for M, L in ((264, 513), (24, 528), (5000, 192), (1400, 512)):
        plan = chain_dp_cuda.cluster_plan(M, L, sb)
        assert (plan is None) == (L <= 512)  # past 512: the tiled cluster body's plan
        assert plan is None or plan[2] == "tiled"
        if plan is None:
            assert chain_dp_cuda.body(M, L, sb) == "grid"


def test_constants_match_the_kernel_source():
    """The wrapper's copies of the cluster body's constants and formulas
    (csrc/chain_dp_cluster.cuh), of the lanes body's longest row, rows a
    warp in registers and thread rule, and of the entries' L guard."""
    src = (CSRC / "chain_dp_cluster.cuh").read_text()
    assert int(re.search(r"constexpr int kClusterMax = (\d+);", src).group(1)) == \
        chain_dp_cuda.CLUSTER_MAX
    assert int(re.search(r"constexpr long long kSmemLimit = (\d+);", src).group(1)) == \
        chain_dp_cuda.SMEM_LIMIT
    assert "return 2LL * M * 4 + (R > 32 ? (long long)R * L * (2 * state_bytes + 1) : 0);" in src
    assert ("dim3(kPath == kRegRows ? 32 * ((R + kP - 1) / kP) : lanes_max_threads<C, kPath>())"
            in src)
    lanes = (CSRC / "chain_dp_lanes.cuh").read_text()
    max_c = int(re.search(r"constexpr int kLanesMaxC = (\d+);", lanes).group(1))
    assert 32 * max_c == chain_dp_cuda.LANES_MAX_L == 512
    assert "return C <= 8 ? 1 : 2;" in lanes and chain_dp_cuda.LANES_LONG_L == 32 * 8
    assert all(f"SD_LANES_CASE({c})" in lanes for c in range(1, max_c + 1))
    assert f"SD_LANES_CASE({max_c + 1})" not in lanes
    assert all(f"SD_CLUSTER_CASE({c})" in src for c in range(1, max_c + 1))
    assert f"SD_CLUSTER_CASE({max_c + 1})" not in src
    assert "L > 32 * kLanesMaxC" in (CSRC / "chain_dp_lanes.cu").read_text()
    assert "L <= 32 * kLanesMaxC" in (CSRC / "chain_dp_cluster.cu").read_text()
    assert ("return kPath == kRegRows ? 1024 / lanes_reg_rows<C>()\n"
            "                           : (C <= 5 || (C == 6 && kPath == kRowsDense) ? 1024 : 512);"
            in lanes)


# cudaOccupancyMaxActiveClusters of the cluster sizes at M = 264, L = 192 on
# one H100 80GB HBM3 (k1_ab.py --sweep): how many clusters run at once
H100_ACTIVE_264 = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7, 12: 7,
                   13: 7, 14: 7, 15: 14, 16: 14}


@pytest.mark.parametrize("windows, want", [(3, 9), (19, 5), (36, 3), (64, 2), (200, 2)])
def test_cluster_plan_counts_waves(windows, want):
    """With the windows of a launch and the card's occupancy, the plan takes
    the fewest waves x (1 + rows a warp steps), ties to fewer blocks: at M = 264
    and the H100's occupancy, cs = 5 for the golden read's 19 windows (one
    wave of 22 clusters, two rows a warp), cs = 2 for a 64-window batch
    (66 clusters at once) and for 200, cs = 3 for 36, cs = 9 (rows in
    registers) where every size fits one wave. Sizes the card cannot schedule are left out; where none is
    left, the smallest admissible size is returned (its launch raises)."""
    plan = chain_dp_cuda.cluster_plan(264, 192, 4, windows, H100_ACTIVE_264.get)
    assert plan[0] == want
    assert plan[1:] == chain_dp_cuda.cluster_shape(264, 192, 4, want)
    only16 = chain_dp_cuda.cluster_plan(264, 192, 4, windows, lambda cs: 14 * (cs == 16))
    assert only16[0] == 16
    assert chain_dp_cuda.cluster_plan(264, 192, 4, windows, lambda cs: 0)[0] == 2
    assert chain_dp_cuda.cluster_plan(264, 192, 4) == chain_dp_cuda.cluster_plan(264, 192, 4, 1, lambda cs: 1)
