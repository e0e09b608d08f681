"""K3's bit-parallel arithmetic on the CPU: ops/hw_filter.hw_distance_myers,
which repeats csrc/hw_filter.cu's three routes (their word layouts, target
segments and warm-up), against the JAX package's hw_distance_batch (the
lax.scan) and, at the smallest shapes, hw_distance_batch_pallas run by the
Pallas interpreter, on the same NumPy inputs; and the segment plan
(ops/hw_filter_cuda.hw_segment_plan) as a pure function. Every output is an
integer array and must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import hw_filter as jax_hw
from stringdecomposer_tpu_torch.ops import hw_filter as plain
from stringdecomposer_tpu_torch.ops import hw_filter_cuda
from stringdecomposer_tpu_torch.ops.chain_dp import READ_PAD
from stringdecomposer_tpu_torch.ops.hw_filter_cuda import hw_distance_batch_cuda, hw_segment_plan

torch.set_num_threads(1)


def _problem(seed, wlens, mlens, L, W=None, alphabet=5):
    """Random codes (N = 4 included when alphabet is 5), windows of the
    given lengths padded with READ_PAD to W, monomers of the given lengths
    padded with PAD_CODE (5) to L."""
    rng = np.random.default_rng(seed)
    W = max(wlens) if W is None else W
    win = np.full((len(wlens), W), READ_PAD, dtype=np.int8)
    for b, n in enumerate(wlens):
        win[b, :n] = rng.integers(0, alphabet, n)
    mono = np.full((len(mlens), L), 5, dtype=np.int8)
    for m, n in enumerate(mlens):
        mono[m, :n] = rng.integers(0, alphabet, n)
    return win, np.asarray(wlens, dtype=np.int32), mono, np.asarray(mlens, dtype=np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _routes(L):
    return [r for r in plain.ROUTES if r != "thread" or L <= plain.THREAD_MAX_L]


def _check(arrays, seg_cols=(0, 16, 48)):
    """The mirror on every route that holds L, at each forced plan (the
    wide route at one segment), equal to the JAX scan."""
    want = np.asarray(jax_hw.hw_distance_batch(*arrays))
    t = _torch(*arrays)
    L = arrays[2].shape[1]
    for route in _routes(L):
        for sc in seg_cols if route != "wide" else (0,):
            got = plain.hw_distance_myers(*t, route=route, seg_cols=sc).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"route {route}, seg_cols {sc}")
    return want


@pytest.mark.parametrize("L", [1, 31, 32, 33, 63, 64, 65, 511, 512, 513])
def test_mirror_matches_jax_at_word_seams(L):
    """Padded lengths at the word seams (R = 1, 2, 3, 16, 17 words; 513 past
    the thread route, on the warp route), monomers at L, L - 1, 1 and a
    random length, against windows shorter and longer than the monomers."""
    rng = np.random.default_rng(L)
    mlens = sorted({L, max(1, L - 1), 1, int(rng.integers(1, L + 1))}, reverse=True)
    arrays = _problem(L, [70, 1, 33, 17], mlens, L)
    assert L == 1 or arrays[3].max() > arrays[1].min()  # mono_len > window_len
    want = _check(arrays)
    assert (want[:, 0] <= L).all()


@pytest.mark.parametrize("S", [16, 32])
def test_windows_at_segment_edges_and_short_of_the_warm_up(S):
    """Window lengths at a segment multiple and one either side, a window
    of length 1, and windows shorter than a monomer's warm-up (2 mono_len
    columns) cut into segments."""
    wlens = [1, S - 1, S, S + 1, 2 * S - 1, 2 * S, 2 * S + 1, 3 * S + 1, 45]
    arrays = _problem(S, wlens, [40, 24, 7, 1], 40, W=3 * S + 8)
    _check(arrays, seg_cols=(0, S))


def test_all_n_codes_and_read_pad():
    """N (4) matches N; READ_PAD and the window's padding match nothing:
    all-N windows against all-N monomers give 0, against other codes the
    monomer length; a window of READ_PAD inside its length matches
    nothing either."""
    L = 40
    win = np.full((3, 50), READ_PAD, dtype=np.int8)
    win[0, :50] = 4
    win[1, :30] = 4
    win[2, :20] = READ_PAD  # inside the window, never a match
    wl = np.array([50, 30, 20], dtype=np.int32)
    mono = np.full((3, L), 5, dtype=np.int8)
    mono[0, :40] = 4
    mono[1, :10] = 4
    mono[2, :35] = np.arange(35) % 4
    ml = np.array([40, 10, 35], dtype=np.int32)
    want = _check((win, wl, mono, ml))
    assert want[0, 0] == 0 and want[0, 1] == 0 and want[1, 1] == 0
    assert want[1, 0] == 10  # 40 N against 30 N: 10 to add
    assert list(want[2]) == [40, 10, 35]


@pytest.mark.parametrize("L", [24, 65, 513])
def test_codes_outside_0_to_4_compare_as_in_the_twin(L):
    """Monomer and window codes outside 0-4 (READ_PAD, 7, negative codes)
    match equal codes, as the JAX function compares them, on every route
    that holds L (the kernels' slow path for such codes)."""
    rng = np.random.default_rng(L + 1)
    codes = np.array([0, 1, 2, 3, 4, READ_PAD, 7, -3], dtype=np.int8)
    mlens = [L, max(1, L // 2), 1]
    win, wl, mono, ml = _problem(L, [90, 40, 3], mlens, L, W=96)
    for b, n in enumerate(wl):
        win[b, :n] = rng.choice(codes, n)
    for m, n in enumerate(ml):
        mono[m, :n] = rng.choice(codes, n)
    mono[2, 0] = 7  # a one-row monomer of code 7: 0 wherever a window holds 7
    want = _check((win, wl, mono, ml), seg_cols=(0, 16))
    assert list(want[:, 2]) == [int(not (win[b, : wl[b]] == 7).any()) for b in range(3)]


def test_forced_plans_agree_with_each_other_and_the_twin():
    arrays = _problem(7, [300, 299, 257, 16, 1], [65, 64, 63, 40, 2], 65, W=301)
    t = _torch(*arrays)
    twin = plain.hw_distance_batch(*t).numpy()
    np.testing.assert_array_equal(twin, np.asarray(jax_hw.hw_distance_batch(*arrays)))
    for route in ("thread", "warp"):
        for sc in (0, 16, 32, 64, 96, 160, 304):
            got = plain.hw_distance_myers(*t, route=route, seg_cols=sc).numpy()
            np.testing.assert_array_equal(got, twin, err_msg=f"route {route}, seg_cols {sc}")


@pytest.mark.parametrize("seed,wlens,mlens,L", [
    (0, [40, 1, 23], [24, 1, 17], 24),
    (1, [33, 32], [33, 32, 31], 33),
])
def test_mirror_matches_pallas_interpret(seed, wlens, mlens, L):
    arrays = _problem(seed, wlens, mlens, L)
    pallas = np.asarray(jax_hw.hw_distance_batch_pallas(*arrays, pair_tile=8, t_tile=16))
    t = _torch(*arrays)
    for route in plain.ROUTES:
        got = plain.hw_distance_myers(*t, route=route, seg_cols=16 if route != "wide" else 0)
        np.testing.assert_array_equal(got.numpy(), pallas, err_msg=route)


@pytest.mark.parametrize("P,L,W", [(456, 192, 5500), (5016, 192, 5500), (16896, 192, 5500),
                                   (456, 528, 5500), (1, 10, 100), (3, 700, 150), (0, 24, 70),
                                   (10, 0, 70), (7, 24, 16)])
def test_segment_plan_is_pure_and_covers_the_windows(P, L, W):
    for resident, per_sm in ((1536, hw_filter_cuda.SEG_THREADS_PER_SM),
                             (64, hw_filter_cuda.SEG_WARPS_PER_SM), (8, 170)):
        nseg, S = hw_segment_plan(P, L, W, 132, resident, per_sm)
        assert (nseg, S) == hw_segment_plan(P, L, W, 132, resident, per_sm)
        assert S >= 16 and S % 16 == 0 and nseg * S >= W and (nseg - 1) * S < max(W, 1)
        # segments only where a segment's chain, warm-up included, is shorter
        assert nseg == 1 or S + 2 * L < W
        # the resident units cap the units an SM overlaps
        assert (nseg, S) == hw_segment_plan(P, L, W, 132, resident, min(per_sm, resident))


def test_segment_plan_at_the_measured_shapes():
    """The golden windows (W = 5,500) x DXZ1 (M = 24) and x the library (M
    = 264) and 64 windows x the library, at L = 192 on a card of 132 SMs:
    fewer pairs take more segments, and enough pairs take none."""
    plans = [hw_segment_plan(P, 192, 5500, 132, 1536, 170) for P in (456, 5016, 16896, 10 ** 6)]
    assert [n for n, _ in plans] == sorted((n for n, _ in plans), reverse=True)
    assert plans[0][0] > plans[1][0] > 1 and plans[-1] == (1, 5504)


@pytest.mark.parametrize("L,want", [(0, (32, 1)), (1, (32, 1)), (16385, (96, 1)),
                                    (131072, (512, 1)), (131073, (512, 2)),
                                    (600000, (512, 5))])
def test_wide_shape(L, want):
    """The wide route's stages a band (whole warps, at most 512) and bands:
    together they hold every word of the column."""
    stages, bands = plain.wide_shape(L)
    assert (stages, bands) == want
    assert stages % 32 == 0 and bands * stages * plain.WIDE_R * 32 >= max(L, 1)


def test_wide_route_past_one_band():
    """Monomers past 131,072 bp take the wide route's second band of
    stages; the mirror at that layout equals the JAX scan."""
    L = 131073
    assert plain.wide_shape(L)[1] == 2
    arrays = _problem(5, [20, 7], [L, 40], L, W=24)
    arrays[2][0, -10:] = arrays[0][0, :10]  # the monomer's tail in window 0
    want = np.asarray(jax_hw.hw_distance_batch(*arrays))
    got = plain.hw_distance_myers(*_torch(*arrays), route="wide").numpy()
    np.testing.assert_array_equal(got, want)


def test_routes_and_wrapper_checks():
    assert [plain.hw_route(L) for L in (0, 512, 513, 16384, 16385)] == [
        "thread", "thread", "warp", "warp", "wide"]
    assert plain.hw_route(30, "wide") == "wide"
    with pytest.raises(ValueError):
        plain.hw_route(513, "thread")
    with pytest.raises(ValueError):
        plain.hw_route(16385, "warp")
    with pytest.raises(ValueError):
        plain.hw_route(10, "block")
    arrays = _torch(*_problem(3, [30, 5], [9, 4], 9))
    before = (hw_distance_batch_cuda.launches, hw_distance_batch_cuda.launches_warp,
              hw_distance_batch_cuda.launches_wide)
    # a CPU tensor runs the twin and launches nothing
    np.testing.assert_array_equal(hw_distance_batch_cuda(*arrays, route="warp", seg_cols=16),
                                  plain.hw_distance_batch(*arrays))
    assert (hw_distance_batch_cuda.launches, hw_distance_batch_cuda.launches_warp,
            hw_distance_batch_cuda.launches_wide) == before
    for bad in (dict(seg_cols=8), dict(seg_cols=-16), dict(route="wide", seg_cols=16),
                dict(route="thread", seg_cols=17)):
        with pytest.raises(ValueError):
            hw_distance_batch_cuda(*arrays, **bad)
    with pytest.raises(ValueError):
        plain.hw_distance_myers(*arrays, route="wide", seg_cols=16)
