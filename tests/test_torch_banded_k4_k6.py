"""K4's warp route (csrc/banded_warp.cu) and K6's wide route (csrc/banded.cu
semi_wide_kernel) as their plain mirrors compute them
(stringdecomposer_tpu_torch.ops.banded.banded_warp / semi_staged): K4's
band in lane strips of R cells with the seam shuffle and the lane scan of
the up chain, K6's query in stages of 8 words run as a pipeline with the
link between stages, bands of stages and the cut at the end row's stage,
and its HW segments. Each is held to its twin (banded_final_column,
semi_ends_myers) and to the JAX package's Pallas kernel run by the Pallas
interpreter on the CPU. Every output is an integer array and must be equal
on every lane (tolerance 0). The kernels themselves run only on the card,
where chip_smoke.py holds them to the same twins."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import banded_pallas as bp
from stringdecomposer_tpu_torch.ops import banded, banded_cuda
from stringdecomposer_tpu_torch.ops.hw_filter import wide_shape

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, dtype=np.int64)
    want = np.asarray(want, dtype=np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


def _codes(seed, P, Lq, Lt, mask=False):
    """Random codes with ragged lengths: pair 0 at full width, pair 1 with
    an empty query, pair 2 with an empty target, pair 3 with t_len past the
    padded width (never captured by K4). mask: equality bitmasks over 7
    symbols, 2 bits a query row, as align's encoding makes them."""
    rng = np.random.default_rng(seed)
    if mask:
        q = (1 << rng.integers(0, 7, (P, Lq))) | (1 << rng.integers(0, 7, (P, Lq)))
        t = rng.integers(0, 7, (P, Lt))
    else:
        q = rng.integers(0, 4, (P, Lq))
        t = rng.integers(-1, 4, (P, Lt))
    ql = rng.integers(0, Lq + 1, P)
    tl = rng.integers(0, Lt + 1, P)
    ql[0], tl[0] = Lq, Lt
    ql[1], tl[2], tl[3] = 0, 0, Lt + 5
    return [a.astype(np.int32) for a in (q, ql, t, tl)]


# ---------------------------------------------------------------------------
# K4's warp route
# ---------------------------------------------------------------------------
K4_KS = [0, 1, 15, 16, 31, 32, 63, 64, 255]
# (k, R): every R in {1, 2, 9, 16} that holds the band's 2k + 1 lanes
K4_CASES = [(k, R) for k in K4_KS for R in (1, 2, 9, 16) if 32 * R >= 2 * k + 1]


@pytest.mark.parametrize("k,R", K4_CASES)
@pytest.mark.parametrize("mask", [False, True])
def test_k4_mirror_matches_twin(k, R, mask):
    """Every lane bit-equal to the twin at forced lane strips, through the
    boundary columns j <= k and past them, plain codes (negative padding in
    the targets) and equality bitmasks."""
    a = _t(*_codes(k * 17 + R, 6, 90, 110, mask))
    _eq(banded.banded_warp(*a, k=k, R=R, use_mask=mask),
        banded.banded_final_column(*a, k=k, use_mask=mask).numpy())


@pytest.mark.parametrize("k", K4_KS)
def test_k4_mirror_matches_pallas(k):
    """At the route's own R = ceil((2k + 1) / 32), against the Pallas kernel
    run interpreted (on targets of codes >= 0 and t_len within Lt: past it
    the Pallas kernel reads its padded tile, the twin gives BIG)."""
    q, ql, t, tl = _codes(100 + k, 5, 120, 130)
    t, tl[3] = np.maximum(t, 0), 77
    want = bp.banded_final_column_pallas(q, ql, t, tl, k=k)
    _eq(banded.banded_warp(*_t(q, ql, t, tl), k=k), want)


@pytest.mark.parametrize("k", [2, 33])
def test_k4_mirror_matches_pallas_mask_mode(k):
    q, ql, t, tl = _codes(200 + k, 5, 120, 130, mask=True)
    tl[3] = 77
    want = bp.banded_final_column_pallas(q, ql, t, tl, k=k, use_mask=True)
    _eq(banded.banded_warp(*_t(q, ql, t, tl), k=k, use_mask=True), want)


def test_k4_mirror_every_boundary_column():
    """A capture at every column 0..k + 2 (t_len = pair index), so at every
    boundary lane b0 = k - j, and t_len past the padded width."""
    k = 20
    P = k + 4
    q, ql, t, _ = _codes(7, P, 60, k + 2)
    tl = np.arange(P, dtype=np.int32)  # the last pair's t_len exceeds Lt
    a = _t(q, ql, t, tl)
    _eq(banded.banded_warp(*a, k=k, R=2), banded.banded_final_column(*a, k=k).numpy())


def test_k4_routes():
    """"auto" takes the warp route up to k = 255 (511 band lanes) and the
    wide one from 256; "warp" past 255 and unknown routes are refused before
    any dispatch; a lane strip that cannot hold the band is refused; on CPU
    tensors both routes give the twin's output and count no launch."""
    assert banded_cuda._warp_route(2 * 255 + 1, "auto")
    assert not banded_cuda._warp_route(2 * 256 + 1, "auto")
    a = _t(*_codes(3, 4, 40, 50))
    with pytest.raises(ValueError):
        banded_cuda.banded_final_column_cuda(*a, k=256, route="warp")
    with pytest.raises(ValueError):
        banded_cuda.banded_final_column_cuda(*a, k=8, route="block")
    with pytest.raises(ValueError):
        banded.banded_warp(*a, k=16, R=1)  # 33 lanes in 32 cells
    fn = banded_cuda.banded_final_column_cuda
    before = (fn.launches, fn.launches_wide)
    for k, route in ((8, "warp"), (8, "wide"), (300, "auto"), (300, "wide")):
        for mask in (False, True):
            _eq(fn(*a, k=k, use_mask=mask, route=route),
                banded.banded_final_column(*a, k=k, use_mask=mask).numpy())
    assert (fn.launches, fn.launches_wide) == before


# ---------------------------------------------------------------------------
# K6's wide route
# ---------------------------------------------------------------------------
QLENS = [1, 255, 256, 257, 700]  # a stage holds 256 rows: its seams and three stages


def _semi(seed, Lt=200):
    """Five pairs of queries padded to 700 rows at the q_lens of QLENS, and
    a sixth with an empty query."""
    q, _, t, tl = _codes(seed, 6, 700, Lt)
    ql = np.array(QLENS + [0], dtype=np.int32)
    return q, ql, t, tl


@pytest.mark.parametrize("stages", [None, 1, 2, 3])
@pytest.mark.parametrize("free_target_prefix", [True, False])
def test_k6_staged_matches_twin(stages, free_target_prefix):
    """The stages' pipeline, with `stages` a band forced to 1-3 so that the
    700-row query's three stages cross bands (each band's top links kept by
    column for the next) and the end row's stage cuts the pipeline short,
    equal to the twin; None takes wide_shape's 32 stages, one band."""
    q, ql, t, tl = _semi(11 + (stages or 0))
    want = banded.semi_ends_myers(*_t(q, ql, t, tl), free_target_prefix=free_target_prefix)
    got = banded.semi_staged(*_t(q, ql, t), free_target_prefix=free_target_prefix, stages=stages)
    _eq(got, want.numpy())


@pytest.mark.parametrize("free_target_prefix", [True, False])
def test_k6_staged_matches_pallas(free_target_prefix):
    """Against the Pallas kernel run interpreted, stages a band forced to 2."""
    q, ql, t, tl = _semi(21)
    t = np.maximum(t, 0)
    want = bp.semi_ends_myers(q, ql, t, tl, free_target_prefix=free_target_prefix)
    _eq(banded.semi_staged(*_t(q, ql, t), free_target_prefix=free_target_prefix, stages=2), want)


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("stages", [None, 2])
def test_k6_staged_segments_match_one_block(S, stages):
    """HW in segments of S columns, each warm-started at max(0, e_s -
    2 q_len), equal to one block a pair at every column and seam (a
    1-row query's segments warm up 2 columns; the 700-row query's from
    column 0)."""
    q, ql, t, _ = _semi(31 + S, Lt=330)
    want = banded.semi_staged(*_t(q, ql, t), free_target_prefix=True, stages=stages).numpy()
    _eq(banded.semi_staged(*_t(q, ql, t), free_target_prefix=True, stages=stages, seg_cols=S),
        want)
    with pytest.raises(ValueError):
        banded.semi_staged(*_t(q, ql, t), free_target_prefix=False, seg_cols=S)


def test_k6_wide_route_arguments():
    """seg_cols reaches the wide route under HW with the warp route's checks
    (a multiple of 32, HW only); on CPU tensors the wide route with or
    without segments gives the twin's output and counts no launch."""
    q, ql, t, tl = _t(*_semi(41))
    fn = banded_cuda.semi_ends_cuda
    for bad in (dict(seg_cols=48), dict(seg_cols=-32), dict(seg_cols=32, free_target_prefix=False)):
        with pytest.raises(ValueError):
            fn(q, ql, t, tl, route="wide", **bad)
    before = (fn.launches, fn.launches_wide)
    want = banded.semi_ends_myers(q, ql, t, tl).numpy()
    for seg_cols in (None, 0, 32):
        _eq(fn(q, ql, t, tl, route="wide", seg_cols=seg_cols), want)
    assert (fn.launches, fn.launches_wide) == before


@pytest.mark.parametrize("P,Lq,Lt", [(1, 17000, 1 << 20), (1, 17000, 2048), (3, 40000, 50_000),
                                     (1, 16385, 1 << 20), (64, 20000, 1 << 20),
                                     (1, 200_000, 1 << 21)])
@pytest.mark.parametrize("sms,resident", [(132, 5), (132, 2), (132, 1), (20, 8)])
def test_wide_segment_plan(P, Lq, Lt, sms, resident):
    """The wide plan's invariants, as the warp route's: a pure function; S a
    multiple of 32 covering Lt in nseg segments with no empty one; no more
    blocks than WIDE_BLOCKS_PER_SM an SM, at most `resident`); segments only
    where S + 2 Lq < Lt."""
    nseg, S = banded_cuda.wide_segment_plan(P, Lq, Lt, sms, resident)
    assert (nseg, S) == banded_cuda.wide_segment_plan(P, Lq, Lt, sms, resident)
    if nseg == 1:
        assert S == Lt
        return
    per_sm = min(resident, banded_cuda.WIDE_BLOCKS_PER_SM)
    assert S % 32 == 0 and nseg * S >= Lt > (nseg - 1) * S
    assert P * nseg <= sms * per_sm
    assert S + 2 * Lq < Lt


def test_wide_segment_plan_cases():
    """A 17 kbp query (532 words: 96 stages, 3 warps a block) against 1 Mbp
    on 132 SMs takes one block an SM, 132 segments of 7,968 columns; a
    2,048-column target or as many pairs as the card's SMs take one block a
    pair."""
    assert wide_shape(17000) == (96, 1)
    assert banded_cuda.wide_segment_plan(1, 17000, 1 << 20, 132, 5) == (132, 7968)
    assert banded_cuda.wide_segment_plan(1, 17000, 2048, 132, 5) == (1, 2048)
    assert banded_cuda.wide_segment_plan(132, 17000, 1 << 20, 132, 5) == (1, 1 << 20)
    assert banded_cuda.wide_segment_plan(264, 17000, 1 << 20, 132, 5) == (1, 1 << 20)
