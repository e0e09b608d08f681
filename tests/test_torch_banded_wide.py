"""K4's and K5's wide routes (csrc/banded.cu banded_wide_kernel,
myers_wide_kernel) as their plain mirrors compute them
(stringdecomposer_tpu_torch.ops.banded.banded_staged / myers_staged):
pipelines of register stages in absolute rows, the link between stages,
bands of stages with their top links kept by column, the band's bottom and
top, the row-0 boundary while j <= k and K5's anchor handed from stage to
stage. Stages of 1-3 rows or words and 1-3 stages a band make small shapes
cross every one of those seams. Each mirror is held to its twin
(banded_final_column, banded_final_column_myers) and to the JAX package's
Pallas kernel run by the Pallas interpreter on the CPU. Every output is an
integer array and must be equal on every lane (tolerance 0). The kernels
themselves run only on the card, where chip_smoke.py holds them to the
same twins."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import banded_pallas as bp
from stringdecomposer_tpu_torch.ops import banded, banded_cuda
from stringdecomposer_tpu_torch.ops.hw_filter import WIDE_MAX_STAGES, WIDE_R

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
    padded width and pair 4 with a negative one (neither captured). mask:
    equality bitmasks over 7 symbols, 2 bits a query row, as align's
    encoding makes them; else codes 0-3 with negative padding (-1, matching
    nothing) in the targets."""
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
    ql[1], tl[2], tl[3], tl[4] = 0, 0, Lt + 5, -3
    return [a.astype(np.int32) for a in (q, ql, t, tl)]


KS = [0, 1, 2, 5, 13, 40]


# ---------------------------------------------------------------------------
# K4's wide route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("rows,stages", [(1, 1), (2, 3), (3, 2)])
@pytest.mark.parametrize("mask", [False, True])
def test_k4_staged_matches_twin(k, rows, stages, mask):
    """Every lane bit-equal to the twin with stages of 1-3 rows, 1-3 stages
    a band: the 70-row queries run 8-70 bands one after the other, the
    link crosses every stage and band seam, the band's bottom and top cross
    every stage, plain codes and equality bitmasks."""
    a = _t(*_codes(k * 31 + rows * 7 + stages, 6, 70, 80, mask))
    _eq(banded.banded_staged(*a, k=k, rows=rows, stages=stages, use_mask=mask),
        banded.banded_final_column(*a, k=k, use_mask=mask).numpy())


@pytest.mark.parametrize("k", [0, 40, 300])
@pytest.mark.parametrize("mask", [False, True])
def test_k4_staged_route_shape(k, mask):
    """At the route's own stages of WIDE4_R rows (banded_wide_shape)."""
    a = _t(*_codes(400 + k, 6, 120, 100, mask))
    _eq(banded.banded_staged(*a, k=k, use_mask=mask),
        banded.banded_final_column(*a, k=k, use_mask=mask).numpy())


@pytest.mark.parametrize("k,rows,stages", [(20, 2, 2), (9, 3, 1)])
def test_k4_staged_every_boundary_column(k, rows, stages):
    """A capture at every column 0..k + 2 (t_len = pair index), so while the
    NW boundary row is in the band, as it leaves and after, and t_len past
    the padded width."""
    P = k + 4
    q, ql, t, _ = _codes(7 + k, P, 60, k + 2)
    tl = np.arange(P, dtype=np.int32)  # the last pair's t_len exceeds Lt
    a = _t(q, ql, t, tl)
    _eq(banded.banded_staged(*a, k=k, rows=rows, stages=stages),
        banded.banded_final_column(*a, k=k).numpy())


@pytest.mark.parametrize("k,mask", [(3, False), (33, False), (2, True)])
def test_k4_staged_matches_pallas(k, mask):
    """Against the Pallas kernel run interpreted (targets of codes >= 0 and
    t_len within Lt: past it the Pallas kernel reads its padded tile)."""
    q, ql, t, tl = _codes(100 + k, 5, 120, 130, mask)
    t, tl[3], tl[4] = np.maximum(t, 0), 77, 5
    want = bp.banded_final_column_pallas(q, ql, t, tl, k=k, use_mask=mask)
    _eq(banded.banded_staged(*_t(q, ql, t, tl), k=k, rows=2, stages=3, use_mask=mask), want)


# ---------------------------------------------------------------------------
# K5's wide route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("words,stages", [(1, 1), (1, 2), (2, 3), (3, 1)])
def test_k5_staged_matches_twin(k, words, stages):
    """Every lane bit-equal to the twin with stages of 1-3 words, 1-3 stages
    a band: the 150-row queries' offset rows (up to q_len + k) run up to 6
    bands, the anchor crosses a stage every 32 words columns, negative
    padding codes in the targets."""
    a = _t(*_codes(k * 13 + words * 5 + stages, 6, 150, 120))
    _eq(banded.myers_staged(*a, k=k, words=words, stages=stages),
        banded.banded_final_column_myers(*a, k=k).numpy())


@pytest.mark.parametrize("k", [0, 40, 300])
def test_k5_staged_route_shape(k):
    """At the route's own stages of WIDE_R words (myers_wide_stages)."""
    a = _t(*_codes(500 + k, 6, 400, 330))
    _eq(banded.myers_staged(*a, k=k), banded.banded_final_column_myers(*a, k=k).numpy())


@pytest.mark.parametrize("k,words,stages", [(40, 1, 1), (9, 1, 2)])
def test_k5_staged_every_boundary_column(k, words, stages):
    """A capture at every column 0..k + 70 (t_len = pair index): the NW
    boundary row's lane at every j <= k, the anchor's first steps, its
    hand-off at each 32-row stage seam, and t_len past the padded width."""
    P = k + 72
    q, ql, t, _ = _codes(k + words, P, 90, k + 70)
    tl = np.arange(P, dtype=np.int32)  # the last pair's t_len exceeds Lt
    a = _t(q, ql, t, tl)
    _eq(banded.myers_staged(*a, k=k, words=words, stages=stages),
        banded.banded_final_column_myers(*a, k=k).numpy())


@pytest.mark.parametrize("k", [8, 31])
def test_k5_staged_matches_pallas(k):
    """Against the Pallas kernel itself, run interpreted."""
    q, ql, t, tl = _codes(50 + k, 5, 256, 256)
    t, tl[3], tl[4] = np.maximum(t, 0), 200, 9
    want = bp.banded_final_column_myers(q, ql, t, tl, k=k)
    _eq(banded.myers_staged(*_t(q, ql, t, tl), k=k, words=1, stages=2), want)


# ---------------------------------------------------------------------------
# the routes' shapes and the wrappers on CPU tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Lq,Lt,k", [(9217, 1024, 8192), (40000, 40000, 8192), (1, 1, 256),
                                     (700, 650, 256), (3000, 1500, 40000), (45000, 120, 20000),
                                     (300_000, 300_000, 4096), (2048, 1 << 20, 256),
                                     (262_144, 262_144, 256)])
def test_wide_stages(Lq, Lt, k):
    """Whole warps, at most WIDE_MAX_STAGES; one band holds every row (K4)
    or word (K5) a pair of these widths can need unless the route says it
    may take more (and then allocates the top links: K4 a seam for each band
    a pair can take past its first, K5 one scratch); K4's band has at most
    WIDE4_STAGES stages and runs a pair's bands on a cluster of 1 + ceil(2k
    / RB) blocks, at most K4_CLUSTER_MAX and the bands."""
    stages, seams, cs = banded.banded_wide_shape(Lq, Lt, k)
    rows = min(Lq, Lt + k) + 1
    RB = stages * banded.WIDE4_R
    assert seams == -(-rows // RB) - 1
    assert stages <= banded.WIDE4_STAGES
    assert cs == min(banded.K4_CLUSTER_MAX, seams + 1, 1 + -(-2 * k // RB))
    for stages, tall, units, per in (
            (stages, seams > 0, rows, banded.WIDE4_R),
            (*banded.myers_wide_stages(Lq, Lt, k), min(Lq + k, Lt + 2 * k) // 32 + 1, WIDE_R)):
        assert stages % 32 == 0 and 32 <= stages <= WIDE_MAX_STAGES
        assert stages - 32 < -(-units // per)  # no whole warp to spare
        assert (stages * per >= units) != tall
        if tall:
            assert stages in (WIDE_MAX_STAGES, banded.WIDE4_STAGES)


def test_wide_stages_cases():
    """The cut shapes of align_wide's last band (k = 8,192 on 9,217 x
    1,024): K4 three bands of 128 stages of 32 rows at once on a cluster of
    three blocks, K5 96 stages of 8 words in 3 warps, one band. The whole
    40 kbp pair at k = 8,192: K4 ten bands of 4,096 rows on a cluster of 5;
    K5 192 stages for its 48,192 offset rows, one band. The 262,144 bp pair
    at k = 256: K4 65 bands on a cluster of two. A 2,048 bp query against a
    1 Mbp target at k = 256 holds 2,049 rows: one band of 96 stages, no
    seam. Forced to 32 stages, a 10,000-row pair at k = 4,000 takes 10
    bands on a cluster of 8, and the 2,048 bp query three bands."""
    assert banded.banded_wide_shape(9217, 1024, 8192) == (128, 2, 3)
    assert banded.myers_wide_stages(9217, 1024, 8192) == (96, False)
    assert banded.banded_wide_shape(40000, 40000, 8192) == (128, 9, 5)
    assert banded.myers_wide_stages(40000, 40000, 8192) == (192, False)
    assert banded.banded_wide_shape(262_144, 262_144, 256) == (128, 64, 2)
    assert banded.banded_wide_shape(2048, 1 << 20, 256) == (96, 0, 1)
    assert banded.banded_wide_shape(2048, 1 << 20, 256, stages=32) == (32, 2, 2)
    assert banded.banded_wide_shape(10000, 9500, 4000, stages=32) == (32, 9, 8)


@pytest.mark.parametrize("k", [300, 8192])
def test_wide_routes_on_cpu(k):
    """On CPU tensors the wide route gives the twin's output and counts no
    launch, for K4 (plain and mask mode) and K5."""
    a = _t(*_codes(9, 6, 40, 50))
    f4, f5 = banded_cuda.banded_final_column_cuda, banded_cuda.banded_myers_cuda
    before = (f4.launches, f4.launches_wide, f5.launches, f5.launches_wide)
    for mask in (False, True):
        _eq(f4(*a, k=k, use_mask=mask, route="wide"),
            banded.banded_final_column(*a, k=k, use_mask=mask).numpy())
    _eq(f5(*a, k=k, route="wide"), banded.banded_final_column_myers(*a, k=k).numpy())
    assert (f4.launches, f4.launches_wide, f5.launches, f5.launches_wide) == before
