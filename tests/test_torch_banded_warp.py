"""The warp route of K5 and K6 (csrc/myers_warp.cu) as its plain mirrors
compute it (stringdecomposer_tpu_torch.ops.banded.myers_warp / semi_warp):
lane strips of R words, the carries by the add identity within a lane and
across the lanes' ballots, the shuffle seams, K5's funnel-shift Peq words and K6's HW segments with their
warm-up, against the twins (banded_final_column_myers, semi_ends_myers)
and against the JAX package's Pallas kernels run by the Pallas interpreter
on the CPU. Every output is an integer array and must be equal on every
lane (tolerance 0). The kernels themselves run only on the card, where
chip_smoke.py holds them to the same twins."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import banded_pallas as bp
from stringdecomposer_tpu_torch.ops import align, banded, banded_cuda

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, dtype=np.int64)
    want = np.asarray(want, dtype=np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


def _codes(seed, P, Lq, Lt, t_neg=True):
    """Random codes with ragged lengths: pair 0 at full width, pair 1 with
    an empty query, pair 2 with an empty target; t_neg puts negative
    padding codes (-1, matching nothing) into the targets."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (P, Lq)).astype(np.int32)
    t = rng.integers(-1 if t_neg else 0, 4, (P, Lt)).astype(np.int32)
    ql = rng.integers(0, Lq + 1, P).astype(np.int32)
    tl = rng.integers(0, Lt + 1, P).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    ql[1], tl[2] = 0, 0
    return q, ql, t, tl


# ---------------------------------------------------------------------------
# the carry identity and the bitmaps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_carry_identity_matches_ripple(seed):
    """Bit l of (A + G) ^ A ^ G, A = G | P, is the carry a ripple over the
    lanes' exclusive (generate, propagate) pairs brings into lane l."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, (4096, 32))  # 0 kill, 1 generate, 2 propagate
    kind[:64] = 2  # long propagate runs, whole-warp ones included
    kind[64:96, 0] = 1
    g, p = (kind == 1).astype(np.int64), (kind == 2).astype(np.int64)
    want = np.zeros_like(g)
    c = np.zeros(len(g), dtype=np.int64)
    for lane in range(32):
        want[:, lane] = c
        c = g[:, lane] | (p[:, lane] & c)
    _eq(banded.carry_in_lanes(*_t(g, p)), want)


@pytest.mark.parametrize("R", [1, 2, 9, 16])
def test_lane_carries_match_word_ripple(R):
    """The carry into each of the warp's 32 R words, from the in-lane add on
    R-bit masks and the ballots, equals a ripple over all the words."""
    rng = np.random.default_rng(R)
    kind = rng.integers(0, 3, (512, 32 * R))
    kind[:16] = 2  # all-propagate runs across lanes
    kind[16:32, : 32 * R // 2] = 2
    g, p = (kind == 1).astype(np.int64), (kind == 2).astype(np.int64)
    want = np.zeros_like(g)
    c = np.zeros(len(g), dtype=np.int64)
    for w in range(32 * R):
        want[:, w] = c
        c = g[:, w] | (p[:, w] & c)
    got = banded.lane_carries(*_t(g.reshape(-1, 32, R), p.reshape(-1, 32, R)))
    _eq(got.reshape(len(g), 32 * R), want)


@pytest.mark.parametrize("off,NB", [(0, 3), (9, 5), (40, 4)])
def test_peq_bitmaps(off, NB):
    q, ql, _, _ = _codes(5, 4, 70, 8)
    got = banded.peq_bitmaps(*_t(q, ql), off, NB).numpy()
    for p in range(4):
        for c in range(4):
            for bit in range(32 * NB):
                i = bit - off
                want = 0 <= i < ql[p] and q[p, i] == c
                assert ((got[p, c, bit // 32] >> (bit % 32)) & 1) == want, (p, c, bit)


# ---------------------------------------------------------------------------
# K5's mirror
# ---------------------------------------------------------------------------
K5_CASES = [  # (k, R, Lq, Lt): R = 1, 2, 9, 16 over k in {8, 31, 256, 300, 1000}
    (8, 1, 60, 70), (8, 16, 60, 70), (31, 1, 110, 100), (31, 2, 110, 100),
    (256, 1, 420, 400), (256, 9, 300, 280), (300, 1, 420, 380), (300, 16, 350, 320),
    (1000, 2, 1100, 1040), (1000, 9, 300, 160),
]


@pytest.mark.parametrize("k,R,Lq,Lt", K5_CASES)
def test_k5_mirror_matches_twin(k, R, Lq, Lt):
    """Every lane bit-equal to the twin, through the boundary columns j <=
    k and, where Lt > k, past them; t_len 0 and negative padding codes."""
    a = _t(*_codes(k + R, 5, Lq, Lt))
    _eq(banded.myers_warp(*a, k=k, R=R), banded.banded_final_column_myers(*a, k=k).numpy())


@pytest.mark.parametrize("k", [0, 1, 15, 16])
@pytest.mark.parametrize("R", [1, 3])
def test_k5_mirror_narrow_bands(k, R):
    """Bands of 1, 3, 31 and 33 lanes: the anchor's bit 1 outside a band of
    one lane, the top lane at the end of a word and past it."""
    a = _t(*_codes(90 + k, 6, 80, 90))
    _eq(banded.myers_warp(*a, k=k, R=R), banded.banded_final_column_myers(*a, k=k).numpy())


@pytest.mark.parametrize("k,R", [(8, 1), (31, 2), (100, 16)])
def test_k5_mirror_matches_pallas(k, R):
    """Against the Pallas kernel itself, run interpreted; the last case on
    the router's compact codes (q-only symbols -9, t-only -1)."""
    q, ql, t, tl = _codes(50 + k, 4, 256, 256, t_neg=False)
    if k == 100:
        q = np.where(q == 3, 4, q)  # symbol 4 only in q, 5 only in t
        q, t = align._myers_compact_alphabet(q, ql, np.where(t == 2, 5, t), tl)
        assert (q == -9).any() and (t == -1).any()
    want = bp.banded_final_column_myers(q, ql, t, tl, k=k)
    _eq(banded.myers_warp(*_t(q, ql, t, tl), k=k, R=R), want)


@pytest.mark.parametrize("k,R", [(31, 1), (40, 2), (64, 9)])
def test_k5_mirror_every_boundary_column(k, R):
    """A capture at every column 0..k+2 (t_len = pair index), the boundary
    lane b0 = k - j at each, and t_len past the padded width (never
    captured)."""
    P = k + 4
    q, ql, t, _ = _codes(k, P, 90, k + 2)
    tl = np.arange(P, dtype=np.int32)  # the last pair's t_len exceeds Lt
    a = _t(q, ql, t, tl)
    _eq(banded.myers_warp(*a, k=k, R=R), banded.banded_final_column_myers(*a, k=k).numpy())


# ---------------------------------------------------------------------------
# K6's mirror and its HW segments
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Lq,R", [(1, 1), (31, 1), (32, 2), (33, 9), (700, 1), (700, 16)])
@pytest.mark.parametrize("free_target_prefix", [True, False])
def test_k6_mirror_matches_twin(Lq, R, free_target_prefix):
    """q_len in {0, 1, 31, 32, 33, 700} (pair 1 has q_len 0), HW and SHW,
    one warp a pair."""
    q, ql, t, tl = _codes(Lq + R, 5, Lq, 230)
    want = banded.semi_ends_myers(*_t(q, ql, t, tl), free_target_prefix=free_target_prefix)
    _eq(banded.semi_warp(*_t(q, ql, t), free_target_prefix=free_target_prefix, R=R), want.numpy())


SEG_CASES = [  # (Lq, Lt, S)
    (33, 200, 64),   # S does not divide Lt; S < 2 q_len
    (100, 200, 32),  # Lt = 2 q_len: every segment past the first warms up from column 0
    (150, 200, 96),  # Lt < 2 q_len
    (9, 301, 32),    # short queries: warm-ups of 2 q_len < S, a seam every 32 columns
    (64, 1000, 160),
]


@pytest.mark.parametrize("Lq,Lt,S", SEG_CASES)
def test_k6_segments_match_twin(Lq, Lt, S):
    """HW split into segments of S columns, each warm-started at max(0,
    e_s - 2 q_len): equal to the unsplit twin at every column and seam."""
    q, ql, t, tl = _codes(Lq * 7 + S, 6, Lq, Lt)
    ql[3] = 1
    want = banded.semi_ends_myers(*_t(q, ql, t, tl), free_target_prefix=True).numpy()
    _eq(banded.semi_warp(*_t(q, ql, t), free_target_prefix=True, seg_cols=S), want)


@pytest.mark.parametrize("Lq,S", [(31, 32), (100, 64)])
def test_k6_segments_match_pallas(Lq, S):
    """The segmented mirror against the Pallas kernel run interpreted."""
    q, ql, t, tl = _codes(70 + Lq, 4, Lq, 300, t_neg=False)
    want = bp.semi_ends_myers(q, ql, t, tl, free_target_prefix=True)
    _eq(banded.semi_warp(*_t(q, ql, t), free_target_prefix=True, seg_cols=S), want)


def test_k6_shw_is_never_segmented():
    """SHW fixes the start at column 0: the mirror and the wrapper refuse
    segments for it, and the wrapper asks for none (seg_cols None) under
    SHW; on CPU tensors the wrapper runs the twin."""
    q, ql, t, tl = _t(*_codes(3, 4, 40, 200))
    with pytest.raises(ValueError):
        banded.semi_warp(q, ql, t, free_target_prefix=False, seg_cols=32)
    with pytest.raises(ValueError):
        banded_cuda.semi_ends_cuda(q, ql, t, tl, free_target_prefix=False, seg_cols=32)
    _eq(banded_cuda.semi_ends_cuda(q, ql, t, tl, free_target_prefix=False),
        banded.semi_ends_myers(q, ql, t, tl, free_target_prefix=False).numpy())


# ---------------------------------------------------------------------------
# the wrappers' routes and the segment plan
# ---------------------------------------------------------------------------
def test_routes_and_their_arguments():
    """The warp route takes up to WARP_MAX_WORDS words (k <= 8,191 in K5,
    Lq <= 16,384 in K6), "auto" takes the wide route past that; bad routes
    and segment sizes are refused before any dispatch; on CPU tensors both
    routes give the twin's output and count no launch."""
    assert banded_cuda._warp_route(-(-(2 * 8191 + 1) // 32), "auto")
    assert not banded_cuda._warp_route(-(-(2 * 8192 + 1) // 32), "auto")
    assert banded_cuda._warp_route(-(-16384 // 32), "auto")
    assert not banded_cuda._warp_route(-(-16385 // 32), "auto")
    assert not banded_cuda._warp_route(4, "wide")
    with pytest.raises(ValueError):
        banded_cuda._warp_route(513, "warp")
    with pytest.raises(ValueError):
        banded_cuda._warp_route(4, "block")
    assert [banded._lane_words(W, None) for W in (1, 32, 33, 288, 289, 512)] == [1, 1, 2, 9, 10, 16]
    with pytest.raises(ValueError):
        banded._lane_words(33, 1)
    q, ql, t, tl = _t(*_codes(8, 4, 64, 70))
    with pytest.raises(ValueError):
        banded_cuda.semi_ends_cuda(q, ql, t, tl, seg_cols=48)
    with pytest.raises(ValueError):
        banded_cuda.banded_myers_cuda(q, ql, t, tl, k=9, route="block")
    counts = lambda: (banded_cuda.banded_myers_cuda.launches,  # noqa: E731
                      banded_cuda.banded_myers_cuda.launches_wide,
                      banded_cuda.semi_ends_cuda.launches, banded_cuda.semi_ends_cuda.launches_wide)
    before = counts()
    want5 = banded.banded_final_column_myers(q, ql, t, tl, k=9).numpy()
    want6 = banded.semi_ends_myers(q, ql, t, tl).numpy()
    for route in ("warp", "wide"):
        _eq(banded_cuda.banded_myers_cuda(q, ql, t, tl, k=9, route=route), want5)
        _eq(banded_cuda.semi_ends_cuda(q, ql, t, tl, route=route), want6)
    _eq(banded_cuda.semi_ends_cuda(q, ql, t, tl, seg_cols=32), want6)
    assert counts() == before


@pytest.mark.parametrize("P,Lq,Lt", [(1, 4096, 1 << 20), (1, 4096, 2048), (3, 700, 50_000),
                                     (1, 32, 10_000), (2000, 100, 10_000), (1, 1, 33)])
@pytest.mark.parametrize("sms,resident", [(132, 64), (132, 16), (132, 4), (20, 8)])
def test_segment_plan(P, Lq, Lt, sms, resident):
    """The plan's invariants: S a multiple of 32 covering Lt in nseg
    segments with no empty one; no more warps than the card runs at a
    column's pace; segments only where S + 2 Lq < Lt, so that a segment's
    column chain is shorter than the whole target's."""
    nseg, S = banded_cuda.segment_plan(P, Lq, Lt, sms, resident)
    if nseg == 1:
        assert S == Lt
        return
    assert S % 32 == 0 and nseg * S >= Lt > (nseg - 1) * S
    assert P * nseg <= sms * min(banded_cuda.SEG_WARPS_PER_SM, resident)
    assert S + 2 * Lq < Lt


def test_segment_plan_cases():
    """A 4 kbp query against 1 Mbp on 132 SMs fills the card's warps; many
    pairs or a short target take one warp a pair."""
    full = 132 * banded_cuda.SEG_WARPS_PER_SM
    nseg, S = banded_cuda.segment_plan(1, 4096, 1 << 20, 132, 64)
    assert full // 2 < nseg <= full and S == -(-(1 << 20) // (32 * full)) * 32
    assert banded_cuda.segment_plan(full, 4096, 1 << 20, 132, 64) == (1, 1 << 20)
    assert banded_cuda.segment_plan(1, 4096, 2048, 132, 64) == (1, 2048)
    assert banded_cuda.segment_plan(1, 4096, 8000, 132, 64) == (1, 8000)  # 32 + 8192 > 8000
