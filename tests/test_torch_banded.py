"""The DP scans and the banded-kernel twins of the PyTorch port
(stringdecomposer_tpu_torch.ops.align / ops.banded / ops.banded_cuda)
against the JAX package on the same NumPy inputs: the six lax.scan
primitives of stringdecomposer_tpu.ops.align, and the Pallas kernels K4, K5
and K6 of ops/banded_pallas.py run by the Pallas interpreter on the CPU.
Every output is an integer array and must be equal on every lane
(tolerance 0)."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import align as jax_align
from stringdecomposer_tpu.ops import banded_pallas as bp
from stringdecomposer_tpu_torch.ops import align, banded, banded_cuda

torch.set_num_threads(1)

BIG = 1 << 28


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _lens(rng, P, Lq, Lt):
    """Ragged lengths: pair 0 at full width, pair 1 with an empty query,
    pair 2 with an empty target."""
    ql = rng.integers(0, Lq + 1, P).astype(np.int32)
    tl = rng.integers(0, Lt + 1, P).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    ql[1], tl[2] = 0, 0
    return ql, tl


def _problem(seed, encoding, P=5, Lq=96, Lt=112):
    """(q, ql, t, tl, use_mask, eq_flat) in one of the three encodings the
    scans take: plain codes, equality bitmasks (mask) or the lut gather."""
    rng = np.random.default_rng(seed)
    ql, tl = _lens(rng, P, Lq, Lt)
    if encoding == "plain":
        q = rng.integers(0, 4, (P, Lq)).astype(np.int32)
        t = rng.integers(0, 4, (P, Lt)).astype(np.int32)
        return q, ql, t, tl, False, None
    if encoding == "mask":  # 7 symbols, 2 bits set per query row
        q = ((1 << rng.integers(0, 7, (P, Lq))) | (1 << rng.integers(0, 7, (P, Lq))))
        t = rng.integers(0, 7, (P, Lt))
        return q.astype(np.int32), ql, t.astype(np.int32), tl, True, None
    syms = np.arange(40, 80, dtype=np.uint8)  # 40 symbols: the lut mode
    qr = rng.choice(syms, (P, Lq))
    tr = rng.choice(syms, (P, Lt))
    enc = jax_align._equality_encoding([qr.ravel(), tr.ravel()], [("(", "P"), ("*", "+")])
    assert enc.mode == "lut"
    return enc.q_lut[qr], ql, enc.t_lut[tr], tl, True, enc.eq_flat


def _jax_kw(use_mask, eq_flat):
    return dict(use_mask=use_mask, eq_flat=None if eq_flat is None else np.asarray(eq_flat))


def _torch_kw(use_mask, eq_flat):
    return dict(use_mask=use_mask, eq_flat=None if eq_flat is None else _t(eq_flat)[0])


def _eq(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, dtype=np.int64)
    want = np.asarray(want, dtype=np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


ENCODINGS = ["plain", "mask", "lut"]


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_equality_encoding_matches_jax(encoding):
    rng = np.random.default_rng(1)
    syms = np.arange(65, 65 + (6 if encoding == "mask" else 45), dtype=np.uint8)
    codes = [rng.choice(syms, 50) for _ in range(3)]
    pairs = [("A", "B"), (67, 68)]
    want = jax_align._equality_encoding(codes, pairs)
    got = align._equality_encoding(codes, pairs)
    assert got.mode == want.mode
    _eq(got.q_lut, want.q_lut)
    _eq(got.t_lut, want.t_lut)
    assert (got.eq_flat is None) == (want.eq_flat is None)
    if want.eq_flat is not None:
        _eq(got.eq_flat, want.eq_flat)


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("free_target_prefix", [False, True])
def test_dp_lastrow_batch(encoding, free_target_prefix):
    q, ql, t, tl, use_mask, eq_flat = _problem(10, encoding)
    want = jax_align.dp_lastrow_batch(q, ql, t, tl, free_target_prefix=free_target_prefix,
                                      **_jax_kw(use_mask, eq_flat))
    got = align.dp_lastrow_batch(*_t(q, ql, t, tl), free_target_prefix=free_target_prefix,
                                 **_torch_kw(use_mask, eq_flat))
    _eq(got, want)


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("k", [0, 3, 20])
def test_dp_banded_nw_and_lastrow_batch(encoding, k):
    q, ql, t, tl, use_mask, eq_flat = _problem(11 + k, encoding)
    for jf, tf in ((jax_align.dp_banded_nw_batch, align.dp_banded_nw_batch),
                   (jax_align.dp_banded_lastrow_batch, align.dp_banded_lastrow_batch),
                   (jax_align.dp_banded_shw_rows, align.dp_banded_shw_rows)):
        want = jf(q, ql, t, tl, k=k, **_jax_kw(use_mask, eq_flat))
        got = tf(*_t(q, ql, t, tl), k=k, **_torch_kw(use_mask, eq_flat))
        _eq(got, want)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_dp_hw_chunk_batch(encoding):
    """Two chained chunks: the carried column, the end rows and the
    watermark, with chunk lengths that stop inside the chunk."""
    q, ql, t, tl, use_mask, eq_flat = _problem(12, encoding, Lt=80)
    R = q.shape[1]
    base = np.arange(R + 1, dtype=np.int32)[None, :]
    c_jax = c_pt = np.where(base <= ql[:, None], base, BIG).astype(np.int32)
    for j0 in (0, 40):
        tlc = np.clip(tl - j0, 0, 40).astype(np.int32)
        want = jax_align.dp_hw_chunk_batch(q, ql, c_jax, t[:, j0:j0 + 40], tlc, np.int32(6),
                                           **_jax_kw(use_mask, eq_flat))
        got = align.dp_hw_chunk_batch(*_t(q, ql, c_pt, t[:, j0:j0 + 40], tlc), 6,
                                      **_torch_kw(use_mask, eq_flat))
        for g, w in zip(got, want):
            _eq(g, w)
        c_jax, c_pt = np.asarray(want[0]), got[0].numpy()


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_dp_moves_batch(encoding):
    q, ql, t, tl, use_mask, eq_flat = _problem(13, encoding, Lq=40, Lt=48)
    want = jax_align.dp_moves_batch(q, ql, t, tl, **_jax_kw(use_mask, eq_flat))
    got = align.dp_moves_batch(*_t(q, ql, t, tl), **_torch_kw(use_mask, eq_flat))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


# ---------------------------------------------------------------------------
# the twins of K4, K5 and K6 against the Pallas kernels, run interpreted
# ---------------------------------------------------------------------------
def _codes(seed, P=4, Lq=256, Lt=256, alpha=4):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alpha, (P, Lq)).astype(np.int32)
    t = rng.integers(0, alpha, (P, Lt)).astype(np.int32)
    ql, tl = _lens(rng, P, Lq, Lt)
    return q, ql, t, tl


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 8), (2, 33), (3, 64)])
def test_k4_twin_matches_pallas(seed, k):
    q, ql, t, tl = _codes(seed)
    want = bp.banded_final_column_pallas(q, ql, t, tl, k=k)
    _eq(banded.banded_final_column(*_t(q, ql, t, tl), k=k), want)


@pytest.mark.parametrize("k", [2, 33])
def test_k4_twin_matches_pallas_mask_mode(k):
    q, ql, t, tl, _, _ = _problem(20 + k, "mask", P=4, Lq=256, Lt=256)
    want = bp.banded_final_column_pallas(q, ql, t, tl, k=k, use_mask=True)
    _eq(banded.banded_final_column(*_t(q, ql, t, tl), k=k, use_mask=True), want)


@pytest.mark.parametrize("seed,k", [(4, 1), (5, 8), (6, 31), (7, 40), (8, 100)])
def test_k5_twin_matches_pallas_every_lane(seed, k):
    """Bit-equal on every lane, > k lanes included; the last seed runs the
    compact codes of the router (q-only symbols -9, t-only -1)."""
    q, ql, t, tl = _codes(seed, alpha=5 if seed == 8 else 4)
    if seed == 8:  # symbol 4 only in q, 5 only in t
        q, t = align._myers_compact_alphabet(q, ql, np.where(t == 4, 5, t), tl)
        assert (q == -9).any() and (t == -1).any()
    want = bp.banded_final_column_myers(q, ql, t, tl, k=k)
    _eq(banded.banded_final_column_myers(*_t(q, ql, t, tl), k=k), want)


@pytest.mark.parametrize("seed", [9, 10])
def test_k5_twin_contract_vs_scan(seed):
    """Exact wherever the banded scan's value is <= k, >= it elsewhere."""
    rng = np.random.default_rng(seed)
    for k in (1, 8, 31, 100):
        q, ql, t, tl = _codes(int(rng.integers(1 << 30)), Lq=200, Lt=220)
        want = banded.banded_final_column(*_t(q, ql, t, tl), k=k).numpy()
        got = banded.banded_final_column_myers(*_t(q, ql, t, tl), k=k).numpy()
        assert np.all((want == got) | (want > k)), k
        assert np.all((got >= want) | (want >= BIG)), k


@pytest.mark.parametrize("Lq", [1, 31, 33, 100])
@pytest.mark.parametrize("free_target_prefix", [True, False])
def test_k6_twin_matches_pallas(Lq, free_target_prefix):
    q, ql, t, tl = _codes(30 + Lq, Lq=Lq, Lt=200)
    want = bp.semi_ends_myers(q, ql, t, tl, free_target_prefix=free_target_prefix)
    got = banded.semi_ends_myers(*_t(q, ql, t, tl), free_target_prefix=free_target_prefix)
    _eq(got, want)


def test_wrappers_run_the_twins_on_cpu_tensors():
    """On CPU tensors each wrapper returns its twin's output and counts no
    launch (a launch is counted only where a kernel runs)."""
    q, ql, t, tl = _t(*_codes(40, Lq=64, Lt=70))
    before = (banded_cuda.banded_final_column_cuda.launches,
              banded_cuda.banded_myers_cuda.launches, banded_cuda.semi_ends_cuda.launches)
    _eq(banded_cuda.banded_final_column_cuda(q, ql, t, tl, k=5),
        banded.banded_final_column(q, ql, t, tl, k=5).numpy())
    _eq(banded_cuda.banded_myers_cuda(q, ql, t, tl, k=9),
        banded.banded_final_column_myers(q, ql, t, tl, k=9).numpy())
    _eq(banded_cuda.semi_ends_cuda(q, ql, t, tl, free_target_prefix=False),
        banded.semi_ends_myers(q, ql, t, tl, free_target_prefix=False).numpy())
    after = (banded_cuda.banded_final_column_cuda.launches,
             banded_cuda.banded_myers_cuda.launches, banded_cuda.semi_ends_cuda.launches)
    assert before == after


def test_layout_covers_every_item():
    """The wide routes' stages a band (threads a block): whole warps, at
    most WIDE_MAX_STAGES, every row (K4) or word (K5) a pair can hold owned
    by one band of stages or, where the route says a pair may pass one
    band, by bands of them with the top links allocated."""
    from stringdecomposer_tpu_torch.ops.hw_filter import WIDE_MAX_STAGES, WIDE_R

    for n in (1, 31, 32, 33, 1000, 1024, 1025, 8193, 80001):
        for Lq, Lt, k in ((n, n, 256), (n, 1, 1), (1, n, 300), (n, 2 * n, 8192)):
            T, seams, cs = banded.banded_wide_shape(Lq, Lt, k)
            assert T % 32 == 0 and 32 <= T <= WIDE_MAX_STAGES
            assert T * banded.WIDE4_R * (seams + 1) >= min(Lq, Lt + k) + 1
            assert 1 <= cs <= banded.K4_CLUSTER_MAX
            T, tall = banded.myers_wide_stages(Lq, Lt, k)
            assert T % 32 == 0 and 32 <= T <= WIDE_MAX_STAGES
            assert tall or T * WIDE_R >= min(Lq + k, Lt + 2 * k) // 32 + 1


def test_route_gates():
    assert not banded.supported(4, 100, 0, 8, None)  # empty target
    assert not banded.supported(4, 100, 100, 8, np.zeros(4))  # lut mode
    assert banded.supported(4096, 100000, 100000, 60000, None)  # no VMEM limit here
    assert not banded.myers_supported(100, banded.MYERS_MIN_K - 1, None, False)
    assert banded.myers_supported(100, banded.MYERS_MIN_K, None, False)
    assert not banded.myers_supported(100, 1000, None, True)  # equality bitmasks
    assert not banded.semi_supported(4, 0, None, False)
    assert banded.semi_supported(4, 1 << 20, None, False)
