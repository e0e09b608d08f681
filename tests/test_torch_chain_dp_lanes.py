"""K1's lanes body, as its plain mirror ops/chain_dp.sweep_lanes splits a
position: cells a lane owns contiguously, an in-lane pair prefix, one pair
scan over the 32 lane totals, the payload from the candidate before the
fold. Held equal (tolerance 0) to the port's twin `sweep` for every cells
per lane C = 1..8, in int32 and int16 state, and to the JAX package's
chain_dp_forward on the reference fixtures; plus the rule that picks the
kernel body on the card."""

import json
import pathlib

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement, encode, pad_monomers
from stringdecomposer_tpu.ops import chain_dp as jax_chain_dp
from stringdecomposer_tpu.ops.oracle import make_windows
from stringdecomposer_tpu_torch.ops import chain_dp as plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
N_CASES = sum(len(json.loads((FIXTURES / n).read_text()))
              for n in ("random_cases.json", "random_cases_b.json"))
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


def _sweeps(windows, mono, lens, sc, C, dt):
    mono_b, lens_b = plain.broadcast_monomers(mono, lens, windows.shape[0])
    dp0 = plain.init_column(windows, mono_b, lens_b, sc[1], sc[2], sc[3], dt)
    want = plain.sweep(windows, mono_b, lens_b, dp0, *sc)
    got = plain.sweep_lanes(windows, mono_b, lens_b, dp0, *sc, cells_per_lane=C)
    return got, want


def _equal(got, want):
    for name, g, w in zip(("chain", "end", "spend"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("dt", [torch.int32, torch.int16], ids=["int32", "int16"])
@pytest.mark.parametrize("C", range(1, 9))
def test_sweep_lanes_matches_sweep(C, dt):
    """Rows of 32*C, 32*C - 3 (n not a multiple of C, the last lanes partly
    or wholly past n) and a quarter of that; a two-letter alphabet and
    short monomers (many ties); rows of length 0 in the per-window [B, M, L]
    form; four scorings; W = 1."""
    rng = np.random.default_rng(100 + C)
    for j, L in enumerate(sorted({32 * C, max(1, 32 * C - 3), max(1, 8 * C)})):
        for alpha, zero_rows, W in ((2, 2, 40), (4, 0, 30), (2, 1, 1)):
            sc = SCORINGS[(j + alpha) % len(SCORINGS)]
            args = _problem(rng, 3, W, 5, L, alpha, zero_rows)
            _equal(*_sweeps(args[0], args[2], args[3], sc, C, dt))


@pytest.mark.parametrize("C", [1, 3, 8])
def test_sweep_lanes_short_monomers_shared_form(C):
    """[M, L] monomers of 1-4 letters over a two-letter alphabet, with a row
    padded far past its length: the deletion chain ties at nearly every
    cell and crosses lane boundaries."""
    rng = np.random.default_rng(7 * C)
    win, _, _, _ = _problem(rng, 2, 60, 1, 4, 2)
    L = 32 * C
    mono = np.full((6, L), 5, dtype=np.int8)
    lens = np.array([1, 2, 3, 4, 1, 2], dtype=np.int32)
    for m, n in enumerate(lens):
        mono[m, :n] = rng.integers(0, 2, n)
    for sc in SCORINGS:
        for dt in (torch.int32, torch.int16):
            _equal(*_sweeps(win, torch.from_numpy(mono), torch.from_numpy(lens), sc, C, dt))


def test_sweep_lanes_refuses_rows_it_cannot_cover():
    args = _problem(np.random.default_rng(0), 1, 5, 2, 40, 4, per_window=False)
    with pytest.raises(ValueError, match="do not cover"):
        _sweeps(args[0], args[2], args[3], SCORINGS[0], 1, torch.int32)


def _mono(records):
    monos = add_reverse_complement(records)
    return pad_monomers(monos, pad_to=(max(len(m.seq) for m in monos) + 7) // 8 * 8)


@pytest.mark.parametrize("idx", range(N_CASES))
def test_sweep_lanes_matches_jax_on_fixtures(random_cases, idx):
    """All windows of one reference fixture in one batch, at the C the card
    takes (ceil(L / 32)): chain, end and spend equal the JAX package's debug
    arrays, and the walk over them gives its blocks and counts."""
    case = random_cases[idx]
    mono, lens = _mono([Record(n, s) for n, s in case["monomers"]])
    reads = case.get("reads") or [["read0", case["read"]]]
    wins = [encode(seq[o : o + n]) for _, seq in reads
            for o, n in make_windows(len(seq), case["part_size"], case["overlap"])]
    wb, wl = plain.build_window_batch(wins, max(len(w) for w in wins))
    sc = tuple(case["scoring"])
    kw = dict(ins=sc[0], dele=sc[1], mismatch=sc[2], match=sc[3], return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(wb, wl, mono, lens, **kw)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (wb, wl, mono, lens)]
    C = -(-mono.shape[1] // 32)
    got, _ = _sweeps(t[0], t[2], t[3], sc, C, torch.int32)
    for g, j in zip(got, jdbg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    blocks, counts = plain.block_walk(got[1], got[2], t[1], wb.shape[1])
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


def test_kernel_body_rule():
    """The shared route runs the lanes body at L <= 512 and the tiled body
    above; the large route runs the cluster body at L <= 512 where a cluster
    of up to 16 blocks holds the rows, the tiled cluster body above, past 16
    blocks the grid route ("grid": 1,400 int16 rows of 512 bp, 2,100 int32
    rows of 192 bp); int16's wider shared route takes the lanes body too. A
    pure function of (M, L, state bytes)."""
    body = chain_dp_cuda.body
    assert chain_dp_cuda.LANES_MAX_L == 512
    for M, L, sb, want in ((24, 192, 4, "lanes"), (1, 1, 4, "lanes"), (32, 256, 4, "lanes"),
                           (33, 40, 4, "lanes"), (133, 192, 4, "lanes"), (134, 192, 4, "cluster"),
                           (264, 192, 4, "cluster"), (240, 192, 2, "lanes"),
                           (241, 192, 2, "cluster"), (24, 264, 4, "lanes"),
                           (20, 320, 2, "lanes"), (24, 360, 4, "lanes"), (50, 512, 4, "lanes"),
                           (24, 513, 4, "tiled"), (24, 528, 2, "tiled"),
                           (2905, 8, 4, "lanes"), (2906, 8, 4, "cluster"),
                           (90, 320, 4, "cluster"), (264, 360, 4, "cluster"),
                           (150, 360, 4, "cluster"), (150, 360, 2, "cluster"),
                           (51, 512, 4, "cluster"), (150, 528, 4, "cluster_tiled"),
                           (1400, 512, 2, "grid"), (2000, 192, 4, "cluster"),
                           (2100, 192, 4, "grid")):
        assert body(M, L, sb) == want, (M, L, sb)
        assert (want in ("cluster", "cluster_tiled", "grid")) == \
            (chain_dp_cuda.route(M, L, sb) == "large")
        assert body(M, L, sb) == body(M, L, sb)


def test_cpu_dispatch_counts_no_lanes_launch():
    fn = chain_dp_cuda.chain_dp_forward_cuda
    names = ("launches_lanes", "launches_lanes_int16", "launches_lanes_long",
             "launches_lanes_long_int16", "launches", "launches_int16")
    before = [getattr(fn, n) for n in names]
    for L in (24, 300):
        args = _problem(np.random.default_rng(3), 2, 30, 3, L, 4, per_window=False)
        for dt in ("int32", "int16"):
            got = fn(*args, state_dtype=dt, return_debug=True)
            want = plain.chain_dp_forward(*args, state_dtype=dt, return_debug=True)
            for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
                assert torch.equal(g, w)
    assert [getattr(fn, n) for n in names] == before
