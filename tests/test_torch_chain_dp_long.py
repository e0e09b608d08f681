"""K1's lanes and cluster bodies at monomer sets padded to 257-512 bp (C =
ceil(L / 32) = 9..16 cells a lane, two rows a warp in registers), as their
plain mirrors ops/chain_dp.sweep_lanes and sweep_cluster split a position.
Held equal (tolerance 0) to the port's twin `sweep` for every C = 9..16 in
int32 and int16 state, and at L = 360 to the JAX package's chain_dp_forward
(its lax.scan twin on the CPU); plus the rule that routes such sets, the
launch counters of the long instances and the seeded dimer / trimer sets
that chip_smoke.py and k1_ab.py drive."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.io.fasta import add_reverse_complement, encode, load_fasta, pad_monomers
from stringdecomposer_tpu.ops import chain_dp as jax_chain_dp
from stringdecomposer_tpu.ops.oracle import make_windows
from stringdecomposer_tpu_torch.ops import chain_dp as plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda
from stringdecomposer_tpu_torch.scripts import workloads

torch.set_num_threads(1)

DTYPES = pytest.mark.parametrize("dt", [torch.int32, torch.int16], ids=["int32", "int16"])
SCORINGS = ((-1, -1, -1, 1), (-2, -1, -1, 2), (-1, -2, -1, 1), (-3, -1, -2, 1))
LONG_C = range(9, 17)


def _problem(rng, B, W, M, L, alpha, zero_rows=0, per_window=True):
    """Random codes over `alpha` letters: windows [B, W] (ragged, READ_PAD
    past each length), monomers [B, M, L] (or [M, L]) with lengths drawn in
    [L / 2, L] (the first at L), the last `zero_rows` rows of length 0."""
    win = np.full((B, W), plain.READ_PAD, dtype=np.int8)
    wl = rng.integers(1, W + 1, B).astype(np.int32)
    wl[0] = W
    for b in range(B):
        win[b, : wl[b]] = rng.integers(0, alpha, wl[b])
    shape = (B, M) if per_window else (M,)
    lens = rng.integers(L // 2, L + 1, shape).astype(np.int32)
    lens[..., 0] = L
    if zero_rows:
        lens[..., -zero_rows:] = 0
    mono = np.full(shape + (L,), 5, dtype=np.int8)
    for idx in np.ndindex(*shape):
        mono[idx][: lens[idx]] = rng.integers(0, alpha, lens[idx])
    return [torch.from_numpy(a) for a in (win, wl, mono, lens)]


def _column(windows, mono, lens, sc, dt):
    mono_b, lens_b = plain.broadcast_monomers(mono, lens, windows.shape[0])
    dp0 = plain.init_column(windows, mono_b, lens_b, sc[1], sc[2], sc[3], dt)
    return mono_b, lens_b, dp0


def _equal(got, want):
    for name, g, w in zip(("chain", "end", "spend"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _lengths(C):
    """The padded widths a C covers: a full last lane (32 C), a partial one
    (32 C - 3), and whichever of 300, 360 and 512 takes this C."""
    return sorted({32 * C, 32 * C - 3} | {L for L in (300, 360, 512) if -(-L // 32) == C})


@DTYPES
@pytest.mark.parametrize("C", LONG_C)
def test_sweep_lanes_long_matches_sweep(C, dt):
    """At each width `_lengths(C)`: M <= 8 rows with ragged lengths (rows of
    length 0 in the per-window form), a two-letter alphabet (many ties) and
    a four-letter one, W <= 64, four scorings."""
    rng = np.random.default_rng(900 + C)
    for j, L in enumerate(_lengths(C)):
        for alpha, zero_rows, W, M, per_window in ((2, 2, 64, 8, True), (4, 0, 40, 5, False)):
            sc = SCORINGS[(j + alpha) % len(SCORINGS)]
            win, _, mono, lens = _problem(rng, 2, W, M, L, alpha, zero_rows, per_window)
            mono_b, lens_b, dp0 = _column(win, mono, lens, sc, dt)
            want = plain.sweep(win, mono_b, lens_b, dp0, *sc)
            _equal(plain.sweep_lanes(win, mono_b, lens_b, dp0, *sc, cells_per_lane=C), want)


@DTYPES
@pytest.mark.parametrize("C", LONG_C)
def test_sweep_cluster_long_matches_sweep(C, dt):
    """M = 7 rows over cs = 2, 3 and 4 slices (the last slice short), at the
    full and the partial width of C, per-window rows of length 0 in the last
    slice, W <= 48."""
    rng = np.random.default_rng(950 + C)
    for j, L in enumerate((32 * C, 32 * C - 3)):
        sc = SCORINGS[(j + C) % len(SCORINGS)]
        win, _, mono, lens = _problem(rng, 2, 48, 7, L, 2 + 2 * j, zero_rows=2)
        mono_b, lens_b, dp0 = _column(win, mono, lens, sc, dt)
        want = plain.sweep(win, mono_b, lens_b, dp0, *sc)
        for cs in (2, 3, 4):
            _equal(plain.sweep_cluster(win, mono_b, lens_b, dp0, *sc, cluster_size=cs,
                                       cells_per_lane=C), want)


@pytest.fixture(scope="module")
def dimer_case(test_data_dir):
    """The DXZ1 dimers with RC (workloads.joined_set, k = 2: M = 24, L =
    360, which the card runs on the lanes body at C = 12) against 3 windows
    of the golden read (700, 610 and 420 bp), with the JAX package's outputs
    on them."""
    dimers = workloads.joined_set(load_fasta(test_data_dir / "DXZ1_star_monomers.fa"), 2)
    mono, lens = pad_monomers(add_reverse_complement(dimers), pad_to=360)
    read = load_fasta(test_data_dir / "read.fa")[0].seq
    wins = [encode(read[o : o + n]) for o, n in make_windows(len(read), 5000, 500)[:3]]
    wins = [w[:n] for w, n in zip(wins, (700, 610, 420))]
    wb, wl = plain.build_window_batch(wins, 700)
    kw = dict(ins=-1, dele=-1, mismatch=-1, match=1, max_blocks=1, return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(wb, wl, mono, lens, **kw)
    jax_out = [np.asarray(x) for x in (jb, jc, *jdbg)]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (wb, wl, mono, lens)], kw, jax_out


@DTYPES
@pytest.mark.parametrize("mirror", ["lanes", "cluster"])
def test_dimers_l360_match_jax(dimer_case, mirror, dt):
    """sweep_lanes at C = 12, and sweep_cluster at 5 slices of 5 rows (the
    shape of the cluster body's plan for the 150 dimer variants, R = 30, cut
    to 24 rows), equal the JAX package's chain, end and spend (every row is
    real, so the int16 state's values equal int32's), and the walk over
    them gives its blocks and counts, max_blocks = 1 overflowing."""
    args, kw, (jb, jc, jchain, jend, jspend) = dimer_case
    assert args[2].shape == (24, 360)
    mono_b, lens_b, dp0 = _column(args[0], args[2], args[3], (-1, -1, -1, 1), dt)
    sc = (-1, -1, -1, 1)
    if mirror == "lanes":
        got = plain.sweep_lanes(args[0], mono_b, lens_b, dp0, *sc, cells_per_lane=12)
    else:
        got = plain.sweep_cluster(args[0], mono_b, lens_b, dp0, *sc, cluster_size=5,
                                  cells_per_lane=12)
    for g, j in zip(got, (jchain, jend, jspend)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), j)
    blocks, counts = plain.block_walk(got[1], got[2], args[1], kw["max_blocks"])
    np.testing.assert_array_equal(blocks.numpy(), jb)
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert jc.max() > kw["max_blocks"]


@DTYPES
@pytest.mark.parametrize("scoring", SCORINGS[:2])
def test_random_l360_matches_jax(scoring, dt):
    """Random monomers of L = 360 (M = 6, a partial last lane), the port's
    CPU dispatch of both routes and the lanes mirror at C = 12 against the
    JAX package; neither route launches anything on the CPU."""
    rng = np.random.default_rng(360)
    win, wl, mono, lens = _problem(rng, 3, 64, 6, 360, 4, per_window=False)
    kw = dict(ins=scoring[0], dele=scoring[1], mismatch=scoring[2], match=scoring[3],
              return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(*(a.numpy() for a in (win, wl, mono, lens)), **kw)
    want = [np.asarray(x) for x in (jb, jc, *jdbg)]
    counters = _counters()
    name = "int16" if dt == torch.int16 else "int32"
    for fn in (chain_dp_cuda.chain_dp_forward_cuda, chain_dp_cuda.chain_dp_large_cuda):
        b, c, dbg = fn(win, wl, mono, lens, state_dtype=name, **kw)
        for g, j in zip((b, c, *dbg), want):
            np.testing.assert_array_equal(g.numpy(), j)
    assert _counters() == counters
    mono_b, lens_b, dp0 = _column(win, mono, lens, scoring, dt)
    got = plain.sweep_lanes(win, mono_b, lens_b, dp0, *scoring, cells_per_lane=12)
    for g, j in zip(got, want[2:]):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), j)


def _counters():
    return {(fn.__name__, k): v for fn in (chain_dp_cuda.chain_dp_forward_cuda,
                                           chain_dp_cuda.chain_dp_large_cuda)
            for k, v in vars(fn).items() if k.startswith("launches")}


@pytest.mark.parametrize("kind, L, dt, want", [
    ("lanes", 192, torch.int32, "launches_lanes"),
    ("lanes", 256, torch.int16, "launches_lanes_int16"),
    ("lanes", 257, torch.int32, "launches_lanes_long"),
    ("lanes", 512, torch.int16, "launches_lanes_long_int16"),
    ("cluster", 192, torch.int32, "launches_cluster"),
    ("cluster", 360, torch.int32, "launches_cluster_long"),
    ("cluster", 360, torch.int16, "launches_cluster_long_int16"),
    ("", 360, torch.int32, "launches"),
    ("", 528, torch.int16, "launches_int16"),
    ("tiled", 528, torch.int32, "launches_tiled"),
    ("tiled", 2056, torch.int16, "launches_tiled_int16"),
    ("cluster_tiled", 528, torch.int32, "launches_cluster_tiled"),
    ("cluster_tiled", 17136, torch.int16, "launches_cluster_tiled_int16"),
])
def test_each_body_counts_its_own_launches(kind, L, dt, want):
    """The counter a launch adds to: the chunked body ("") on either route
    whatever L is, the lanes and cluster bodies with rows past LANES_LONG_L
    (C = 9..16) apart from the shorter ones, the tiled and tiled cluster
    bodies past 512 with no such suffix, int16 apart; every name is a
    counter of its route's wrapper."""
    assert chain_dp_cuda._counter(dt, kind, L) == want
    fn = (chain_dp_cuda.chain_dp_large_cuda if kind in ("cluster", "cluster_tiled") else
          chain_dp_cuda.chain_dp_forward_cuda)
    assert isinstance(getattr(fn, want), int)
    if not kind:
        assert isinstance(getattr(chain_dp_cuda.chain_dp_large_cuda, want), int)


@pytest.mark.parametrize("M, L, sb, want", [
    (24, 360, 4, (1, 24, "regs", 384, 192)),
    (17, 300, 2, (1, 17, "regs", 288, 136)),
    (80, 512, 4, (3, 27, "regs", 448, 640)),
    (150, 360, 4, (5, 30, "regs", 480, 1200)),
    (150, 360, 2, (5, 30, "regs", 480, 1200)),
    (150, 512, 4, (5, 30, "regs", 480, 1200)),
    (512, 512, 2, (16, 32, "regs", 512, 4096)),
    (1376, 512, 2, (16, 86, "rows_dense", 512, 231168)),
    (1400, 512, 2, None),
    (150, 513, 4, (13, 12, "tiled", 384, 64176)),
])
def test_cluster_plan_at_long_rows(M, L, sb, want):
    """Without the card's occupancy the plan is the smallest cluster whose
    rows fit registers: at C > 8 a warp holds two rows, so R <= 32 rows take
    ceil(R / 2) warps (the 150 dimer variants: 5 blocks of 30 rows on 15
    warps); past 16 blocks of 32 rows the rows go to shared memory, where
    8 * M + (2 * 2 + 1) * 512 * R bytes hold R = 86 rows a block of 1,376
    rows of int16 and 1,400 rows do not fit 16 blocks; past L = 512 the plan
    is the tiled cluster body's, which without the occupancy counts every
    launch as one wave of one cluster and so takes the least integer issue
    a block, ties to the fewest blocks (150 rows of 513 bp: 13 blocks of
    12, a warp a row, C = 17, the issue of 12 rows on 4 schedulers as 10's)."""
    assert chain_dp_cuda.cluster_plan(M, L, sb) == want


def test_cluster_plan_waves_at_the_dimer_variants():
    """With the card's occupancy (made-up tables: sizes left out run no
    cluster), the golden read's 19 windows of the 150 dimer variants take
    the fewest waves, every size at two rows a warp (R >= 10): cs = 5 where
    it runs 22 clusters at once (one wave, against cs = 10's three of 7);
    cs = 10 where cs = 5 runs only 2 (ten waves) and 16 runs 4 (five)."""
    active = {5: 22, 10: 7, 16: 4}
    plan = chain_dp_cuda.cluster_plan(150, 360, 4, 19, lambda cs: active.get(cs, 0))
    assert plan == (5, 30, "regs", 480, 1200)
    active[5] = 2
    plan = chain_dp_cuda.cluster_plan(150, 360, 4, 19, lambda cs: active.get(cs, 0))
    assert plan == (10, 15, "regs", 256, 1200)


def test_cluster_size_past_512_is_refused(dimer_case):
    """Past L = 512 a set takes the tiled bodies (24 rows of 520 bp the tiled
    body, 150 the tiled cluster body; 24 rows of 26,000 bp, past one block
    each, the grid route's split form); a cluster size the shared memory
    does not admit there (24 rows of 26,000 bp in 2 blocks) is refused on
    any device, never run on another body."""
    args, kw, _ = dimer_case
    assert chain_dp_cuda.body(24, 520) == "tiled" and chain_dp_cuda.body(150, 520) == "cluster_tiled"
    mono = torch.nn.functional.pad(args[2], (0, 26000 - 360), value=5)  # L = 26,000
    assert chain_dp_cuda.body(24, 26000) == "split"
    with pytest.raises(ValueError, match="not admitted"):
        chain_dp_cuda.chain_dp_large_cuda(args[0], args[1], mono, args[3], cluster_size=2, **kw)


def test_joined_sets_take_the_bodies_chip_smoke_drives(test_data_dir):
    """The seeded sets chip_smoke.py and k1_ab.py drive: the DXZ1 dimers
    (M = 24, L = 360) take the lanes body, their 150 variants the cluster
    body, the trimers (L = 528) the tiled body and their 150 variants the
    tiled cluster body, in int32 and int16; the variants of
    k = 2 and seed 0 are the same draws as before the trimers existed (a
    substituted base never equals the dimer's)."""
    dxz1 = load_fasta(test_data_dir / "DXZ1_star_monomers.fa")
    want = {(2, 24): "lanes", (2, 150): "cluster", (3, 24): "tiled", (3, 150): "cluster_tiled"}
    for k in (2, 3):
        units = workloads.joined_set(dxz1, k)
        variants = workloads.joined_variants(dxz1, k, 150, np.random.default_rng(0))
        assert len(units) == 12 and len(variants) == 75
        for j, v in enumerate(variants):
            base = units[j % 12].seq
            assert len(v.seq) == len(base)
            assert sum(a != b for a, b in zip(v.seq, base)) == len(base) // 20
        for records in (units, variants):
            monos = add_reverse_complement(records)
            L = (max(len(m.seq) for m in monos) + 7) // 8 * 8
            assert L == (360 if k == 2 else 528)
            for sb in (4, 2):
                assert chain_dp_cuda.body(len(monos), L, sb) == want[k, len(monos)]
