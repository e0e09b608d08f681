"""K1's tiled bodies past L = 512 (csrc/chain_dp_tiled.cu), as their plain
mirrors ops/chain_dp.sweep_tiled and sweep_cluster (with warps_per_row)
split a position: each row over G warps of 32 lanes x C cells, the cells
walked in register tiles, a warp carry between the warps of a row, and the
lazy fix-up (each lane's carry applied when a cell is next read). Held equal
(tolerance 0) to the port's twin `sweep` for C = 17..40 at 1-16 warps a row,
in int32 and int16 state, and to the JAX package's chain_dp_forward (its
lax.scan twin on the CPU) on the DXZ1 trimers (L = 528) and the DXZ1 HOR
unit (L = 2,056); plus the rule that routes sets past 512 bp, the layout
and shared memory the wrapper computes as the kernel does, the
`force_body=` argument, the launch counters and the HOR unit workload."""

import pathlib
import re

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

CSRC = pathlib.Path(chain_dp_cuda.__file__).resolve().parent.parent / "csrc"
DTYPES = (torch.int32, torch.int16)
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


def _column(windows, mono, lens, sc, dt):
    mono_b, lens_b = plain.broadcast_monomers(mono, lens, windows.shape[0])
    dp0 = plain.init_column(windows, mono_b, lens_b, sc[1], sc[2], sc[3], dt)
    return mono_b, lens_b, dp0


def _equal(got, want):
    for name, g, w in zip(("chain", "end", "spend"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _cut(C, G):
    """A row width that leaves G warps of 32 lanes x C cells with a partial
    last warp and lane."""
    L = 32 * G * C - C * (G % 3) - 3 * (C % 2) - 1
    assert -(-L // (32 * C)) == G
    return L


@pytest.mark.parametrize("C", range(17, 41))
def test_sweep_tiled_matches_sweep(C):
    """C cells a lane at G = C % 16 + 1 warps a row (1..16), the row cut to
    leave a partial last warp and lane (and, at C not a multiple of 8, a
    partial last tile of the kernel's 8): int32 state at four scorings, a
    two-letter alphabet (many ties), per-window rows with one of length 0;
    int16 state at unit scores, a four-letter alphabet, shared rows, at the
    most warps that keep W + L within its range; one case in tiles of 3."""
    G = C % 16 + 1
    rng = np.random.default_rng(1700 + C)
    tile = 3 if C == 40 else 8
    for dt in DTYPES:
        if dt == torch.int32:
            sc, g, alpha, W = SCORINGS[C % len(SCORINGS)], G, 2, 36
        else:
            sc, g, alpha, W = SCORINGS[0], min(G, 7900 // (32 * C)), 4, 24
        L = _cut(C, g)
        assert dt == torch.int32 or plain.int16_sentinel_ok(W, L, *sc)
        win, _, mono, lens = _problem(rng, 2, 20 if L > 4000 else W, 3, L, alpha,
                                      zero_rows=int(dt == torch.int32),
                                      per_window=dt == torch.int32)
        mono_b, lens_b, dp0 = _column(win, mono, lens, sc, dt)
        want = plain.sweep(win, mono_b, lens_b, dp0, *sc)
        _equal(plain.sweep_tiled(win, mono_b, lens_b, dp0, *sc, cells_per_lane=C,
                                 warps_per_row=g, tile=tile), want)


# per window, the two rows' lengths at L = 1,040: a full row beside one
# that ends before the second of 2 warps of 544 cells (or the third and
# fourth of 4 warps of 288), at and just past a warp's first cell, and a
# row of length 0
SHORT_ROWS = [[1040, 300], [288, 1040], [543, 545], [864, 865], [1, 0]]


@pytest.mark.parametrize("dt", DTYPES, ids=["int32", "int16"])
@pytest.mark.parametrize("G, C", [(2, 17), (4, 9)])
def test_sweep_tiled_with_rows_that_end_before_a_warp(G, C, dt):
    """Per-window rows of mixed lengths split over G warps a row (the
    kernel's layout of 2 rows of 1,040 bp, G = 2, C = 17, and of a row a
    block, G = 4, C = 9): the warps whose segment starts at or past the
    row's end skip the position, and sweep_tiled still equals the twin's
    sweep, as does sweep_cluster at 2 slices of one row."""
    L = 1040
    assert chain_dp_cuda.tiled_layout(2 if G == 2 else 1, L)[:2] == (G, C)
    rng = np.random.default_rng(1040 + G)
    win, _, mono, lens = _problem(rng, len(SHORT_ROWS), 30, 2, L, 4)
    lens = torch.tensor(SHORT_ROWS, dtype=torch.int32)
    mono[torch.arange(L)[None, None, :] >= lens[..., None]] = 5
    sc = SCORINGS[1] if dt == torch.int32 else SCORINGS[0]
    mono_b, lens_b, dp0 = _column(win, mono, lens, sc, dt)
    want = plain.sweep(win, mono_b, lens_b, dp0, *sc)
    _equal(plain.sweep_tiled(win, mono_b, lens_b, dp0, *sc, cells_per_lane=C,
                             warps_per_row=G), want)
    if G == 4:
        _equal(plain.sweep_cluster(win, mono_b, lens_b, dp0, *sc, cluster_size=2,
                                   cells_per_lane=C, warps_per_row=G), want)


@pytest.mark.parametrize("cs, C, G", [(2, 17, 1), (3, 6, 4), (5, 3, 11)])
def test_sweep_cluster_tiled_matches_sweep(cs, C, G):
    """The tiled cluster body's split: M = 2 cs - 1 rows over cs slices (the
    last holding one), each slice's rows as the tiled body steps them, in
    int32 and int16, rows of length 0 in the last slice."""
    rng = np.random.default_rng(600 + cs)
    L = 32 * G * C - 5
    for j, dt in enumerate(DTYPES):
        sc = SCORINGS[cs % len(SCORINGS)] if j == 0 else SCORINGS[0]
        win, _, mono, lens = _problem(rng, 2, 30, 2 * cs - 1, L, 2 + 2 * j, zero_rows=1)
        mono_b, lens_b, dp0 = _column(win, mono, lens, sc, dt)
        want = plain.sweep(win, mono_b, lens_b, dp0, *sc)
        _equal(plain.sweep_cluster(win, mono_b, lens_b, dp0, *sc, cluster_size=cs,
                                   cells_per_lane=C, warps_per_row=G), want)


def _sets(test_data_dir):
    dxz1 = load_fasta(test_data_dir / "DXZ1_star_monomers.fa")
    return {"trimers": (workloads.joined_set(dxz1, 3), 528),
            "hor_unit": (workloads.hor_unit(dxz1), 2056)}


@pytest.fixture(scope="module", params=["trimers", "hor_unit"])
def jax_case(request, test_data_dir):
    """The DXZ1 trimers (M = 24, L = 528) or the DXZ1 HOR unit (M = 2, L =
    2,056) with RC against 3 windows of the golden read (700, 610 and 420
    bp), with the JAX package's outputs on them."""
    records, L = _sets(test_data_dir)[request.param]
    mono, lens = pad_monomers(add_reverse_complement(records), pad_to=L)
    read = load_fasta(test_data_dir / "read.fa")[0].seq
    wins = [encode(read[o : o + n]) for o, n in make_windows(len(read), 5000, 500)[:3]]
    wins = [w[:n] for w, n in zip(wins, (700, 610, 420))]
    wb, wl = plain.build_window_batch(wins, 700)
    kw = dict(ins=-1, dele=-1, mismatch=-1, match=1, max_blocks=1, return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(wb, wl, mono, lens, **kw)
    jax_out = [np.asarray(x) for x in (jb, jc, *jdbg)]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (wb, wl, mono, lens)]
    return request.param, args, kw, jax_out


@pytest.mark.parametrize("dt", DTYPES, ids=["int32", "int16"])
@pytest.mark.parametrize("mirror", ["tiled", "cluster"])
def test_joined_sets_match_jax(jax_case, mirror, dt):
    """sweep_tiled at the kernel's layout for the whole set (the trimers: G
    = 1, C = 17; the HOR unit: G = 2 warps a row, C = 33), and sweep_cluster
    at a plan's split (the trimers: 4 slices of 6 rows, G = 1; the HOR unit:
    one row a slice, G = 4, C = 17), equal the JAX package's chain, end and
    spend (every row is real, so the int16 state's values equal int32's),
    and the walk over them gives its blocks and counts (the trimers'
    overflowing max_blocks = 1)."""
    name, args, kw, (jb, jc, jchain, jend, jspend) = jax_case
    M, L = args[2].shape
    sc = (-1, -1, -1, 1)
    mono_b, lens_b, dp0 = _column(args[0], args[2], args[3], sc, dt)
    if mirror == "tiled":
        G, C, _ = chain_dp_cuda.tiled_layout(M, L)
        assert (G, C) == ((1, 17) if name == "trimers" else (2, 33))
        got = plain.sweep_tiled(args[0], mono_b, lens_b, dp0, *sc, cells_per_lane=C,
                                warps_per_row=G)
    else:
        cs = 4 if name == "trimers" else 2
        G, C, _ = chain_dp_cuda.tiled_layout(-(-M // cs), L)
        assert (G, C) == ((1, 17) if name == "trimers" else (4, 17))
        got = plain.sweep_cluster(args[0], mono_b, lens_b, dp0, *sc, cluster_size=cs,
                                  cells_per_lane=C, warps_per_row=G)
    for g, j in zip(got, (jchain, jend, jspend)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), j)
    blocks, counts = plain.block_walk(got[1], got[2], args[1], kw["max_blocks"])
    np.testing.assert_array_equal(blocks.numpy(), jb)
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert name == "hor_unit" or jc.max() > kw["max_blocks"]


def _counters():
    return {(fn.__name__, k): v for fn in (chain_dp_cuda.chain_dp_forward_cuda,
                                           chain_dp_cuda.chain_dp_large_cuda)
            for k, v in vars(fn).items() if k.startswith("launches")}


@pytest.mark.parametrize("body, M, L", [("tiled", 24, 528), ("tiled", 2, 2056),
                                        ("cluster_tiled", 25, 1000), ("split", 1, 25800)])
def test_cpu_dispatch_of_long_rows_matches_jax(body, M, L):
    """The port's CPU dispatch of sets the rule sends to each body past 512
    (the split form takes a row the tiled form cannot hold in one block;
    a shared-route set whose padded rows do not fit one block takes the
    tiled cluster body) equals the JAX package, in int32 and int16 where
    admitted, launching nothing; `force_body=` names the same body."""
    rng = np.random.default_rng(M + L)
    W = 6 if L > 5000 else 40
    win, wl, mono, lens = _problem(rng, 2, W, M, L, 4, per_window=False)
    assert chain_dp_cuda.body(M, L) == body
    kw = dict(ins=-1, dele=-1, mismatch=-1, match=1, return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(*(a.numpy() for a in (win, wl, mono, lens)), **kw)
    want = [np.asarray(x) for x in (jb, jc, *jdbg)]
    counters = _counters()
    for state in ("int32", "int16") if W + L < 8191 else ("int32",):
        for forced in (None, body):
            b, c, dbg = chain_dp_cuda.chain_dp_forward_cuda(win, wl, mono, lens,
                                                            state_dtype=state,
                                                            force_body=forced, **kw)
            for g, j in zip((b, c, *dbg), want):
                np.testing.assert_array_equal(g.numpy(), j)
    assert _counters() == counters


def test_body_argument_is_checked():
    """`force_body=` runs the named body only where it takes the set, on
    any device; a body of the other route goes to chain_dp_large_cuda, an
    unknown one is refused, and the tiled cluster body takes only rows past
    512 bp."""
    rng = np.random.default_rng(9)
    win, wl, mono, lens = _problem(rng, 1, 8, 3, 600, 4, per_window=False)
    fwd, large = chain_dp_cuda.chain_dp_forward_cuda, chain_dp_cuda.chain_dp_large_cuda
    for fn, body, match in ((fwd, "lanes", "cannot take"), (large, "cluster", "L <= 512"),
                            (fwd, "sideways", "unknown K1 body"), (large, "tiled", "large route")):
        with pytest.raises(ValueError, match=match):
            fn(win, wl, mono, lens, force_body=body)
    with pytest.raises(ValueError, match="no cluster_size"):
        large(win, wl, mono, lens, force_body="large", cluster_size=2)
    with pytest.raises(ValueError, match="takes L > 512"):
        large(win, wl, mono[:, :512], lens.clamp(max=512), force_body="cluster_tiled")
    big = torch.nn.functional.pad(mono, (0, 26000 - 600), value=5)  # a row past one block
    with pytest.raises(ValueError, match="cannot take"):
        fwd(win, wl, big[:1], lens[:1], force_body="tiled")
    with pytest.raises(ValueError, match="cannot take"):
        large(win, wl, big[:2], lens[:2], force_body="cluster_tiled")
    want = plain.chain_dp_forward(win, wl, mono, lens, return_debug=True)
    for fn, body in ((fwd, "chunked"), (fwd, "tiled"), (fwd, "cluster_tiled"), (large, "large"),
                     (large, "cluster_tiled")):
        got = fn(win, wl, mono, lens, force_body=body, return_debug=True)
        for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
            assert torch.equal(g, w), (fn.__name__, body)


@pytest.mark.parametrize("M, L, sb, shared, want", [
    (24, 528, 4, True, "tiled"), (24, 528, 2, True, "tiled"), (2, 2056, 4, True, "tiled"),
    (2, 2056, 2, True, "tiled"), (150, 528, 4, False, "cluster_tiled"),
    (150, 528, 2, False, "cluster_tiled"), (2, 17136, 4, False, "cluster_tiled"),
    (2, 17136, 2, True, "tiled"), (25, 1000, 4, True, "cluster_tiled"),
    (1, 25000, 4, True, "tiled"), (1, 25800, 4, True, "split"), (2, 26000, 4, False, "split"),
    (800, 528, 4, False, "grid_tiled"), (1400, 528, 2, False, "grid_tiled"),
    (688, 528, 4, False, "cluster_tiled"), (1100, 528, 2, False, "cluster_tiled"),
])
def test_body_rule_past_512(M, L, sb, shared, want):
    """Past L = 512 the shared route runs the tiled body where its form fits
    one block; else the tiled cluster body where a cluster of up to 16
    blocks holds the rows (the large route, and shared-route sets whose
    padded rows do not fit one block, M = 25 at L = 1,000); past that the
    grid routes: a row the tiled form cannot hold in one block goes to the
    split form (M = 1, L = 25,800 on the shared route; 26,000 on the large
    one), more rows than 16 blocks hold to the grid route's tiled form (rows
    of 528 bp: 688 int32 rows fit a cluster, 800 do not; 1,100 int16 rows
    fit, 1,400 do not)."""
    assert chain_dp_cuda.body(M, L, sb) == want
    assert (chain_dp_cuda.route(M, L, sb) == "shared") == shared
    plan = chain_dp_cuda.cluster_plan(M, L, sb)
    assert (plan is None) == (want in ("grid_tiled", "split", "chunked", "large"))
    if want in ("grid_tiled", "split"):
        assert chain_dp_cuda.grid_body(chain_dp_cuda.grid_plan(M, L, sb)[4]) == want
    if plan is not None:
        assert plan[2] == "tiled" and plan[1:] == chain_dp_cuda.cluster_shape(M, L, sb, plan[0])


@pytest.mark.parametrize("sb", [4, 2], ids=["int32", "int16"])
def test_tiled_layout_and_shape_invariants(sb):
    """Every tiled shape: G warps of 32 lanes x C cells cover L with no
    whole warp to spare, at most 32 warps a block (at most floor(32 / R) a
    row below 32 rows, one a row in turn from 32), the shared memory of the
    kernel's
    formula within 232,448 bytes, at least one row a block; the cluster plan
    past 512 is the tiled form's, with the fewest waves x the blocks a wave
    puts on one of 132 SMs x a block's `tiled_issue`: at 19 windows of the
    150 trimer variants the card's measured fastest (k1_ab.py --tiled: cs =
    5, 26.6 ms, over cs = 15 and 10, 27.8 and 33.0; made-up occupancies
    here)."""
    for L in (513, 528, 700, 1000, 2056, 4100, 17136, 25000):
        for R in (1, 2, 3, 5, 13, 24, 31, 32, 33, 48, 90):
            G, C, threads = chain_dp_cuda.tiled_layout(R, L)
            assert 32 * G * C >= L > 32 * (G - 1) * C
            assert threads == 32 * min(32, R * G) and threads <= 1024
            assert (G == 1) if R >= 32 else (R * G <= 32)
        for M in (1, 2, 3, 24, 47, 90, 150, 800, 1400):
            for cs in range(1, 17):
                shape = chain_dp_cuda.cluster_shape(M, L, sb, cs)
                assert shape == chain_dp_cuda.tiled_shape(M, L, sb, cs)
                if shape is None:
                    continue
                R, form, threads, smem = shape
                assert form == "tiled" and R == -(-M // cs) and (cs - 1) * R < M
                G, C, _ = chain_dp_cuda.tiled_layout(R, L)
                assert smem == chain_dp_cuda.tiled_smem_bytes(M, R, G, C, sb) <= 232_448
    active = {2: 60, 4: 30, 5: 22, 6: 17, 8: 14, 10: 21, 15: 21}
    plan = chain_dp_cuda.cluster_plan(150, 528, 4, 19, lambda cs: active.get(cs, 0))
    R = plan[1]
    G, C, _ = chain_dp_cuda.tiled_layout(R, 528)
    assert plan[0] == 5 and (R, G, C) == (30, 1, 17)  # one wave, 30 rows a block
    # cs = 10 ties with 5 (two blocks of 15 rows an SM) and loses on blocks;
    # cs = 15 puts three blocks of 10 on an SM
    assert [chain_dp_cuda.tiled_issue(R, 1, 17) for R in (30, 15, 10)] == [4992, 2496, 1872]
    assert chain_dp_cuda.cluster_plan(2, 17136, 4, 7, lambda cs: 66)[:2] == (2, 1)


def test_constants_match_the_kernel_source():
    """The wrapper's copies of the tiled bodies' constants and formulas."""
    src = (CSRC / "chain_dp_tiled.cu").read_text()
    assert int(re.search(r"constexpr int kTiledWarps = (\d+);", src).group(1)) == \
        chain_dp_cuda.TILED_WARPS
    assert "constexpr int kTile = 8;" in src  # sweep_tiled's default tile
    assert "return 8LL * M + S * (256 + (G > 1 ? 24 : 0)) +" in src
    assert "(long long)R * (2 * state_bytes * P + 128LL * G * ((C + 3) / 4));" in src
    assert "32LL * G * C >= L && 32LL * (G - 1) * C < L && (G == 1 || R * G <= kTiledWarps)" in src


def test_hor_unit_workload(test_data_dir):
    """The DXZ1 HOR unit: the 12 monomers in file order, 2,054 bp; with RC
    M = 2 rows padded to 2,056, on the tiled body in int32 and int16 (the
    int16 state is admitted at the golden windows' W = 5,500: W + L = 7,556
    < 8,191), its rows over 2 warps of 33 cells a lane."""
    dxz1 = load_fasta(test_data_dir / "DXZ1_star_monomers.fa")
    (unit,) = workloads.hor_unit(dxz1)
    assert unit.seq == "".join(r.seq for r in dxz1) and len(unit.seq) == 2054
    assert unit.name == "+".join(r.name.split()[0] for r in dxz1)
    mono, lens = pad_monomers(add_reverse_complement([unit]), pad_to=2056)
    assert mono.shape == (2, 2056) and list(lens) == [2054, 2054]
    for sb in (4, 2):
        assert chain_dp_cuda.body(2, 2056, sb) == "tiled"
    assert plain.resolve_state_dtype("int16", 5500, 2056, -1, -1, -1, 1) == torch.int16
    assert chain_dp_cuda.tiled_layout(2, 2056)[:2] == (2, 33)


def test_tiled_counters():
    """Each tiled body counts its own launches, int16 apart, with no "_long"
    suffix; the chunked body keeps its counters on both wrappers."""
    for kind, fn in (("tiled", chain_dp_cuda.chain_dp_forward_cuda),
                     ("cluster_tiled", chain_dp_cuda.chain_dp_large_cuda)):
        for dt, suffix in ((torch.int32, ""), (torch.int16, "_int16")):
            name = chain_dp_cuda._counter(dt, kind, 17136)
            assert name == f"launches_{kind}{suffix}"
            assert isinstance(getattr(fn, name), int)
