"""K1's grid routes (csrc/chain_dp_grid.cuh), as their plain mirror
ops/chain_dp.sweep_grid splits a position: a window's rows over K groups of
cs slices (the thread block clusters of a window), each group keeping only
its own rows' end scores and the chain score the max of the K group maxima;
and, in the split form, a row over S blocks of G warps, each warp's carry
read from the row's earlier warps' totals. Held equal (tolerance 0) to the
port's twin `sweep` and to the JAX package's chain_dp_forward, in int32 and
int16 state; plus the plan (`grid_plan`, `grid_shape`), the body rule past
one cluster, the kernel's formulas and the wrappers' CPU dispatch."""

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
DTYPES = pytest.mark.parametrize("dt", [torch.int32, torch.int16], ids=["int32", "int16"])
SCORINGS = ((-1, -1, -1, 1), (-2, -1, -1, 2), (-1, -2, -1, 1), (-3, -1, -2, 1))
_JAX: dict = {}


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


def _sweeps(args, sc, dt, **grid):
    """(sweep_grid's, sweep's) (chain, end, spend) on `args`."""
    windows, _, mono, lens = args
    mono_b, lens_b = plain.broadcast_monomers(mono, lens, windows.shape[0])
    dp0 = plain.init_column(windows, mono_b, lens_b, sc[1], sc[2], sc[3], dt)
    want = plain.sweep(windows, mono_b, lens_b, dp0, *sc)
    return plain.sweep_grid(windows, mono_b, lens_b, dp0, *sc, **grid), want


def _equal(got, want):
    for name, g, w in zip(("chain", "end", "spend"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _jax(key, args, sc):
    """The JAX package's (chain, end, spend) on `args`, once a key."""
    if key not in _JAX:
        kw = dict(ins=sc[0], dele=sc[1], mismatch=sc[2], match=sc[3], return_debug=True)
        _JAX[key] = jax_chain_dp.chain_dp_forward(*(a.numpy() for a in args), **kw)[2]
    return [np.asarray(x) for x in _JAX[key]]


def _equal_jax(got, key, args, sc):
    for g, j in zip(got, _jax(key, args, sc)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), j)


@DTYPES
@pytest.mark.parametrize("cs", (1, 2, 4))
@pytest.mark.parametrize("K", (2, 3, 4))
def test_sweep_grid_matches_sweep_and_jax(K, cs, dt):
    """M = 3 K cs - 1 rows over K groups of cs slices (not a multiple: the
    last slice holds 2): shared monomers of a two-letter alphabet (many
    ties) against `sweep` and the JAX package's debug arrays (every row
    real, so the int16 state's values equal int32's), on the lanes body's
    rows (C = 2) and the tiled body's (G = 2 warps of C = 1); per-window
    monomers with the last group's rows of length 0 against `sweep`."""
    rng = np.random.default_rng(300 + 10 * K + cs)
    M = 3 * K * cs - 1
    sc = SCORINGS[(K + cs) % len(SCORINGS)]
    args = _problem(rng, 2, 30, M, 40, 2, per_window=False)
    for form in (dict(cells_per_lane=2), dict(cells_per_lane=1, warps_per_row=2, tile=1)):
        got, want = _sweeps(args, sc, dt, clusters=K, cluster_size=cs, **form)
        _equal(got, want)
        _equal_jax(got, ("grid", K, cs), args, sc)
    args = _problem(rng, 2, 24, M, 64, 4, zero_rows=min(M - 1, cs + 1))
    got, want = _sweeps(args, SCORINGS[0], dt, clusters=K, cluster_size=cs, cells_per_lane=2)
    _equal(got, want)


def test_sweep_grid_refuses_a_plan_that_does_not_hold_the_rows():
    """Every slice owns a row: 2 x 2 slices of 2 rows leave one of 5 rows
    empty; the split form needs K cs / S = M and warps_per_row."""
    args = _problem(np.random.default_rng(0), 1, 5, 5, 40, 4, per_window=False)
    with pytest.raises(ValueError, match="empty"):
        _sweeps(args, SCORINGS[0], torch.int32, clusters=2, cluster_size=2, cells_per_lane=2)
    for grid in (dict(clusters=1, cluster_size=4, blocks_per_row=2, warps_per_row=1),
                 dict(clusters=5, cluster_size=2, blocks_per_row=2)):
        with pytest.raises(ValueError, match="do not hold"):
            _sweeps(args, SCORINGS[0], torch.int32, cells_per_lane=1, **grid)


def _mono(records):
    monos = add_reverse_complement(records)
    return pad_monomers(monos, pad_to=(max(len(m.seq) for m in monos) + 7) // 8 * 8)


@pytest.fixture(scope="module")
def library_case(test_data_dir):
    """The 264-monomer HOR library against 2 windows of ~200 bp drawn from
    it, with the JAX package's outputs on them (test_torch_chain_dp_cluster.py's
    case, its windows cut)."""
    from stringdecomposer_tpu_torch.scripts.workloads import hor_library

    lib = hor_library(load_fasta(test_data_dir / "DXZ1_star_monomers.fa"),
                      np.random.default_rng(0))
    mono, lens = _mono(lib)
    assert mono.shape == (264, 192)
    rng = np.random.default_rng(8)
    wins = []
    for b in range(2):
        unit = "".join(lib[int(rng.integers(len(lib)))].seq for _ in range(2))
        wins.append(encode(unit[: 200 - 23 * b]))
    wb, wl = plain.build_window_batch(wins, 200)
    kw = dict(ins=-1, dele=-1, mismatch=-1, match=1, max_blocks=1, return_debug=True)
    jax_out = jax_chain_dp.chain_dp_forward(wb, wl, mono, lens, **kw)
    jax_out = [np.asarray(x) for x in jax_out[:2]] + [np.asarray(x) for x in jax_out[2]]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (wb, wl, mono, lens)], kw, jax_out


@DTYPES
@pytest.mark.parametrize("K, cs", [(2, 8), (4, 4)])
def test_library_m264_on_k_clusters_matches_sweep_and_jax(library_case, K, cs, dt):
    """sweep_grid at M = 264 on K = 2 and 4 clusters (16 slices of 17 rows)
    equals `sweep` and the JAX package's chain, end and spend; the walk over
    them gives its blocks and counts."""
    args, kw, (jb, jc, jchain, jend, jspend) = library_case
    got, want = _sweeps(args, (-1, -1, -1, 1), dt, clusters=K, cluster_size=cs,
                        cells_per_lane=6)
    _equal(got, want)
    for g, j in zip(got, (jchain, jend, jspend)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), j)
    blocks, counts = plain.block_walk(got[1], got[2], args[1], kw["max_blocks"])
    np.testing.assert_array_equal(blocks.numpy(), jb)
    np.testing.assert_array_equal(counts.numpy(), jc)


def _tie_rows(rng, M, L):
    """Rows whose repeats tie along the deletion chain: runs of one letter
    and a period-2 pattern, then random letters."""
    mono = rng.integers(0, 4, (M, L)).astype(np.int8)
    mono[0, : L // 2] = 0
    if M > 1:
        mono[1, : L // 2] = np.tile(np.array([1, 2], np.int8), L // 4 + 1)[: L // 2]
    return mono


@DTYPES
@pytest.mark.parametrize("S", (2, 3))
def test_sweep_split_matches_sweep_and_jax(S, dt):
    """The split form, each row over S blocks of G = 2 warps of C = 2 cells
    (tiles of 1), one or two rows a group: rows of full length and runs that
    tie along the deletion chain, against `sweep` and the JAX package; then
    per-window rows that end before a block's cells start (at and just past
    a block's first cell, and inside the first block) and of length 0,
    against `sweep` and, in int32, JAX."""
    rng = np.random.default_rng(400 + S)
    P = 32 * 2 * 2  # a block's cells
    L = S * P - 7
    win = np.full((3, 40), plain.READ_PAD, dtype=np.int8)
    wl = np.array([40, 33, 40], dtype=np.int32)
    for b in range(3):
        win[b, : wl[b]] = rng.integers(0, 3, wl[b])
    win[2, :20] = 0  # the one-letter run of row 0
    M = 2
    mono = _tie_rows(rng, M, L)
    lens = np.full(M, L, np.int32)
    grid = dict(cells_per_lane=2, warps_per_row=2, tile=1, blocks_per_row=S)
    args = [torch.from_numpy(a) for a in (win, wl, mono, lens)]
    for K, cs in ((1, 2 * S), (2, S)):
        sc = SCORINGS[K]
        got, want = _sweeps(args, sc, dt, clusters=K, cluster_size=cs, **grid)
        _equal(got, want)
        _equal_jax(got, ("split", S, K), args, sc)
    starts = [P * s for s in range(1, S)]
    lens_w = np.array([[L, starts[-1]], [starts[0] + 1, 0], [5, L - 1]], dtype=np.int32)
    mono_w = np.stack([_tie_rows(rng, M, L) for _ in range(3)])
    for b in range(3):
        for m in range(M):
            mono_w[b, m, lens_w[b, m]:] = 5
    args = [torch.from_numpy(a) for a in (win, wl, mono_w, lens_w)]
    got, want = _sweeps(args, SCORINGS[1], dt, clusters=1, cluster_size=2 * S, **grid)
    _equal(got, want)
    if dt == torch.int32:
        _equal_jax(got, ("split ragged", S), args, SCORINGS[1])


def test_split_carry_reads_the_totals_32_at_a_time():
    """The split form's warp carry over 70 warps (three groups of 32) equals
    the earliest argmax of the earlier warps' totals, ties included."""
    rng = np.random.default_rng(5)
    tt = torch.from_numpy(rng.integers(0, 4, (2, 3, 70)).astype(np.int32))
    tc = torch.from_numpy(rng.integers(0, 1000, (2, 3, 70)).astype(np.int32))
    wt, wc = plain._TiledRows.split_carry(tt, tc)
    for w in range(70):
        if w == 0:
            assert (wt[..., 0] == plain.INT32_MIN).all() and (wc[..., 0] == 0).all()
            continue
        first = tt[..., :w].argmax(dim=-1)  # the first of the maxima
        assert torch.equal(wt[..., w], tt[..., :w].amax(dim=-1))
        assert torch.equal(wc[..., w], tc[..., :w].gather(-1, first[..., None])[..., 0])


def _owned(plan, M):
    """The rows each block of a window owns, in block order; in the split
    form each group of S blocks, the blocks of one row."""
    K, cs, S, R = plan[:4]
    if S == 1:
        return [list(range(j * R, min(M, (j + 1) * R))) for j in range(K * cs)]
    return [[j] for j in range(K * cs // S)]


@pytest.mark.parametrize("sb", [4, 2], ids=["int32", "int16"])
def test_grid_plan_invariants(sb):
    """Over a grid of (M, L, state bytes): every plan of `grid_plan` and
    every admissible shape owns each row exactly once, every block at least
    one (or a part of one), at most SM_COUNT blocks a window and 16 a
    cluster, shared memory within 232,448 bytes by the kernels' formulas,
    the split form's blocks each starting below L; the body rule sends
    nothing that fits the card to the chunked body (a set within 80 % of
    the shared memory of SM_COUNT blocks, rows of its own form; a row within
    80 % of 16 blocks'), the sets past one cluster to "grid", "grid_tiled"
    or "split" exactly where `grid_plan` finds a plan, and sets past the
    whole card's shared memory to "large"."""
    lim, sms = chain_dp_cuda.SMEM_LIMIT, chain_dp_cuda.SM_COUNT
    seen = set()
    for L in (40, 192, 256, 360, 512, 528, 2056, 9000, 25800, 60000, 200000):
        cell = 2 * sb + 1  # a cell's scores, pointer and code
        for M in (1, 2, 3, 5, 100, 700, 1100, 1500, 2400, 5000, 12000, 17000, 30000):
            body = chain_dp_cuda.body(M, L, sb)
            plan = chain_dp_cuda.grid_plan(M, L, sb)
            seen.add(body)
            rows_fit = M * (L * cell + 8 * 16) <= 0.8 * sms * lim and L * cell <= 0.8 * lim
            row_fits = L * cell <= 0.8 * 16 * lim and M * L * cell <= 0.8 * sms * lim
            if rows_fit or (row_fits and M <= 8):
                assert body not in ("chunked", "large"), (M, L, sb, body)
            if M * L * cell > sms * lim:
                assert body == "large" and plan is None, (M, L, sb, body)
            if body in chain_dp_cuda.GRID_BODIES:
                assert plan is not None and chain_dp_cuda.grid_body(plan[4]) == body
            if plan is None:
                continue
            K, cs, S, R, form, threads, smem = plan
            assert 1 <= cs <= 16 and K * cs <= sms and threads <= 1024 and threads % 32 == 0
            assert plan[3:] == chain_dp_cuda.grid_shape(M, L, sb, K, cs, S)
            owned = _owned(plan, M)
            assert all(owned)
            assert sorted(m for rows in owned for m in rows) == list(range(M))
            if S == 1:
                assert K >= 2 and R == -(-M // (K * cs)) and form != "split"
            else:
                assert form == "split" and R == 1 and K * (cs // S) == M
                G, C, _ = chain_dp_cuda.split_layout(L, S)
                assert (S - 1) * 32 * G * C < L <= S * 32 * G * C
                assert chain_dp_cuda.tiled_shape(1, L, sb, 1) is None
            if form in ("tiled", "split"):
                G, C, _ = (chain_dp_cuda.tiled_layout(R, L) if S == 1
                           else chain_dp_cuda.split_layout(L, S))
                assert smem == chain_dp_cuda.grid_tiled_smem_bytes(
                    cs * R if S == 1 else cs // S, R, G, C, S, sb)
            else:
                assert L <= 512 and smem == chain_dp_cuda.grid_smem_bytes(cs * R, L, R, sb)
            assert smem <= lim
    assert {"grid", "grid_tiled", "split", "large"} <= seen


@pytest.mark.parametrize("windows", [1, 19, 64])
def test_grid_plan_keeps_a_window_resident(windows):
    """With the card's occupancy, plans whose K clusters cannot all run at
    once are left out; the plan's launch takes floor(active / K) windows a
    wave; where no plan is left, the cheapest is returned (its launch
    raises). Made-up occupancies: one block an SM, as at these rows'
    shared memory."""
    def active(plan):
        return chain_dp_cuda.SM_COUNT // plan[1]

    plan = chain_dp_cuda.grid_plan(2400, 192, 4, windows, active)
    assert active(plan) >= plan[0]
    for p in chain_dp_cuda._grid_shapes(2400, 192, 4):
        if active(p) >= p[0]:
            assert chain_dp_cuda.grid_cost(plan, 192, windows, active(plan)) <= \
                chain_dp_cuda.grid_cost(p, 192, windows, active(p))
    none = chain_dp_cuda.grid_plan(2400, 192, 4, windows, lambda p: 1)
    assert none == chain_dp_cuda.grid_plan(2400, 192, 4)


def test_constants_match_the_kernel_source():
    """The wrapper's copies of the grid routes' formulas and checks
    (csrc/chain_dp_cluster.cuh, chain_dp_tiled.cu, chain_dp_grid.cu)."""
    cluster = (CSRC / "chain_dp_cluster.cuh").read_text()
    assert ("return 2LL * Me * 4 + 8 + (R > 32 ? (long long)R * L * (2 * state_bytes + 1) : 0);"
            in cluster)
    tiled = (CSRC / "chain_dp_tiled.cu").read_text()
    assert "const long long NT = S > 1 ? (long long)S * G : (G > 1 ? Sg : 0);" in tiled
    assert ("return 8LL * Me + 8 + 256 * Sg + 8 * NT + (G > 1 || S > 1 ? 16 * Sg : 0) + "
            "(S > 1 ? 16 : 0) +" in tiled)
    assert "R == 1 && cs % SB == 0 && (long long)K * (cs / SB) == M &&" in tiled
    assert "(SB - 1) * cells < L && SB * cells >= L;" in tiled
    grid = (CSRC / "chain_dp_grid.cu").read_text()
    assert "R >= 1 && (blocks - 1) * R < M && M <= blocks * R && L >= 1 &&" in grid
    assert "L <= 32 * kLanesMaxC && grid_smem_bytes(cs * R, L, R, state_bytes) <= kSmemLimit" in grid
    header = (CSRC / "chain_dp_grid.cuh").read_text()
    assert re.search(r"constexpr unsigned long long kGridSpinNs = \d+ull \* 1000 \* 1000 \* 1000;",
                     header)
    assert "st.release.gpu.global.b64" in header and "ld.acquire.gpu.global.b64" in header
    assert not re.search(r"\batom\.|atomic[A-Z]", header + grid)


@pytest.mark.parametrize("body, M, L, sb", [
    ("grid", 2400, 192, 4), ("grid", 1500, 360, 4), ("grid_tiled", 800, 528, 4),
    ("grid_tiled", 1400, 528, 2), ("grid_tiled", 256, 2056, 4), ("split", 1, 25800, 4),
    ("split", 2, 34248, 4), ("large", 20000, 192, 4)])
def test_body_rule_past_one_cluster(body, M, L, sb):
    """The sets the chunked body ran until the grid routes: more rows than
    16 blocks hold (the grid route; past 512 bp its tiled form), a row past
    one block's shared memory in the tiled form (the split form); a set past
    the card's shared memory stays on the chunked body's large route."""
    assert chain_dp_cuda.body(M, L, sb) == body
    assert chain_dp_cuda.cluster_plan(M, L, sb) is None


def _counters():
    fn = chain_dp_cuda.chain_dp_large_cuda
    return {k: v for k, v in vars(fn).items() if k.startswith("launches")}


@pytest.mark.parametrize("body, M, L, W", [("grid", 2400, 192, 12), ("grid_tiled", 800, 528, 10),
                                           ("split", 1, 25800, 4)])
def test_cpu_dispatch_past_one_cluster_matches_jax(body, M, L, W):
    """The port's CPU dispatch of the sets the rule sends to each grid body
    equals the JAX package, through chain_dp_forward_cuda and
    chain_dp_large_cuda (as routed, under `force_body=`, and at a `grid=`
    plan), launching nothing."""
    rng = np.random.default_rng(M + L)
    win, wl, mono, lens = _problem(rng, 2, W, M, L, 4, per_window=False)
    assert chain_dp_cuda.body(M, L) == body
    kw = dict(ins=-1, dele=-1, mismatch=-1, match=1, return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(*(a.numpy() for a in (win, wl, mono, lens)), **kw)
    want = [np.asarray(x) for x in (jb, jc, *jdbg)]
    counters = _counters()
    plan = chain_dp_cuda.grid_plan(M, L, 4)
    runs = ((chain_dp_cuda.chain_dp_forward_cuda, {}),
            (chain_dp_cuda.chain_dp_forward_cuda, {"force_body": body}),
            (chain_dp_cuda.chain_dp_large_cuda, {}),
            (chain_dp_cuda.chain_dp_large_cuda, {"grid": plan[:3]}))
    for fn, extra in runs:
        b, c, dbg = fn(win, wl, mono, lens, **extra, **kw)
        for g, j in zip((b, c, *dbg), want):
            np.testing.assert_array_equal(g.numpy(), j)
    assert _counters() == counters


def test_grid_arguments_are_checked():
    """`grid=` is checked against what the plan admits, on any device, and
    `force_body=` names a grid body only where it takes the set."""
    rng = np.random.default_rng(3)
    win, wl, mono, lens = _problem(rng, 1, 6, 800, 528, 4, per_window=False)
    large = chain_dp_cuda.chain_dp_large_cuda
    for grid in ((200, 1, 1), (7, 16, 1), (1, 3, 2)):
        with pytest.raises(ValueError, match="not admitted"):
            large(win, wl, mono, lens, grid=grid)
    with pytest.raises(ValueError, match="exclude"):
        large(win, wl, mono, lens, grid=(5, 10, 1), cluster_size=4)
    with pytest.raises(ValueError, match="takes L <= 512"):
        large(win, wl, mono, lens, force_body="grid")
    with pytest.raises(ValueError, match="cannot take"):
        large(win, wl, mono, lens, force_body="split")
    with pytest.raises(ValueError, match="takes L > 512"):
        large(win[:, :4], wl.clamp(max=4), mono[:, :192], lens.clamp(max=192),
              force_body="grid_tiled")
    got = large(win, wl, mono, lens, grid=(5, 10, 1), return_debug=True)
    want = plain.chain_dp_forward(win, wl, mono, lens, return_debug=True)
    for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
        assert torch.equal(g, w)


def test_grid_counters():
    """Each grid body counts its own launches on chain_dp_large_cuda, int16
    apart, the grid route's rows past 256 bp apart ("_long")."""
    for kind, L, name in (("grid", 192, "launches_grid"), ("grid", 360, "launches_grid_long"),
                          ("grid_tiled", 528, "launches_grid_tiled"),
                          ("split", 25800, "launches_split")):
        for dt, suffix in ((torch.int32, ""), (torch.int16, "_int16")):
            assert chain_dp_cuda._counter(dt, kind, L) == name + suffix
            assert isinstance(getattr(chain_dp_cuda.chain_dp_large_cuda, name + suffix), int)


def test_joined_variants_reach_the_grid_routes(test_data_dir):
    """The workloads past one cluster: 2,400 DXZ1 monomer variants (k = 1,
    L = 192: the grid route), 256 HOR-unit variants (k = 12, L = 2,056: its
    tiled form) and a unit of 200 DXZ1 monomers (~34 kbp: the split form)."""
    from stringdecomposer_tpu_torch.scripts import workloads

    dxz1 = load_fasta(test_data_dir / "DXZ1_star_monomers.fa")
    for k, n, L, body in ((1, 2400, 192, "grid"), (12, 256, 2056, "grid_tiled")):
        mono, lens = _mono(workloads.joined_variants(dxz1, k, n, np.random.default_rng(0)))
        assert mono.shape == (n, L) and chain_dp_cuda.body(n, L) == body
    mono, _ = _mono(workloads.joined_set(dxz1, 200)[:1])
    assert mono.shape[0] == 2 and 34000 < mono.shape[1] < 35000
    assert chain_dp_cuda.body(*mono.shape) == "split"


@pytest.mark.parametrize("L, last, body", [(192, 17556, "grid"), (360, 9372, "grid"),
                                           (528, 5808, "grid_tiled"),
                                           (2056, 1584, "grid_tiled")])
def test_where_the_chunked_body_starts(L, last, body):
    """In int32, the largest sets a grid plan holds on SM_COUNT blocks, and
    the chunked body's large route one row past them (PERF.md §7)."""
    assert chain_dp_cuda.body(last, L) == body
    assert chain_dp_cuda.body(last + 1, L) == "large"
    assert chain_dp_cuda.grid_plan(last + 1, L) is None
