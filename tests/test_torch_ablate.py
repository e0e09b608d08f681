"""A, the ablation kernels of K1's lanes and cluster bodies, in the
PyTorch port: the plain versions.

The plain base, nochain and noshift (ops/chain_dp.chain_dp_ablate: the
lanes body's step, `_LanesRows`, and the cluster body's, `sweep_grid` over
slices of rows) against the JAX bench's make_kernel(variant)
(scripts/ablate_chain.py) run through pl.pallas_call(interpret=True) at
tiny shapes, on the same seeded inputs: end and spend at every position
and row must be equal (integers, tolerance 0). The JAX kernel keeps
monomers right-aligned in the lane axis and takes the read chars per row;
the inputs are converted here.

The ladder variants are held only against the port's own plain version:
the JAX kernel cuts its one doubling scan over the whole row, while the
lanes and cluster bodies keep each lane's sequential prefix over its own
cells whole and cut only the scan over the 32 lane totals, so the two cut
different scans by design of the variants and not by a fault. noemit is
held only against the port's plain version too: the JAX variant emits
nothing at all, the port's keeps the last position live."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stringdecomposer_tpu_torch.ops import chain_dp as plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda
from stringdecomposer_tpu_torch.scripts import ablate_chain as bench

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "jax_ablate_chain", pathlib.Path(__file__).resolve().parent.parent / "scripts" / "ablate_chain.py")
jax_ablate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_ablate)


def _problem(seed, B, M, L, steps, lens_lo):
    """Seeded codes, monomer lengths in [lens_lo, L], a column 0 in
    [-200, 0): the port's left-aligned form."""
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, 4, (B, steps + 1), dtype=np.int8)
    mono = rng.integers(0, 4, (M, L), dtype=np.int8)
    lens = rng.integers(lens_lo, L + 1, M).astype(np.int32)
    for m in range(M):
        mono[m, lens[m]:] = 5
    dp0 = rng.integers(-200, 0, (B, M, L), dtype=np.int32)
    return windows, mono, lens, dp0


def _jax_run(variant, windows, mono, lens, dp0, BT, pos_tile):
    """JAX's make_kernel(variant) interpreted, on the same problem converted
    to its layout: a group of BT windows x m_pad = M rows per program, each
    row right-aligned, read chars for positions 1.. per row. Returns (end,
    spend) as [B, steps, M] for positions 1..steps."""
    B, W = windows.shape
    M, L = mono.shape
    steps = W - 1
    R = BT * M
    mono_r = np.zeros((B * M, L), np.int32)
    dp0_r = np.full((B * M, L), -7, np.int32)  # lanes left of a row's start are never read
    for b in range(B):
        for m in range(M):
            n = lens[m]
            mono_r[b * M + m, L - n:] = mono[m, :n]
            dp0_r[b * M + m, L - n:] = dp0[b, m, :n]
    rc = np.repeat(windows[:, 1:].astype(np.int32), M, axis=0)
    lens_r = np.tile(lens, B)[:, None].astype(np.int32)
    kern = jax_ablate.make_kernel(L, BT, M, pos_tile, variant)
    def spec(w, per_position=False):  # the JAX bench's BlockSpecs (ablate_chain.py:196-207)
        return pl.BlockSpec((R, w), (lambda b, t: (b, t)) if per_position else (lambda b, t: (b, 0)),
                            memory_space=pltpu.VMEM)

    e, sp = pl.pallas_call(
        kern,
        grid=(B // BT, steps // pos_tile),
        in_specs=[spec(pos_tile, True), spec(L), spec(1), spec(L), spec(L)],
        out_specs=(spec(pos_tile, True), spec(pos_tile, True)),
        out_shape=(jax.ShapeDtypeStruct((B * M, steps), jnp.int32),) * 2,
        scratch_shapes=[pltpu.VMEM((R, L), jnp.int32)] * 2,
        interpret=True,
    )(*map(jnp.asarray, (rc, mono_r, lens_r, dp0_r, np.zeros_like(dp0_r))))
    return tuple(np.asarray(x).reshape(B, M, steps).transpose(0, 2, 1) for x in (e, sp))


BODIES = {"lanes": None, "cluster": 3}  # body -> cluster_size of the plain version


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("variant", ["base", "nochain", "noshift"])
@pytest.mark.parametrize("seed,B,BT,L,pos_tile", [(0, 2, 1, 16, 8), (1, 2, 2, 32, 16),
                                                  (2, 4, 2, 24, 8), (3, 2, 1, 72, 8)])
def test_plain_matches_jax_make_kernel_interpreted(body, variant, seed, B, BT, L, pos_tile):
    M, steps = 8, 2 * pos_tile
    windows, mono, lens, dp0 = _problem(seed, B, M, L, steps, lens_lo=L // 2)
    je, js = _jax_run(variant, windows, mono, lens, dp0, BT, pos_tile)
    te, ts = plain.chain_dp_ablate(*map(torch.from_numpy, (windows, mono, lens, dp0)), variant,
                                   cluster_size=BODIES[body])
    np.testing.assert_array_equal(te[:, 1:].numpy(), je)
    np.testing.assert_array_equal(ts[:, 1:].numpy(), js)


def _peaked(seed, B, M, L, steps):
    """`_problem` with column 0 peaked at k = 0 and 1 (400) in the first
    half of the rows, so that the deletion chain from there wins every cell
    of such a row (a cut fold shows) and their end scores lead the others'
    (a chain max taken from a row's own end shows)."""
    windows, mono, lens, dp0 = _problem(seed, B, M, L, steps, lens_lo=L - 10)
    dp0[:, : M // 2, :2] = 400
    return tuple(map(torch.from_numpy, (windows, mono, lens, dp0)))


@pytest.mark.parametrize("body", list(BODIES))
def test_variants_change_what_they_should(body):
    """Each variant differs from base somewhere (it removes a real cost
    centre), and noemit keeps only the last position: the rest is 0."""
    windows, mono, lens, dp0 = _peaked(5, 2, 8, 192, 60)
    cs = BODIES[body]
    base = plain.chain_dp_ablate(windows, mono, lens, dp0, "base", cluster_size=cs)
    for v in plain.VARIANTS[1:]:
        e, s = plain.chain_dp_ablate(windows, mono, lens, dp0, v, cluster_size=cs)
        assert not (torch.equal(e, base[0]) and torch.equal(s, base[1])), v
    e, s = plain.chain_dp_ablate(windows, mono, lens, dp0, "noemit", cluster_size=cs)
    assert not e[:, :-1].any() and not s[:, :-1].any()
    assert torch.equal(e[:, -1], base[0][:, -1]) and torch.equal(s[:, -1], base[1][:, -1])


@pytest.mark.parametrize("variant", ["ladder4", "ladder2"])
def test_ladder_plain_cuts_the_scan_inside_32_cell_chunks(variant):
    """The ladders cut the scan over the 32 lane totals after 4 or 2
    doubling steps, as the lanes body's shuffle scan is cut (csrc/
    chain_dp_lanes.cuh lanes_row): from one position's candidates, a cell of
    lane l ends as the earliest argmax (value and payload) of the cells of
    lanes l - 2^steps .. l - 1 (the first lane at least 0) and its own
    lane's cells up to itself, where base takes every earlier cell."""
    reach = 1 << (4 if variant == "ladder4" else 2)
    windows, mono, lens, dp0 = _peaked(3, 1, 2, 192, 4)
    mono_b, lens_b = plain.broadcast_monomers(mono, lens, 1)
    C = 6
    for v, window in ((variant, reach), ("base", 32)):
        rows = plain._LanesRows(windows, mono_b, lens_b, dp0, -1, -1, -1, 1, C, v)
        chain = rows.emit()[0].amax(dim=1)
        t, cs = rows.candidates(1, chain)
        rows.fold(t, cs)
        t, cs = t.reshape(1, 2, 32 * C), cs.reshape(1, 2, 32 * C)
        got_q = rows.dp - rows.kdel
        for m in range(2):
            for k in range(32 * C):
                lo = max(0, k // C - window) * C
                j = lo + int(torch.argmax(t[0, m, lo : k + 1]))  # the first of the maxima
                assert int(got_q[0, m, k]) == int(t[0, m, j]), (v, m, k)
                assert int(rows.sp[0, m, k]) == int(cs[0, m, j]), (v, m, k)
    cut = plain._LanesRows(windows, mono_b, lens_b, dp0, -1, -1, -1, 1, C, variant)
    full = plain._LanesRows(windows, mono_b, lens_b, dp0, -1, -1, -1, 1, C)
    for r in (cut, full):
        r.step(1, r.emit()[0].amax(dim=1))
    assert not torch.equal(cut.dp, full.dp)  # the peak's chain reaches past the cut


@pytest.mark.parametrize("body", list(BODIES))
def test_base_is_k1(body):
    """The ablation's base is K1's own sweep on that body: from K1's column
    0 it gives chain_dp_forward's end and spend."""
    windows, mono, lens, _ = map(torch.from_numpy, _problem(7, 3, 6, 40, 90, lens_lo=20))
    dp0 = plain.init_column(windows, *plain.broadcast_monomers(mono, lens, 3), -1, -1, 1)
    e, s = plain.chain_dp_ablate(windows, mono, lens, dp0, "base", cluster_size=BODIES[body])
    _, _, (_, end, spend) = plain.chain_dp_forward(windows, torch.full((3,), 91, dtype=torch.int32),
                                                    mono, lens, return_debug=True)
    assert torch.equal(e, end) and torch.equal(s, spend)


def test_bench_check_and_refusals_on_cpu():
    """The bench's check runs every variant through the wrapper's CPU
    dispatch (the plain version) on both bodies at their bench forms (M =
    24; M = 264 over the bench batch's cluster size, its rows in shared
    memory); the JAX bench's TPU-only variants and unknown names are
    refused with the reason."""
    err = bench.check(list(plain.VARIANTS), "cpu", B=1, W=12)
    assert err == {(v, large): 0 for v in plain.VARIANTS for large in (False, True)}
    cs = bench.cluster_size(264, bench.B_BENCH, "cpu")
    assert chain_dp_cuda.cluster_shape(264, bench.L, 4, cs)[1] == "rows_dense"
    for v in ("subroll", "unroll8", "hoist"):
        with pytest.raises(ValueError, match="no separate form on the card"):
            bench.parse_variants([v])
    with pytest.raises(ValueError, match="unknown variant"):
        bench.parse_variants(["fast"])
    assert bench.parse_variants([]) == list(plain.VARIANTS)
    assert bench.main(["hoist"]) == 2
    with pytest.raises(ValueError, match="unknown ablation variant"):
        chain_dp_cuda.chain_dp_ablate_cuda(*map(torch.from_numpy, _problem(0, 1, 2, 8, 4, 4)),
                                           "hoist", False)


def test_wrapper_takes_only_the_instantiated_forms():
    """A is built at the bench's forms only: the lanes body with M <= 32
    rows in registers at 6 cells a lane, the cluster body with more than
    32 rows a block in shared memory at L = 192. Other sets raise before
    anything runs, on the CPU as on the card, and within the forms the CPU
    runs the plain version."""
    def args(M, L, B=1, W=4):
        return map(torch.from_numpy, _problem(0, B, M, L, W - 1, L))

    with pytest.raises(ValueError, match="6 cells a lane"):
        chain_dp_cuda.chain_dp_ablate_cuda(*args(8, 160), "nochain", False)
    with pytest.raises(ValueError, match="in registers"):
        chain_dp_cuda.chain_dp_ablate_cuda(*args(33, 192), "nochain", False)
    with pytest.raises(ValueError, match="in shared memory"):  # 30 rows a block: registers
        chain_dp_cuda.chain_dp_ablate_cuda(*args(264, 192), "noshift", True, cluster_size=9)
    with pytest.raises(ValueError, match="in shared memory"):  # L = 176: not 32 x 6
        chain_dp_cuda.chain_dp_ablate_cuda(*args(264, 176), "noshift", True, cluster_size=3)
    windows, mono, lens, dp0 = args(24, 161, W=6)
    got = chain_dp_cuda.chain_dp_ablate_cuda(windows, mono, lens, dp0, "ladder2", False)
    want = plain.chain_dp_ablate(windows, mono, lens, dp0, "ladder2")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
