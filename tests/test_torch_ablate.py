"""A, K1's ablation kernels, in the PyTorch port: the plain versions.

The plain base, nochain and noshift (ops/chain_dp.chain_dp_ablate) against
the JAX bench's make_kernel(variant) (scripts/ablate_chain.py) run through
pl.pallas_call(interpret=True) at tiny shapes, on the same seeded inputs:
end and spend at every position and row must be equal (integers,
tolerance 0). The JAX kernel keeps monomers right-aligned in the lane axis
and takes the read chars per row; the inputs are converted here.

The ladder variants are held only against the port's own plain version of
the cut scan: the CUDA K1 derives a cell's start-pointer payload AFTER the
deletion fold (csrc/chain_dp.cuh, from the folded score), while the JAX
kernel derives it BEFORE the fold (from the candidate). The two agree only
because a full prefix max makes the folded score equal the candidate at
every cell that wins the fold; a cut fold breaks that identity, so JAX's
ladder outputs are not the port's ladder outputs, by design of the
variants and not by a fault. noemit is held only against the port's plain
version too: the JAX variant emits nothing at all, the port's keeps the
last position live."""

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


@pytest.mark.parametrize("variant", ["base", "nochain", "noshift"])
@pytest.mark.parametrize("seed,B,BT,L,pos_tile", [(0, 2, 1, 16, 8), (1, 2, 2, 32, 16),
                                                  (2, 4, 2, 24, 8)])
def test_plain_matches_jax_make_kernel_interpreted(variant, seed, B, BT, L, pos_tile):
    M, steps = 8, 2 * pos_tile
    windows, mono, lens, dp0 = _problem(seed, B, M, L, steps, lens_lo=L // 2)
    je, js = _jax_run(variant, windows, mono, lens, dp0, BT, pos_tile)
    te, ts = plain.chain_dp_ablate(*map(torch.from_numpy, (windows, mono, lens, dp0)), variant)
    np.testing.assert_array_equal(te[:, 1:].numpy(), je)
    np.testing.assert_array_equal(ts[:, 1:].numpy(), js)


def test_variants_change_what_they_should():
    """Each variant differs from base somewhere (it removes a real cost
    centre), and noemit keeps only the last position: the rest is 0."""
    windows, mono, lens, dp0 = map(torch.from_numpy, _problem(5, 2, 8, 80, 120, lens_lo=70))
    base = plain.chain_dp_ablate(windows, mono, lens, dp0, "base")
    for v in plain.VARIANTS[1:]:
        e, s = plain.chain_dp_ablate(windows, mono, lens, dp0, v)
        assert not (torch.equal(e, base[0]) and torch.equal(s, base[1])), v
    e, s = plain.chain_dp_ablate(windows, mono, lens, dp0, "noemit")
    assert not e[:, :-1].any() and not s[:, :-1].any()
    assert torch.equal(e[:, -1], base[0][:, -1]) and torch.equal(s[:, -1], base[1][:, -1])


@pytest.mark.parametrize("variant", ["ladder4", "ladder2"])
def test_ladder_plain_cuts_the_scan_inside_32_cell_chunks(variant):
    """The ladder's plain version keeps each doubling step inside aligned
    32-cell chunks with no carry across them, as the warp scans of the
    CUDA variant do: on a column of one chunk it equals a plain cut
    Hillis-Steele max, and across chunks the first cell of each chunk
    sees nothing to its left."""
    steps = 4 if variant == "ladder4" else 2
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.integers(-50, 50, (3, 96)).astype(np.int32))
    got, _ = plain.pair_scan(t, [], torch.gt, steps=steps, chunk=32)
    want = t.clone()
    for k in range(96):
        lo = max(k - (1 << steps) + 1, k - k % 32)
        want[:, k] = t[:, lo : k + 1].amax(dim=1)
    assert torch.equal(got, want)


def test_base_is_k1():
    """The ablation's base is K1's own sweep: from K1's column 0 it gives
    chain_dp_forward's end and spend."""
    windows, mono, lens, _ = map(torch.from_numpy, _problem(7, 3, 6, 40, 90, lens_lo=20))
    dp0 = plain.init_column(windows, *plain.broadcast_monomers(mono, lens, 3), -1, -1, 1)
    e, s = plain.chain_dp_ablate(windows, mono, lens, dp0, "base")
    _, _, (_, end, spend) = plain.chain_dp_forward(windows, torch.full((3,), 91, dtype=torch.int32),
                                                    mono, lens, return_debug=True)
    assert torch.equal(e, end) and torch.equal(s, spend)


def test_bench_check_and_refusals_on_cpu():
    """The bench's check runs every variant through the wrapper's CPU
    dispatch (the plain version) on both routes; the JAX bench's TPU-only
    variants and unknown names are refused with the reason."""
    err = bench.check(list(plain.VARIANTS), "cpu", B=2, W=40, M=6)
    assert err == {v: 0 for v in plain.VARIANTS}
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
