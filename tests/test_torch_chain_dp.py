"""Chain DP of the PyTorch port (plain twin, and the K1 wrapper's CPU
dispatch) against the JAX package's lax.scan chain_dp_forward on the same
NumPy inputs. Every output is an integer array and must be equal."""

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


def _mono(records):
    monos = add_reverse_complement(records)
    return pad_monomers(monos, pad_to=(max(len(m.seq) for m in monos) + 7) // 8 * 8)


def _both(wb, wl, mono, lens, sc=(-1, -1, -1, 1), max_blocks=0):
    kw = dict(ins=sc[0], dele=sc[1], mismatch=sc[2], match=sc[3],
              max_blocks=max_blocks, return_debug=True)
    jb, jc, jdbg = jax_chain_dp.chain_dp_forward(wb, wl, mono, lens, **kw)
    tb, tc, tdbg = chain_dp_cuda.chain_dp_forward_cuda(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (wb, wl, mono, lens)), **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for t, j in zip(tdbg, jdbg):  # chain, end, spend
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return tc.numpy()


@pytest.mark.parametrize("idx", range(N_CASES))
def test_plain_matches_jax_on_fixture_windows(random_cases, idx):
    """All windows of one reference fixture in one batch: blocks, counts and
    the debug chain/end/spend arrays (test_chain_dp.py:29-56)."""
    case = random_cases[idx]
    mono, lens = _mono([Record(n, s) for n, s in case["monomers"]])
    reads = case.get("reads") or [["read0", case["read"]]]
    wins = [encode(seq[o : o + n]) for _, seq in reads
            for o, n in make_windows(len(seq), case["part_size"], case["overlap"])]
    wb, wl = plain.build_window_batch(wins, max(len(w) for w in wins))
    _both(wb, wl, mono, lens, tuple(case["scoring"]))


def _random_problem(seed, n_fwd, lo, hi, B, W):
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGT"))
    fwd = [Record(f"m{j}", "".join(rng.choice(alpha, int(rng.integers(lo, hi)))))
           for j in range(n_fwd)]
    mono, lens = _mono(fwd)
    wins = []
    for _ in range(B):
        unit = fwd[int(rng.integers(n_fwd))].seq
        arr = np.array(list((unit * (W // len(unit) + 2))[: int(rng.integers(W // 2, W + 1))]))
        idx = rng.integers(0, len(arr), max(1, len(arr) // 10))
        arr[idx] = rng.choice(alpha, len(idx))
        wins.append(encode("".join(arr)))
    wb, wl = plain.build_window_batch(wins, W)
    return rng, mono, lens, wb, wl


def test_per_window_monomer_form():
    """[B, M, L] monomers (chain_dp.py:84-90): a different order per window
    and rows masked to length 0."""
    rng, mono, lens, wb, wl = _random_problem(5, 6, 12, 30, 3, 120)
    perm = np.stack([rng.permutation(len(lens)) for _ in range(3)])
    mono_w, lens_w = mono[perm], lens[perm].copy()
    lens_w[1, -2:] = 0
    _both(wb, wl, mono_w, lens_w, (-2, -1, -1, 2))


def test_large_monomer_library_m128():
    """M = 128 (64 forward + RC, 20-40 bp) at W = 96, as
    test_pallas_kernel.py:100."""
    _, mono, lens, wb, wl = _random_problem(23, 64, 20, 40, 2, 96)
    assert mono.shape[0] == 128
    _both(wb, wl, mono, lens)


def test_overflow_count_at_small_cap():
    """Counts keep growing past max_blocks (the pipeline's overflow check)."""
    _, mono, lens, wb, wl = _random_problem(9, 4, 10, 16, 3, 90)
    counts = _both(wb, wl, mono, lens, max_blocks=2)
    assert counts.max() > 2


def test_cpu_dispatch_launches_nothing():
    _, mono, lens, wb, wl = _random_problem(1, 3, 8, 12, 2, 40)
    before = (chain_dp_cuda.chain_dp_forward_cuda.launches, chain_dp_cuda.block_walk_cuda.launches)
    chain_dp_cuda.chain_dp_forward_cuda(*(torch.from_numpy(a) for a in (wb, wl, mono, lens)))
    after = (chain_dp_cuda.chain_dp_forward_cuda.launches, chain_dp_cuda.block_walk_cuda.launches)
    assert after == before


def test_hor_library_matches_jax_m264(test_data_dir):
    """The 264-monomer HOR library (the port's scripts/workloads.hor_library,
    which chip_smoke drives: the set that takes K1's large route on the
    card) at B = 3, W = 320."""
    from stringdecomposer_tpu_torch.scripts.workloads import hor_library
    from stringdecomposer_tpu.io.fasta import load_fasta

    lib = hor_library(load_fasta(test_data_dir / "DXZ1_star_monomers.fa"),
                      np.random.default_rng(0))
    mono, lens = _mono(lib)
    assert mono.shape == (264, 192)
    rng = np.random.default_rng(3)
    wins = []
    for b in range(3):
        unit = "".join(lib[int(rng.integers(len(lib)))].seq for _ in range(2))
        wins.append(encode(unit[: 320 - 40 * b]))
    wb, wl = plain.build_window_batch(wins, 320)
    counts = _both(wb, wl, mono, lens)
    assert counts.min() >= 1
    # the large route's entry point runs the same twin on CPU tensors
    got = chain_dp_cuda.chain_dp_large_cuda(*(torch.from_numpy(a) for a in (wb, wl, mono, lens)))
    np.testing.assert_array_equal(got[1].numpy(), counts)


def test_monomer_set_limit_is_named():
    """Route choice: sets whose column fits one block's shared memory take
    the shared route, larger ones the large route; only the large route's
    per-row bound (8 * M bytes) is left, and it raises naming the limit."""
    assert chain_dp_cuda.route(24, 192) == "shared"  # DXZ1 with RC
    assert chain_dp_cuda.route(133, 192) == "shared"  # the largest that fits at L = 192
    assert chain_dp_cuda.route(134, 192) == "large"
    assert chain_dp_cuda.route(264, 192) == "large"  # the HOR library
    for M, L in ((24, 192), (264, 192), (4096, 192), (29_056, 8)):
        chain_dp_cuda.check_monomer_set(M, L)  # nothing raises
    with pytest.raises(ValueError, match="232448-byte limit"):
        chain_dp_cuda.check_monomer_set(29_057, 8)
