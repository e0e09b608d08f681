"""The port's kernel stress (stringdecomposer_tpu_torch/scripts/stress_kernel.py,
stress_rescoring.py) on the CPU: its generator's small K1 cases through the
JAX package's chain_dp_forward + block_walk, the port's plain twin and the
port's oracle, all bit-equal; its K2 and K3 cases through the JAX package's
nw_identity_batch and hw_distance_batch against the port's twins; both
scripts' main() on a few cases with --device cpu; every stratum's draws in
that stratum under the port's pure routing functions; the draws
deterministic for a seed."""

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import chain_dp as jax_chain_dp
from stringdecomposer_tpu.ops import hw_filter as jax_hw
from stringdecomposer_tpu.ops import identity as jax_identity
from stringdecomposer_tpu_torch.ops import chain_dp as plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda as k1
from stringdecomposer_tpu_torch.ops import hw_filter as k3_plain
from stringdecomposer_tpu_torch.ops import identity as k2_plain
from stringdecomposer_tpu_torch.ops.identity_cuda import C_MAX, cells_per_lane
from stringdecomposer_tpu_torch.scripts import stress_kernel as sk
from stringdecomposer_tpu_torch.scripts import stress_rescoring as sr

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _kernel_args(case):
    wb, wl = plain.build_window_batch(case.wins, case.W)
    return wb, wl, np.ascontiguousarray(case.mono), np.ascontiguousarray(case.lens)


@pytest.mark.parametrize("seed", range(4))
def test_small_k1_cases_jax_twin_and_oracle_agree(seed):
    """The generator's small lanes cases (int32 and int16, shared and
    per-window monomers, max_blocks=1): JAX chain_dp_forward + block_walk,
    the port's twin and the port's oracle give the same blocks."""
    rng = np.random.default_rng(seed)
    for i in range(4):
        case = sk.draw_case(rng, "lanes", (4, 2)[i % 2], small=True)
        arrays = _kernel_args(case)
        ins, dele, mismatch, match = case.sc
        kw = dict(ins=ins, dele=dele, mismatch=mismatch, match=match,
                  max_blocks=case.max_blocks)
        jb, jc = (np.asarray(x) for x in jax_chain_dp.chain_dp_forward(*arrays, **kw))
        tb, tc = sk.run_twin(case, [torch.from_numpy(a) for a in arrays])
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tc, jc)
        if case.max_blocks:
            continue
        for b in range(len(case.wins)):
            assert sk._records(tb, tc, b) == sk.oracle(case, b), (seed, i, b, case.describe())


def test_stress_kernel_main_on_cpu():
    counts = {}
    assert sk.main(["4", "3", "--device", "cpu", "--body", "lanes"], counts) == 0
    assert counts == {"lanes/int32": 2, "lanes/int16": 2, "failures": 0}


def test_stress_rescoring_main_on_cpu():
    counts = {}
    assert sr.main(["5", "2", "--device", "cpu"], counts) == 0
    assert counts["failures"] == 0 and counts["k2 batch"] == counts["k2 cross"] == 5
    assert [counts[f"k2 C={c}"] for c in range(1, 6)] == [1] * 5
    assert sum(counts[f"k3 {r}/{s}"] for r, s in sr.K3_STRATA) == 5


@pytest.mark.parametrize("stratum", sr.K2_STRATA[:4] + sr.K2_STRATA[-2:])
def test_k2_cases_match_jax(stratum):
    q, ql, t, tl = sr.draw_k2(np.random.default_rng(len(stratum)), stratum)
    want = [np.asarray(x) for x in jax_identity.nw_identity_batch(q, ql, t, tl)]
    got = k2_plain.nw_identity_batch(*(torch.from_numpy(a) for a in (q, ql, t, tl)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("route,segs", sr.K3_STRATA[:4])
def test_k3_cases_match_jax(route, segs):
    wins, wl, mono, lens = sr.draw_k3(np.random.default_rng(7), route, segs)
    want = np.asarray(jax_hw.hw_distance_batch(wins, wl, mono, lens))
    got = k3_plain.hw_distance_batch(*(torch.from_numpy(a) for a in (wins, wl, mono, lens)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("body,sb", sk.STRATA)
def test_k1_draws_land_in_their_stratum(body, sb):
    """`body` names the stratum for every drawn set (the forced strata: a
    set their forced launch takes), and int16 draws only what the range
    checks admit."""
    rng = np.random.default_rng(11)
    for _ in range(3):
        case = sk.draw_case(rng, body, sb)
        M, L = case.M, case.L
        if (body, sb) not in sk.FORCED:
            assert k1.body(M, L, sb) == body
        elif body == "split":
            K, cs, S = case.grid
            assert k1.grid_body(k1.grid_shape(M, L, sb, K, cs, S)[1]) == "split"
        elif body == "chunked":
            assert k1.route(M, L, sb) == "shared"
        if sb == 2:
            assert plain.int16_bounds_ok(case.W, L, *case.sc)
            assert plain.int16_sentinel_ok(case.W, L, *case.sc)
        assert case.mono.shape[-2:] == (M, L) and max(len(w) for w in case.wins) == case.W
        assert M * L * case.W * 8 <= sk.ORACLE_BYTES


@pytest.mark.parametrize("stratum", sr.K2_STRATA)
def test_k2_draws_land_in_their_stratum(stratum):
    q = sr.draw_k2(np.random.default_rng(5), stratum)[0]
    if stratum == "strips":
        assert q.shape[1] > 32 * C_MAX
    else:
        assert f"C={cells_per_lane(q.shape[1])}" == stratum


@pytest.mark.parametrize("route,segs", sr.K3_STRATA)
def test_k3_draws_land_in_their_stratum(route, segs):
    rng = np.random.default_rng(9)
    wins, _, mono, _ = sr.draw_k3(rng, route, segs)
    assert k3_plain.hw_route(mono.shape[1]) == route
    seg_cols, nseg = sr.k3_segments(rng, CPU, route, segs, len(wins), *mono.shape, wins.shape[1])
    assert (nseg > 1) == (segs == "several")
    if seg_cols is not None:
        assert k3_plain.segments(wins.shape[1], seg_cols)[0] == nseg


def test_generator_is_deterministic():
    def draws(seed):
        rng = np.random.default_rng(seed)
        out = []
        for body, sb in sk.STRATA[:8]:
            c = sk.draw_case(rng, body, sb)
            out.append((c.describe(), c.mono.tobytes(), c.lens.tobytes(),
                        b"".join(w.tobytes() for w in c.wins)))
        out.append(tuple(a.tobytes() for a in sr.draw_k2(rng, "C=3")))
        out.append(tuple(a.tobytes() for a in sr.draw_k3(rng, "warp", "several")))
        return out

    assert draws(4) == draws(4)
    assert draws(4) != draws(5)
