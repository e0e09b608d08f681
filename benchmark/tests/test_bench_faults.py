"""A whole run of the harness on the CPU at a small size (the DXZ1
configuration, one client, 12 kbp arrays), past its look for a chip, with
the timed path broken underneath: `correct` comes out
false for each fault a cell of this benchmark can have (one card, no
training state): half of K1's batch left out, a K1 answer altered where
it is produced (in every window, or in one slot of the batch), a K2
answer altered where it is produced. The same run unbroken comes out
true. And the check's sample, at the cell's own size, judges rows of
every slot of K1's batch."""

import copy
import time
from types import SimpleNamespace

import pytest
from harness import check, session, spec
from reference.chain_dp import make_windows


def half_batch(fn):
    def f(*a, **k):
        blocks, counts = fn(*a, **k)
        counts = counts.clone()
        counts[(len(counts) + 1) // 2 :] = 0  # the second half's windows emit nothing
        return blocks, counts
    return f


def k1_altered(fn):
    def f(windows, window_lens, mono, mono_lens, **k):
        blocks, counts = fn(windows, window_lens, mono, mono_lens, **k)
        blocks = blocks.clone()
        blocks[..., 0] = (blocks[..., 0] + 1) % mono.shape[0]  # every block's monomer
        return blocks, counts
    return f


def k1_one_slot(fn):
    def f(windows, window_lens, mono, mono_lens, **k):
        blocks, counts = fn(windows, window_lens, mono, mono_lens, **k)
        if blocks.shape[0] > 1:  # the batch's second window alone
            blocks = blocks.clone()
            blocks[1, :, 0] = (blocks[1, :, 0] + 1) % mono.shape[0]
        return blocks, counts
    return f


def k2_altered(fn):
    def f(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, tuple):  # light mode: (distance, matches, columns)
            return out[0], out[1] - 1, out[2]
        return out + 1  # --second-best: (D, columns), every pair
    return f


FAULTS = {"none": {}, "half_batch": {"forward_fn": half_batch},
          "k1_answer": {"forward_fn": k1_altered}, "k1_one_slot": {"forward_fn": k1_one_slot},
          "k2_answer": {"identity_fn": k2_altered, "packed_fn": k2_altered}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(fault):
    bench = spec.benchmark()
    cell = {"name": "cenx_dxz1.small", "config": "cenx_dxz1", "traffic": "assembly", "chips": 1}
    config = copy.deepcopy(spec.config(cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    config["array"]["bp"] = 12_000
    traffic.update(clients=1, warm_bp=2_000)
    traffic["check"].update(jobs=1, keep_every=1)
    logs = []
    result, numbers = session.run_spec(bench, cell, config, traffic, 2**31 + 9, 0.5, False,
                                       time.perf_counter(), device="cpu", wrap=FAULTS[fault],
                                       log=logs.append)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] == (fault == "none"), numbers
    assert {"raw_rows_differ", "final_rows_differ", "alt_rows_differ"} <= {n for n, _, _ in numbers}


def test_a_failing_warm_job_ends_the_run():
    def broken(fn):
        def f(*a, **k):
            raise RuntimeError("K1 failed")
        return f

    bench = spec.benchmark()
    cell = {"name": "cenx_dxz1.small", "config": "cenx_dxz1", "traffic": "assembly", "chips": 1}
    config = copy.deepcopy(spec.config(cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    config["array"]["bp"] = 6_000
    traffic.update(clients=2, warm_bp=1_000)
    with pytest.raises(RuntimeError, match="warm job failed"):
        session.run_spec(bench, cell, config, traffic, 1, 0.5, False, time.perf_counter(),
                         device="cpu", wrap={"forward_fn": broken}, log=lambda m: None)


@pytest.mark.parametrize("seed", [3, 2**31 + 7, 2**32 + 1])
def test_the_sample_judges_every_slot_of_the_batch(seed):
    cell = spec.cell(spec.benchmark(), "cenx_dxz1.assembly")
    cli = spec.config(cell["config"])["cli"]
    traffic = spec.traffic(cell["traffic"])
    bp = spec.config(cell["config"])["array"]["bp"]
    records = [SimpleNamespace(kept=True, error=None, input=SimpleNamespace(bp=bp), index=i)
               for i in range(20)]
    picked = check.sample(records, traffic, seed, cli)
    n_win = len(make_windows(bp, cli["batch_size"], cli["overlap"]))
    assert len({id(r) for r, _ in picked}) == traffic["check"]["jobs"]
    judged = set()
    for _, (w0, w1, _, _) in picked:
        assert 0 <= w0 <= w1 < n_win
        judged |= {w % cli["device_batch"] for w in range(w0, w1 + 1)}
    assert judged == set(range(cli["device_batch"]))
