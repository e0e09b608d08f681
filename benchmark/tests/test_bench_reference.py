"""The plain reference against the port's plain route on the CPU, at a
small size: every raw, final and alt row equal; a corrupted row is
caught; the control (the reference with the last monomer of equal score
and the diagonal-first NW path) is not equal."""

import os

import numpy as np
import pytest
from harness.inputs import read_fasta, write_fasta
from harness.spec import BENCH_DIR
from harness.workloads import hor_array
from reference import decompose
from reference.nw_identity import nw_counts, nw_path_spec

from stringdecomposer_tpu_torch import pipeline

DXZ1 = str(BENCH_DIR / "data" / "DXZ1_star_monomers.fa")
TSVS = {"raw": "final_decomposition_raw.tsv", "final": "final_decomposition.tsv",
        "alt": "final_decomposition_alt.tsv"}
CASES = {  # name: --second-best
    "dxz1_second_best": True,
    "dxz1_light": False,
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """The port's plain route on a 20 kbp array: (its out dir, inputs)."""
    second_best = CASES[request.param]
    d = tmp_path_factory.mktemp(request.param)
    monomers = read_fasta(DXZ1)
    array = hor_array(20_000, monomers, (0.01, 0.05), np.random.default_rng(17))
    write_fasta(str(d / "m.fa"), monomers)
    write_fasta(str(d / "a.fa"), [("array_c0", array)])
    pipeline.run(str(d / "a.fa"), str(d / "m.fa"), out_dir=str(d / "out"),
                 second_best=second_best, device="cpu")
    cfg = dict(batch_size=5000, overlap=500, scoring="-1,-1,-1,1", second_best=second_best)
    return d, array, monomers, cfg


def _compare(d, array, regions, want):
    out = {}
    for reg, ref in zip(regions, want):
        for kind, fn in TSVS.items():
            got = decompose.rows_in(os.path.join(d, "out", fn), "array_c0", reg[2], reg[3])
            out[kind] = out.get(kind, 0) + decompose.rows_differ(got, ref[kind])
    return out


def test_reference_equals_the_port(case):
    d, array, monomers, cfg = case
    regions = [decompose.region_bounds(len(array), 0, 10, 5000, 500),  # the whole array
               decompose.region_bounds(len(array), 1, 2, 5000, 500)]  # windows 1-2 alone
    want = decompose.regions_rows([("array_c0", array, r) for r in regions], monomers, cfg, "cpu")
    assert len(want[0]["raw"]) > 100 and len(want[1]["raw"]) > 20
    assert (len(want[0]["alt"]) > 0) == cfg["second_best"]
    assert _compare(d, array, regions, want) == {"raw": 0, "final": 0, "alt": 0}


def test_a_corrupted_row_is_caught(case):
    d, array, monomers, cfg = case
    region = decompose.region_bounds(len(array), 1, 2, 5000, 500)
    want = decompose.regions_rows([("array_c0", array, region)], monomers, cfg, "cpu")
    path = os.path.join(d, "out", TSVS["final"])
    rows = open(path).read().split("\n")
    i = next(i for i, r in enumerate(rows) if int(r.split("\t")[2]) >= region[2])
    cols = rows[i].split("\t")
    cols[4] = f"{float(cols[4]) - 0.01:.2f}"  # an identity one hundredth lower
    bad = d / "bad"
    os.makedirs(bad / "out", exist_ok=True)
    for kind, fn in TSVS.items():
        text = "\n".join(rows[:i] + ["\t".join(cols)] + rows[i + 1 :]) if kind == "final" \
            else open(os.path.join(d, "out", fn)).read()
        (bad / "out" / fn).write_text(text)
    assert _compare(bad, array, [region], want) == {"raw": 0, "final": 1, "alt": 0}


def test_the_control_is_not_equal(case):
    d, array, monomers, cfg = case
    regions = [decompose.region_bounds(len(array), 0, 10, 5000, 500)]
    ctl = decompose.regions_rows([("array_c0", array, r) for r in regions], monomers, cfg, "cpu",
                                 ties="last", prefer="diag")
    got = _compare(d, array, regions, ctl)
    assert got["final"] > 0, got


def test_nw_counts_equal_the_spec():
    rng = np.random.default_rng(3)
    qs = [rng.integers(0, 4, int(n)).astype(np.int8) for n in rng.integers(0, 40, 60)]
    ts = [rng.integers(0, 4, int(n)).astype(np.int8) for n in rng.integers(1, 40, 60)]
    ts[:20] = [np.where(rng.random(len(q)) < 0.9, q, (q + 1) % 4).astype(np.int8) for q in qs[:20]]
    mt, ln = nw_counts(qs, ts, "cpu")
    for q, t, m, n in zip(qs, ts, mt, ln):
        _, sm, sn = nw_path_spec(q, t)
        assert (m, n) == (sm, sn)
