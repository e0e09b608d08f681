"""The array generator: tandem copies of the DXZ1 HOR in the monomers'
order, each copy diverged by the configured share, the same for a seed."""

import numpy as np
import pytest
from harness import workloads
from harness.inputs import read_fasta
from harness.spec import BENCH_DIR

from stringdecomposer_tpu_torch.io.fasta import load_fasta
from stringdecomposer_tpu_torch.scripts import workloads as port

DXZ1 = str(BENCH_DIR / "data" / "DXZ1_star_monomers.fa")


def test_hor_unit_is_the_ports():
    records = load_fasta(DXZ1)
    assert workloads.hor_unit(read_fasta(DXZ1)) == port.hor_unit(records)[0].seq
    assert len(workloads.hor_unit(read_fasta(DXZ1))) == 2054


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_hor_array_is_diverged_copies_of_the_unit(seed):
    units = read_fasta(DXZ1)
    unit = workloads.hor_unit(units)
    arr = workloads.hor_array(40_000, units, (0.01, 0.02), np.random.default_rng(seed))
    assert len(arr) == 40_000 and set(arr) <= set("ACGT")
    assert arr == workloads.hor_array(40_000, units, (0.01, 0.02), np.random.default_rng(seed))
    # each copy is the unit with 21-41 edits: most of the unit's 12-mers survive in it
    kmers = {unit[i : i + 12] for i in range(len(unit) - 11)}
    for c in range(0, 40_000 - len(unit), len(unit)):
        part = arr[c : c + len(unit)]
        kept = sum(part[i : i + 12] in kmers for i in range(len(part) - 11))
        assert kept >= 0.6 * len(part), c
    exact = workloads.hor_array(len(unit) * 3, units, (0.0, 0.0), np.random.default_rng(seed))
    assert exact == unit * 3


def test_data_file_is_the_tools():
    tool = BENCH_DIR.parent / "stringdecomposer_tpu_torch" / "test_data" / "DXZ1_star_monomers.fa"
    assert read_fasta(DXZ1) == [(r.name, r.seq) for r in load_fasta(str(tool))]
