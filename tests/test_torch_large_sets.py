"""The port's CLI (--device cpu, the plain twins) against the JAX package's
CLI, both live, on the large and long monomer sets: the golden read's first
1-5 kbp, in windows of a few hundred to 2,500 bp (at least two windows a
read, so that the overlap merge runs), against the DXZ1 dimers (M = 24, L =
360), trimers (L = 528) and HOR unit (M = 2, L = 2,056), each with
--second-best; the three TSVs must be equal byte for byte. The HOR-scale
library (M = 264), with and without --ed_thr 10, runs the same test in
test_torch_large_sets_library.py. Both CLIs get --device-batch 1 (JAX pads
a batch to 24 windows otherwise); the card's batches are chip_smoke's
(phase jax_refs, against the references the JAX package wrote)."""

import filecmp

import pytest
import torch

from stringdecomposer_tpu.cli import main as jax_cli
from stringdecomposer_tpu_torch import cli
from stringdecomposer_tpu_torch.io.fasta import Record, load_fasta, write_fasta
from stringdecomposer_tpu_torch.ops import chain_dp_cuda as k1
from stringdecomposer_tpu_torch.ops.oracle import make_windows
from stringdecomposer_tpu_torch.scripts import workloads

from .test_torch_jax_refs import DATA, DX, TSVS

torch.set_num_threads(1)

# case: (set workload, read bp, -b, -v, extra flags, the K1 body on the card)
CASES = {
    "dimers": (lambda dx: workloads.joined_set(dx, 2), 1500, 600, 100, [], "lanes"),
    "trimers": (lambda dx: workloads.joined_set(dx, 3), 1500, 600, 100, [], "tiled"),
    "hor_unit": (workloads.hor_unit, 5000, 2500, 500, [], "tiled"),
}


def both_clis(tmp_path, case):
    """Writes the case's set and the cut golden read, runs both CLIs with
    the same flags and returns the port's output directory after checking
    the three TSVs byte for byte."""
    make, n, b, v, extra, body = case
    dx = load_fasta(str(DATA / DX))
    monos = make(dx)
    L = (max(len(m.seq) for m in monos) + 7) // 8 * 8
    assert k1.body(2 * len(monos), L, 4) == body
    read = load_fasta(str(DATA / "read.fa"))[0]
    assert len(make_windows(n, b, v)) >= 2
    read_fa, mono_fa = tmp_path / "read.fa", tmp_path / "monomers.fa"
    write_fasta(str(read_fa), [Record(read.name, read.seq[:n])])
    write_fasta(str(mono_fa), monos)
    args = [str(read_fa), str(mono_fa), "-b", str(b), "-v", str(v), "--second-best", *extra,
            "--device-batch", "1"]
    assert cli.main([*args, "-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jax_cli([*args, "-o", str(tmp_path / "jax")]) == 0
    for f in TSVS:
        assert filecmp.cmp(tmp_path / "t" / f, tmp_path / "jax" / f, shallow=False), f
    rows = (tmp_path / "t" / TSVS[0]).read_text().splitlines()
    assert rows and {r.split("\t")[1].rstrip("'") for r in rows} <= {m.name for m in monos}
    return tmp_path / "t"


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_equals_the_jax_cli(tmp_path, name):
    both_clis(tmp_path, CASES[name])
