"""test_torch_large_sets.py's CLI test at the HOR-scale library
(`workloads.hor_library`, 264 monomers with RC, L = 192: K1's cluster body
on the card, and under --ed_thr 10 K3's thread route and the filter, then
the lanes body): the port's CLI (--device cpu) and the JAX package's, both
live, on the golden read's first 1,000 bp in windows of 500 bp, with
--second-best; the three TSVs equal byte for byte. A file of its own, so
that a worker of the suite takes each half."""

import numpy as np
import pytest

from stringdecomposer_tpu_torch.scripts import workloads

from .test_torch_large_sets import both_clis

CASES = {
    "library": (lambda dx: workloads.hor_library(dx, np.random.default_rng(0)), 1000, 400, 100,
                [], "cluster"),
    "library_ed_thr": (lambda dx: workloads.hor_library(dx, np.random.default_rng(0)), 1000, 400,
                       100, ["--ed_thr", "10"], "cluster"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_equals_the_jax_cli(tmp_path, name):
    both_clis(tmp_path, CASES[name])
